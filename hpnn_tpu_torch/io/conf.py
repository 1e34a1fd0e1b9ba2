"""``.conf`` run configuration parser/dumper.

Mirrors ``_NN(load,conf)`` / ``_NN(dump,conf)``
(``src/libhpnn.c:658-937``).  Keyword lines are recognised by
substring search anywhere in the line (STRFIND), values are cleaned by
truncating at the first space/tab/newline/'#' (STR_CLEAN, common.h:254-262).

Recognised keywords and semantics (all cited to the reference parser):

    [name]   <string>                   libhpnn.c:684-691
    [type]   first char L->LNN S->SNN else ANN      libhpnn.c:692-709
    [init]   line containing "generate"/"GENERATE" -> generate,
             else value = kernel filename           libhpnn.c:710-729
    [seed]   unsigned int                           libhpnn.c:730-739
    [input]  unsigned int                           libhpnn.c:740-751
    [hidden] one or more unsigned ints              libhpnn.c:752-775
    [output] unsigned int                           libhpnn.c:776-786
    [train]  B..->BP (BxM->BPM), C->CG, S->SPLX     libhpnn.c:787-805
    [sample_dir] <dir>                              libhpnn.c:806-812
    [test_dir]   <dir>                              libhpnn.c:813-819
"""

from __future__ import annotations

import dataclasses
from typing import IO

from ..utils.nn_log import nn_error, nn_out

NN_TYPE_ANN = "ANN"
NN_TYPE_SNN = "SNN"
NN_TYPE_LNN = "LNN"
NN_TYPE_UKN = "UKN"

NN_TRAIN_BP = "BP"
NN_TRAIN_BPM = "BPM"
NN_TRAIN_CG = "CG"
NN_TRAIN_SPLX = "SPLX"
NN_TRAIN_UKN = "none"


@dataclasses.dataclass
class NNConf:
    name: str | None = None
    type: str = NN_TYPE_UKN
    need_init: bool = False
    seed: int = 0
    f_kernel: str | None = None
    train: str = NN_TRAIN_UKN
    samples: str | None = None
    tests: str | None = None
    # topology, used when need_init (generate) -- [input]/[hidden]/[output]
    n_inputs: int = 0
    hiddens: list[int] = dataclasses.field(default_factory=list)
    n_outputs: int = 0
    # extensions beyond the reference (absent keywords leave defaults):
    batch: int = 0        # [batch] N  -> batched data-parallel training (new)
    dtype: str = "f64"    # [dtype] f64|f32|bf16 -> compute precision (new)
    model: int = 0        # [model] N -> N-way tensor (row) sharding -- the
    #                       reference's MPI/stream strategy (ann.c:913-936),
    #                       reachable from the conf; 0 = -S knob / off
    tile: int = 0         # [tile] N|auto -> batched-tile convergence engine
    #                       (ops.convergence_tile): groups of N samples per
    #                       GEMM-shaped step; -1 = autotuned; 0 = off.  On
    #                       the [batch] route the batch is the group and
    #                       the value sets launch granularity.
    lnn: str = ""         # [lnn] native -> native linear-output LNN kernel
    #                       (linear head); "" keeps the reference's
    #                       warn-and-SNN-fallthrough byte-for-byte
    trainer: str = ""     # [trainer] cg|bp|bpm -> native trainer registry
    #                       selection; cg also coerces
    #                       [train] to CG.  "" = reference dispatch.


def _clean(value: str) -> str:
    """STR_CLEAN: truncate at first space/tab/newline/'#' (common.h:254-262)."""
    out = []
    for ch in value:
        if ch in (" ", "\t", "\n", "#"):
            break
        out.append(ch)
    return "".join(out)


def _after(line: str, key: str) -> str:
    """Text following the keyword, leading blanks skipped (SKIP_BLANK)."""
    rest = line.split(key, 1)[1]
    if rest[:1] == "]":
        rest = rest[1:]
    return rest.lstrip(" \t")


def _get_uint(text: str) -> int | None:
    digits = []
    for ch in text:
        if ch.isdigit():
            digits.append(ch)
        else:
            break
    return int("".join(digits)) if digits else None


def parse_conf(fp: IO[str]) -> NNConf | None:
    conf = NNConf()
    for raw in fp:
        line = raw
        if "[name" in line:
            conf.name = _clean(_after(line, "[name"))
        if "[type" in line:
            first = _after(line, "[type")[:1]
            if first == "L":
                conf.type = NN_TYPE_LNN
            elif first == "S":
                conf.type = NN_TYPE_SNN
            else:
                conf.type = NN_TYPE_ANN
        if "[init" in line:
            if "generate" in line or "GENERATE" in line:
                nn_out("generating kernel!\n")
                conf.need_init = True
            else:
                nn_out("loading kernel!\n")
                conf.need_init = False
                conf.f_kernel = _clean(_after(line, "[init"))
                if not conf.f_kernel:
                    nn_error("Malformed NN configuration file!\n")
                    nn_error("[init] can't read filename\n")
                    return None
        if "[seed" in line:
            v = _get_uint(_after(line, "[seed"))
            if v is None:
                nn_error("Malformed NN configuration file!\n")
                nn_error(f"[seed] value: {_after(line, '[seed')}")
                return None
            conf.seed = v
        if "[input" in line:
            v = _get_uint(_after(line, "[input"))
            if v is None:
                nn_error("Malformed NN configuration file!\n")
                nn_error(f"[input] value: {_after(line, '[input')}")
                return None
            conf.n_inputs = v
        if "[hidden" in line:
            rest = _after(line, "[hidden")
            vals: list[int] = []
            for tok in rest.split():
                if tok.isdigit():
                    vals.append(int(tok))
                else:
                    break
            if not vals:
                nn_error("Malformed NN configuration file!\n")
                nn_error(f"[hidden] value: {rest}")
                return None
            conf.hiddens = vals
        if "[output" in line:
            v = _get_uint(_after(line, "[output"))
            if v is None:
                nn_error("Malformed NN configuration file!\n")
                nn_error(f"[output] value: {_after(line, '[output')}")
                return None
            conf.n_outputs = v
        if "[train" in line and "[trainer" not in line:
            value = _after(line, "[train")
            first = value[:1]
            if first == "B":
                conf.train = NN_TRAIN_BPM if value[2:3] == "M" else NN_TRAIN_BP
            elif first == "C":
                conf.train = NN_TRAIN_CG
            elif first == "S":
                conf.train = NN_TRAIN_SPLX
            else:
                conf.train = NN_TRAIN_UKN
        if "[sample_dir" in line:
            conf.samples = _clean(_after(line, "[sample_dir"))
        if "[test_dir" in line:
            conf.tests = _clean(_after(line, "[test_dir"))
        # --- extensions (not present in the reference format) ---
        if "[batch" in line:
            v = _get_uint(_after(line, "[batch"))
            if v is None:
                nn_error("Malformed NN configuration file!\n")
                nn_error(f"[batch] value: {_after(line, '[batch').strip()}\n")
                return None
            conf.batch = v
        if "[dtype" in line:
            conf.dtype = _clean(_after(line, "[dtype")) or "f64"
        if "[model" in line:
            v = _get_uint(_after(line, "[model"))
            if v is None:
                nn_error("Malformed NN configuration file!\n")
                nn_error(f"[model] value: {_after(line, '[model').strip()}\n")
                return None
            conf.model = v
        if "[trainer" in line:
            value = _clean(_after(line, "[trainer")).lower()
            if value not in ("cg", "bp", "bpm"):
                nn_error("Malformed NN configuration file!\n")
                nn_error(f"[trainer] value: {value}\n")
                return None
            conf.trainer = value
            if value == "cg":
                conf.train = NN_TRAIN_CG
            elif value == "bpm":
                conf.train = NN_TRAIN_BPM
            elif value == "bp":
                conf.train = NN_TRAIN_BP
        if "[lnn" in line:
            value = _clean(_after(line, "[lnn")).lower()
            if value != "native":
                nn_error("Malformed NN configuration file!\n")
                nn_error(f"[lnn] value: {value}\n")
                return None
            conf.lnn = value
        if "[tile" in line:
            rest = _after(line, "[tile")
            if _clean(rest).lower() == "auto":
                conf.tile = -1  # autotuned (ops.autotune.decide_tile)
            else:
                v = _get_uint(rest)
                if v is None:
                    nn_error("Malformed NN configuration file!\n")
                    nn_error("[tile] value: "
                             f"{rest.strip()}\n")
                    return None
                conf.tile = v
    if conf.type == NN_TYPE_UKN:
        nn_error("Malformed NN configuration file!\n")
        nn_error("[type] unknown or missing...\n")
        return None
    if conf.need_init:
        for field, label in ((conf.n_inputs, "[input]"), (conf.hiddens, "[hidden]"), (conf.n_outputs, "[output]")):
            if not field:
                nn_error("Malformed NN configuration file!\n")
                nn_error(f"{label} wrong or missing...\n")
                return None
        if any(h == 0 for h in conf.hiddens):
            nn_error("Malformed NN configuration file!\n")
            nn_error("[hidden] some have a 0 neuron content!\n")
    return conf


def load_conf(path: str) -> NNConf | None:
    try:
        fp = open(path, "r")
    except OSError:
        nn_error(f"Error opening configuration file: {path}\n")
        return None
    with fp:
        return parse_conf(fp)


def dump_conf(conf: NNConf, fp: IO[str], kernel=None) -> None:
    """Mirror _NN(dump,conf) (libhpnn.c:885-937)."""
    fp.write("# NN configuration\n")
    fp.write(f"[name] {conf.name}\n")
    fp.write(f"[type] {conf.type if conf.type != NN_TYPE_UKN else NN_TYPE_ANN}\n")
    if conf.need_init:
        fp.write("[init] generate\n")
    elif conf.f_kernel is not None:
        fp.write(f"[init] {conf.f_kernel}\n")
    else:
        fp.write("[init] INVALID <- this should trigger an error\n")
    fp.write(f"[seed] {conf.seed}\n")
    n_inputs = kernel.n_inputs if kernel is not None else conf.n_inputs
    hiddens = kernel.hiddens if kernel is not None else conf.hiddens
    n_outputs = kernel.n_outputs if kernel is not None else conf.n_outputs
    fp.write(f"[inputs] {n_inputs}\n")
    fp.write("[hiddens] " + "".join(f"{h} " for h in hiddens) + "\n")
    fp.write(f"[outputs] {n_outputs}\n")
    fp.write(f"[train] {conf.train}\n")
    if conf.samples is not None:
        fp.write(f"[sample_dir] {conf.samples}\n")
    else:
        fp.write("[sample_dir] INVALID <- this should trigger an error\n")
    if conf.tests is not None:
        fp.write(f"[test_dir] {conf.tests}\n")
    else:
        fp.write("[test_dir] INVALID <- this should trigger an error\n")
