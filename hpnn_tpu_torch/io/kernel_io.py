"""Text kernel checkpoint format, byte-compatible with the reference.

Writer mirrors ``ann_dump`` (``src/ann.c:770-857``):

    [name] <name>
    [param] <n_in> <h1> ... <n_out>
    [input] <n_in>
    [hidden 1] <N>
    [neuron 1] <M>
    <w> <w> ... <w>          (M values at %17.15f, space separated)
    ...
    [output] <N>
    [neuron 1] <M>
    ...

Reader mirrors ``ann_load`` (``src/ann.c:206-631``) at the
control-flow level:

* the ``[param]`` line fixes the topology; weights are calloc'd ZERO and a
  ``[hidden i]``/``[output]`` section that never appears simply leaves its
  layer at zero (the reference loads such files successfully);
* each phase rewinds and re-scans the whole file, so section order is free;
* weight VALUES parse with raw strtod semantics from the one line after
  each ``[neuron j]`` header -- failed conversions read 0.0, short lines
  zero-fill, and the value loop shares samples.py's simulated getline
  buffer (stale bytes from earlier lines are reachable, like the C);
* a neuron may declare FEWER inputs than the layer width: the reference
  writes its values at the per-neuron stride (``_2D_IDX(n_par,jdx,kdx)``,
  ann.c:441), producing the same overlapped flat layout here;
* error messages and their ``->`` location lines are the reference's exact
  strings.  Paths where the reference runs into undefined behavior (a
  hidden index one past the array, an output neuron stride overflowing the
  layer allocation) fail silently instead (documented deviation).
"""

from __future__ import annotations

from typing import IO

import numpy as np

from ..models.kernel import Kernel
from ..utils.nn_log import nn_error
from .atomic import atomic_write_bytes
from .samples import _GetlineSim, _is_digit, _skip_blank, _strtod


def format_weight(v: float) -> str:
    """C's %17.15f."""
    return f"{v:17.15f}"


def dump_kernel(kernel: Kernel, fp: IO[str]) -> None:
    """Write the reference text format (ann_dump, ann.c:770-857)."""
    if kernel is None:
        nn_error("CAN'T SAVE KERNEL! kernel=NULL\n")
        return
    w = kernel.weights
    fp.write(f"[name] {kernel.name}\n")
    fp.write("[param] " + " ".join(str(p) for p in kernel.params) + "\n")
    fp.write(f"[input] {kernel.n_inputs}\n")
    for idx, mat in enumerate(w[:-1]):
        n, m = mat.shape
        fp.write(f"[hidden {idx + 1}] {n}\n")
        _dump_neurons(fp, mat)
    n, m = w[-1].shape
    fp.write(f"[output] {n}\n")
    _dump_neurons(fp, w[-1])


def _dump_neurons(fp: IO[str], mat: np.ndarray) -> None:
    n, m = mat.shape
    for j in range(n):
        fp.write(f"[neuron {j + 1}] {m}\n")
        row = mat[j]
        fp.write(" ".join(format_weight(float(v)) for v in row))
        fp.write("\n")


def dumps_kernel(kernel: Kernel) -> str:
    """The reference text format as one string (what a kernel file's
    bytes will be); the checkpoint fingerprint hashes exactly this."""
    import io

    buf = io.StringIO()
    dump_kernel(kernel, buf)
    return buf.getvalue()


def encode_kernel_text(text: str) -> bytes:
    """Kernel text -> file bytes.  latin-1 keeps byte parity with the
    reference's fprintf (a name loaded from a kernel file is latin-1-
    decoded raw bytes, so this is the identity on the round trip); a
    name with characters above U+00FF (reachable via a utf-8 conf)
    falls back to utf-8 instead of crashing -- those bytes re-decode
    latin-1 as mojibake but round-trip stably, like the C would treat
    any foreign byte sequence."""
    try:
        return text.encode("latin-1")
    except UnicodeEncodeError:
        return text.encode("utf-8")


def dump_kernel_to_path(kernel: Kernel, path: str) -> None:
    """Crash-safe kernel write (``io.atomic``): a crash mid-dump can never
    truncate an existing ``kernel.opt``."""
    atomic_write_bytes(path, encode_kernel_text(dumps_kernel(kernel)))


def _i32(v: int) -> int:
    """printf %i of a UINT: the reference renders counts through %i, so
    4294967294 prints as -2 in its error messages."""
    return v - 2**32 if v >= 2**31 else v


# Largest layer weight count allocated densely.  np.zeros calloc's, so
# like the reference's calloc + Linux overcommit the untouched pages cost
# nothing -- a dense allocation is correct (and cheap) far past any real
# workload.  Only counts at/after 2^31 (16 GiB of doubles, where the
# reference's own (UINT) index arithmetic is deep in overflow territory)
# fall back to _SparseFlat.  The old 2^20 bound silently refused real
# kernels, e.g. a 784x1338 hidden layer.
_DENSE_MAX = 1 << 31


class _SparseFlat:
    """Stand-in for a layer whose claimed size exceeds any real workload:
    the reference calloc's it anyway (Linux overcommit succeeds untouched)
    and only ever errors out of such files through the normal scan checks,
    so the scan must RUN, not bail early.  Writes are kept sparse; a load
    that would actually COMPLETE with one of these (needs billions of
    [neuron] blocks in the file -- unreachable) fails at the end."""

    def __init__(self, size: int):
        self.size = size
        self.shape = (size,)
        self.vals: dict[int, float] = {}

    def __setitem__(self, i: int, v: float) -> None:
        self.vals[i] = v


def _uint(s: str, pos: int) -> tuple[int, int]:
    """GET_UINT (common.h:269-271): ``(UINT)strtoull(...)`` -- leading C
    whitespace skipped, an optional sign (a negative value NEGATES,
    wrapping mod 2^64), 64-bit saturation on overflow, then the macro's
    (UINT) cast truncates to 32 bits.  No digits -> (0, pos)."""
    p = pos
    while p < len(s) and s[p] in " \t\n\r\v\f":
        p += 1
    neg = False
    if p < len(s) and s[p] in "+-":
        neg = s[p] == "-"
        p += 1
    j = p
    while j < len(s) and _is_digit(s[j]):
        j += 1
    if j == p:
        return 0, pos
    v = min(int(s[p:j]), 2**64 - 1)
    if neg:
        v = (2**64 - v) % 2**64
    return v & 0xFFFFFFFF, j


def _scan_to_digit(line: str, pos: int) -> int:
    """``while(!ISDIGIT(*ptr) && *ptr!='\\n' && *ptr!='\\0') ptr++`` --
    returns the position of the first digit, or of the stopper."""
    while (pos < len(line) and line[pos] not in "\n\0"
           and not _is_digit(line[pos])):
        pos += 1
    return pos


def _at_digit(line: str, pos: int) -> bool:
    return pos < len(line) and _is_digit(line[pos])


def _read_weight_row(sim: _GetlineSim, flat: np.ndarray, stride: int,
                     j: int, n_par: int) -> bool:
    """The reference's weight loop (ann.c:437-445): n_par GET_DOUBLEs from
    the just-read line's buffer, written at the PER-NEURON stride
    ``n_par*j + k`` into the layer's flat calloc'd array.  False when an
    index would leave the allocation (reference UB; silent fail)."""
    pos = _skip_blank(sim.buf, 0)
    for k in range(n_par):
        if pos < len(sim.buf):
            v, end = _strtod(sim.buf, pos)
            pos = _skip_blank(sim.buf, min(end + 1, len(sim.buf)))
        else:
            v = 0.0  # past every written byte: malloc garbage in C
        i = stride * j + k
        if i >= flat.shape[0]:
            return False
        flat[i] = v
    return True


def _load_neuron_block(sim: _GetlineSim, flat: np.ndarray, j: int,
                       n_inputs: int, where: str,
                       check_inputs: bool) -> bool | None:
    """One ``[neuron j]`` header + weights line (ann.c:400-450 hidden /
    494-534 output).  ``where`` renders the reference's location line;
    ``check_inputs`` is True only on the hidden path (the output path has
    no n_par>n_inputs guard -- overflow there is reference UB, silent
    fail).  Returns True, or None on a (printed) error, False on UB."""
    line = sim.cline()
    kpos = line.find("[neuron")
    if kpos < 0:
        nn_error("kernel read: neuron definition missing!\n")
        nn_error(f"-> {where}, neuron {j + 1}\n")
        return None
    q = _scan_to_digit(line, kpos)
    if not _at_digit(line, q):
        nn_error("kernel read: missing neuron number!\n")
        nn_error(f"-> {where}, neuron {j + 1}\n")
        return None
    num, end = _uint(line, q)
    if num < 1:
        nn_error("kernel read: neuron number<1\n")
        nn_error(f"-> {where}, neuron {j + 1}\n")
        return None
    q = _skip_blank(line, min(end + 1, len(line)))
    if not _at_digit(line, q):
        nn_error("kernel read: neuron has no input number!\n")
        nn_error(f"-> {where}, neuron {j + 1}\n")
        return None
    n_par, _ = _uint(line, q)
    if n_par < 1:
        nn_error("kernel read: neuron has less that 1 input!\n")
        nn_error(f"-> {where}, neuron {j + 1}\n")
        return None
    if check_inputs and n_par > n_inputs:
        nn_error("kernel read: neuron inconsistent input number!\n")
        nn_error(f"-> n_input={_i32(n_par)} (expected {_i32(n_inputs)})!\n")
        nn_error(f"-> {where}, neuron {j + 1}\n")
        return None
    sim.readline()  # weights line
    if not _read_weight_row(sim, flat, n_par, j, n_par):
        return False
    sim.readline()
    return True


def load_kernel(path: str) -> Kernel | None:
    """Parse the text kernel format (ann_load, ann.c:206-631).

    Returns None on malformed input, with the reference's NN(ERR)
    messages; see the module docstring for the control-flow contract.
    """
    try:
        fp = open(path, "r", encoding="latin-1")
    except OSError:
        nn_error(f"Error opening kernel file: {path}\n")
        return None
    with fp:
        raw = fp.readlines()
    sim = _GetlineSim(raw)
    sim.readline()  # line 1: name
    if "[name]" not in sim.cline():
        nn_error("kernel file should start with [name] keyword!\n")
        return None
    after = sim.cline().split("[name]", 1)[1]
    name = after[_skip_blank(after, 0):].split("\n", 1)[0]

    # --- [param] phase (ann.c:276-334): scan from the name line on -----
    n_in = n_out = n_hid = 0
    hid_out: list[int] = []
    while True:
        line = sim.cline()
        if "[param]" in line:
            q = _scan_to_digit(line, 0)
            if not _at_digit(line, q):
                nn_error("kernel read: malformed parameter line!\n")
                return None
            # counting pass (GET_UINT until newline/NUL)
            n_par = 0
            pos = q
            while True:
                _, end = _uint(line, pos)
                if end < len(line) and line[end] in "\n\0":
                    pos = end
                else:
                    pos = min(end + 1, len(line))
                pos = _skip_blank(line, pos)
                n_par += 1
                if pos >= len(line) or line[pos] in "\n\0":
                    break
            n_par -= 1
            if n_par < 2:
                nn_error("kernel read: parameter line has too few "
                         "parameters!\n")
                return None
            n_hid = n_par - 1
            # value pass: n_in then the n_par layer sizes
            pos = _scan_to_digit(line, 0)
            n_in, end = _uint(line, pos)
            pos = _skip_blank(line, min(end + 1, len(line)))
            hid_out = []
            for _ in range(n_par):
                v, end = _uint(line, pos)
                hid_out.append(v)
                pos = _skip_blank(line, min(end + 1, len(line)))
            if any(v == 0 for v in hid_out):
                nn_error("kernel read: zero in parameter line!\n")
                return None
            n_out = hid_out[-1]
            break
        sim.readline()
        if sim.feof:
            break
    if n_in == 0:
        # also the no-[param]-line case (the reference checks n_in, so a
        # zero FIRST parameter reports "missing" too -- quirk preserved)
        nn_error("kernel read: missing parameter line!\n")
        return None
    if n_out < 1:
        nn_error("kernel read: wrong parameter n_output<1!\n")
        return None
    if n_hid < 1:
        nn_error("kernel read: wrong parameter n_hiddens<1!\n")
        return None

    dims = [n_in] + hid_out  # n_layers = n_hid hidden + 1 output
    flats = [np.zeros(dims[i + 1] * dims[i], np.float64)
             if dims[i + 1] * dims[i] < _DENSE_MAX
             else _SparseFlat(dims[i + 1] * dims[i])  # overcommit analog
             for i in range(len(dims) - 1)]

    # --- [hidden i] phase (ann.c:343-459): rewind, re-scan everything --
    sim.rewind()
    while True:
        line = sim.cline()
        kpos = line.find("[hidden")
        if kpos >= 0:
            q = _scan_to_digit(line, kpos)
            if not _at_digit(line, q):
                nn_error("kernel read: malformed hidden layer definition\n")
                return None
            idx, end = _uint(line, q)
            if idx == 0:
                nn_error("kernel read: wrong hidden layer index (=0)!\n")
                return None
            idx -= 1
            if idx > n_hid:
                nn_error("kernel read: wrong hidden layer index "
                         "(> n_hiddens)!\n")
                return None
            if idx >= n_hid:
                return None  # reference indexes hiddens[n_hid]: UB
            q = _scan_to_digit(line, min(end + 1, len(line)))
            jdx, _ = _uint(line, q)
            if jdx != dims[idx + 1]:
                nn_error("kernel read: inconsistent neuron number!\n")
                nn_error(f"-> layer {idx + 1} n_neurons={_i32(jdx)} "
                         f"(expected {_i32(dims[idx + 1])})\n")
                return None
            sim.readline()
            for j in range(dims[idx + 1]):
                r = _load_neuron_block(sim, flats[idx], j, dims[idx],
                                       f"hidden layer {idx + 1}",
                                       check_inputs=True)
                if r is not True:
                    return None
        else:
            sim.readline()
        if sim.feof:
            break

    # --- [output] phase (ann.c:458-546): rewind, re-scan ---------------
    sim.rewind()
    while True:
        line = sim.cline()
        kpos = line.find("[output]")
        if kpos >= 0:
            q = _scan_to_digit(line, kpos)
            if not _at_digit(line, q):
                nn_error("kernel read: malformed output layer definition\n")
                return None
            idx, _ = _uint(line, q)
            if idx != dims[-1]:
                nn_error("kernel read: inconsistent neuron number for "
                         "output!\n")
                nn_error(f"-> n_neurons={_i32(idx)} "
                     f"(expected {_i32(dims[-1])})\n")
                return None
            sim.readline()
            for j in range(dims[-1]):
                r = _load_neuron_block(sim, flats[-1], j, dims[-2],
                                       "output layer", check_inputs=False)
                if r is not True:
                    return None
        sim.readline()
        if sim.feof:
            break

    for i, f in enumerate(flats):
        if isinstance(f, _SparseFlat):
            # completing a load at this size would need a >=16 GiB dense
            # array (and a correspondingly impossible file); the reference
            # would be deep in overcommitted memory here -- fail with a
            # diagnostic naming the layer (documented deviation; the old
            # bare `return None` looked like an unreadable file)
            nn_error(f"kernel read: layer {i + 1} weight count "
                     f"{f.size} too large to allocate!\n")
            return None
    weights = [flats[i].reshape(dims[i + 1], dims[i])
               for i in range(len(dims) - 1)]
    return Kernel(name=name, weights=weights)
