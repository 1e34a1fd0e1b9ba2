"""Trainer registry: the dispatch surface for training algorithms.

The port of the JAX package's ``train/__init__.py``.  The reference
hard-codes its dispatch in ``nn_kernel_train`` (``src/libhpnn.c:1193-1291``):
BP and BPM run, CG and SPLX fall through an "unimplemented" warning
(``libhpnn.c:1253-1257``).  The reference trainers stay on
``api.train_kernel``'s built-in routes (their entries exist so tooling
enumerates every trainer through one surface); an opt-in entry drives the
whole epoch through ``run_epoch(nn, weights, xs, ts, kind, dtype)``,
starting with the batched CG trainer (``train.cg``).

Activation is two-level, like the native-LNN gate: the conf opts in
(``[trainer] cg`` / ``--trainer cg``) or the environment does
(``HPNN_TRAINER=cg``, ``native`` meaning ``cg``).  Without either, a
``[train] CG`` conf keeps the reference's untrainable fallthrough bytes.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable

from ..api import native_lnn
from ..io.conf import NN_TRAIN_BP, NN_TRAIN_BPM, NN_TRAIN_CG


@dataclasses.dataclass(frozen=True)
class TrainerEntry:
    name: str
    train: str            # the [train] conf value this trainer serves
    native: bool          # True: run_epoch drives the epoch
    description: str
    run_epoch: Callable | None = None


_TRAINERS: dict[str, TrainerEntry] = {}


def register_trainer(entry: TrainerEntry) -> None:
    _TRAINERS[entry.name] = entry


def get_trainer(name: str) -> TrainerEntry:
    return _TRAINERS[name]


def trainer_names() -> list[str]:
    return sorted(_TRAINERS)


def trainer_label(conf) -> str:
    """The trainer label serving and ``/metrics`` give a kernel: the
    registry name for the conf's [train] value ("none" when untrainable)."""
    for entry in _TRAINERS.values():
        if entry.train == conf.train:
            return entry.name
    return "none"


def native_trainer(conf) -> TrainerEntry | None:
    """The native trainer entry driving this conf's epochs, or None when
    the reference dispatch applies.  Needs BOTH a native registry entry
    for the conf's [train] algorithm AND the opt-in (conf.trainer /
    HPNN_TRAINER)."""
    want = getattr(conf, "trainer", "") or os.environ.get("HPNN_TRAINER", "")
    if not want or want == "0":
        return None
    entry = _TRAINERS.get(want if want != "native" else "cg")
    if entry is None or not entry.native:
        return None
    return entry if entry.train == conf.train else None


def _register_builtins() -> None:
    from .cg import run_cg_epoch

    register_trainer(TrainerEntry(
        name="bp", train=NN_TRAIN_BP, native=False,
        description="online per-sample backprop to convergence "
                    "(reference dispatch, ann.c:2281-2372)"))
    register_trainer(TrainerEntry(
        name="bpm", train=NN_TRAIN_BPM, native=False,
        description="per-sample backprop with momentum "
                    "(reference dispatch, ann.c:2377-2466)"))
    register_trainer(TrainerEntry(
        name="cg", train=NN_TRAIN_CG, native=True,
        description="batched nonlinear conjugate gradient "
                    "(Polak-Ribiere + restart, on-device line search)",
        run_epoch=run_cg_epoch))


_register_builtins()

__all__ = [
    "TrainerEntry", "register_trainer", "get_trainer", "trainer_names",
    "trainer_label", "native_lnn", "native_trainer",
]
