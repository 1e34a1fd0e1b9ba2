"""Trainer labels: the name serving and ``/metrics`` give a kernel's
``[train]`` algorithm (the counterpart of ``hpnn_tpu/train/__init__.py``'s
``trainer_label``, for the trainers the port has: per-sample BP and BPM;
the CG trainer is not ported, so a ``[train] cg`` conf reads "none")."""

from __future__ import annotations

from ..io.conf import NN_TRAIN_BP, NN_TRAIN_BPM

# registry name -> the [train] conf value it serves
TRAINERS = {"bp": NN_TRAIN_BP, "bpm": NN_TRAIN_BPM}


def trainer_label(conf) -> str:
    """The registry name for the conf's [train] value ("none" when no
    ported trainer serves it)."""
    for name, train in TRAINERS.items():
        if train == conf.train:
            return name
    return "none"


__all__ = ["TRAINERS", "trainer_label"]
