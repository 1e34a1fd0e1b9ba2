"""Multi-epoch training (``train_nn --epochs N``).  Checkpoints, resume and
the bundle format are not ported yet: only the loop with checkpointing
off."""

from .trainer import train_loop

__all__ = ["train_loop"]
