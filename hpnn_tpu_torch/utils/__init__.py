from . import glibc_random, nn_log
from .glibc_random import RAND_MAX, GlibcRandom, shuffled_indices

__all__ = [
    "GlibcRandom",
    "RAND_MAX",
    "shuffled_indices",
    "glibc_random",
    "nn_log",
]
