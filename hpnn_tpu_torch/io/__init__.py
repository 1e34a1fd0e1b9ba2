from .conf import NNConf, dump_conf, load_conf, parse_conf
from .corpus import load_ordered
from .kernel_io import (dump_kernel, dump_kernel_to_path, dumps_kernel,
                        load_kernel)
from .samples import list_sample_dir, read_sample

__all__ = [
    "NNConf",
    "parse_conf",
    "load_conf",
    "dump_conf",
    "load_kernel",
    "dump_kernel",
    "dumps_kernel",
    "dump_kernel_to_path",
    "read_sample",
    "list_sample_dir",
    "load_ordered",
]
