"""The program's training lines, as hpnn prints them at ``-v -v``:

    NN: EPOCH        1/ 1000000
    NN: TRAINING FILE:       s01234.txt\t init=   0.1234567890 OK N_ITER=      32 final=   0.0000001234 SUCCESS!

(the file name right-aligned in 16 columns, errors as ``%15.10f``), read
back into one record a sample, grouped by the ``EPOCH`` banners."""

from __future__ import annotations

import dataclasses
import re

_ROW = re.compile(r"^NN: TRAINING FILE: *(\S+)\t init= *(\S+) (OK|NO) "
                  r"N_ITER= *(-?\d+) final= *(\S+) (SUCCESS!|FAIL!)$")
_BANNER = re.compile(r"^NN: EPOCH +\d+/ *\d+$")


@dataclasses.dataclass
class Row:
    name: str
    init: float
    first_ok: bool
    n_iter: int
    final: float
    success: bool


def parse_row(line: str) -> Row | None:
    m = _ROW.match(line)
    if m is None:
        return None
    return Row(m.group(1), float(m.group(2)), m.group(3) == "OK",
               int(m.group(4)), float(m.group(5)), m.group(6) == "SUCCESS!")


def read(path: str) -> list[list[Row | None]]:
    """The rows under each banner (a file without banners is one epoch); a
    ``TRAINING FILE`` line that does not read as a row counts as None in
    its epoch."""
    epochs: list[list[Row | None]] = []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if _BANNER.match(line):
                epochs.append([])
            elif line.startswith("NN: TRAINING FILE:"):
                if not epochs:
                    epochs.append([])
                epochs[-1].append(parse_row(line))
    return epochs


def printed(value: float) -> float:
    """A value as the program's ``%15.10f`` prints it."""
    return float(f"{value:15.10f}")
