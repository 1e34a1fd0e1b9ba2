"""pdif: RRUFF DIF + XY raw files -> XRD classification samples.

Rebuild of the reference's ``tutorials/ann/{prepare_dif.c,file_dif.c}``:
walks ``<rruff_dir>/dif/``, pairs each DIF file with the same-named file in
``<rruff_dir>/raw/``, and writes one sample per mineral into the sample
directory:

    [input] <n_in>                      (n_in = -i value + 1: temperature
    T/273.15 b1 ... b850  (%7.5f)        slot + XRD bins, prepare_dif.c:118)
    [output] 230
    one-hot 1.0/-1.0 at space_group-1   (all -1.0 when the group is unknown)

Bins integrate the raw XY intensities over [5, 90) degrees 2-theta in
``(90-5)/n_bins`` steps and are normalized to max 1.0
(``file_dif.c:425-465``; MIN/MAX_THETA ``file_dif.h:26-27``).

DIF parsing mirrors ``read_dif`` (``file_dif.c:37-330``): structure name on
line 1 (files R060187 / "5.000" rejected), sample temperature ``T = x K``
(Celsius assumed otherwise), CELL PARAMETERS (6 floats, mandatory), SPACE
GROUP by exact Hermann-Mauguin symbol lookup (sg_table), WAVELENGTH, and
the 2-THETA peak table (file invalid without peaks).  Files measured at the
Mo wavelength 0.710730 are skipped (``prepare_dif.c:226``).  Atom tables
are consumed but not used by the sample writer, as in the reference.
"""

from __future__ import annotations

import os
import re
import sys

from .sg_table import SPACE_GROUPS

MIN_THETA = 5.0   # file_dif.h:26
MAX_THETA = 90.0  # file_dif.h:27

_NUM = re.compile(r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?")


class Dif:
    def __init__(self):
        self.name = "???"
        self.temp = 273.15 + 25.0  # room temperature (file_dif.c:87)
        self.space = 0             # 0 -> unknown (file_dif.c:88)
        self.lam = 1.541838        # file_dif.c:91
        self.n_peaks = 0
        self.raw_t: list[float] = []
        self.raw_i: list[float] = []


def _floats(text: str, n: int | None = None):
    vals = [float(m.group(0)) for m in _NUM.finditer(text)]
    if n is not None and len(vals) < n:
        return None
    return vals[:n] if n is not None else vals


def read_dif(path: str) -> Dif | None:
    """Parse a RRUFF DIF file (read_dif, file_dif.c:37-330)."""
    try:
        fp = open(path, "r", errors="replace")
    except OSError:
        sys.stderr.write(f"Error opening file: {path}\n")
        return None
    with fp:
        lines = fp.read().splitlines()
    if not lines:
        return None
    first = lines[0]
    # 4 structures lack full set information (file_dif.c:62-65)
    if "R060187" in first or "5.000" in first:
        return None
    dif = Dif()
    name = first.strip().split()
    dif.name = name[0] if name else "???"
    i = 1
    n = len(lines)
    while i < n:
        line = lines[i]
        if "Sample" in line and "T =" in line:
            after = line.split("T =", 1)[1]
            m = _NUM.search(after)
            if m:
                dif.temp = float(m.group(0))
                # unit is the char one past the number (file_dif.c:103-113):
                # 'K' keeps kelvin, anything else means Celsius
                tail = after[m.end():]
                if not (len(tail) >= 2 and tail[1] == "K"):
                    dif.temp += 273.15
        if "CELL PARAMETERS:" in line:
            vals = _floats(line.split("CELL PARAMETERS:", 1)[1], 6)
            if vals is None:
                return None  # mandatory (file_dif.c:121-132)
        if "SPACE GROUP" in line:
            # ptr+=11; skip optional '#'; +2 -> symbol start
            # (file_dif.c:135-140, incl. the R060879 "SPACE GROUP #:" case)
            rest = line.split("SPACE GROUP", 1)[1]
            if rest.startswith("#"):
                rest = rest[1:]
            sym = rest[2:].split()[0] if rest[2:].split() else ""
            if sym in SPACE_GROUPS:
                dif.space = SPACE_GROUPS[sym]
            else:
                sys.stdout.write(f"#DBG: NO_space group = {sym}\n")
        if "ATOM" in line:
            # consume atom lines: non-digit graph start (file_dif.c:166-171)
            i += 1
            while i < n:
                s = lines[i].lstrip()
                if not s or s[0].isdigit():
                    break
                i += 1
            continue  # current line re-examined for WAVELENGTH/2-THETA
        if "WAVELENGTH" in line:
            m = _NUM.search(line.split("WAVELENGTH", 1)[1])
            if m:
                dif.lam = float(m.group(0))
        if "2-THETA" in line and dif.n_peaks == 0:
            i += 1
            while i < n:
                s = lines[i].lstrip()
                if not s or not s[0].isdigit():
                    break
                vals = _floats(s, 2)
                if vals is None:
                    break
                dif.n_peaks += 1
                i += 1
            continue
        i += 1
    if dif.n_peaks == 0:
        return None  # mandatory (file_dif.c:325)
    return dif


def read_raw(path: str, dif: Dif) -> bool:
    """Parse the XY raw spectrum (read_raw, file_dif.c:332-379)."""
    try:
        fp = open(path, "r", errors="replace")
    except OSError:
        sys.stderr.write(f"Error opening file: {path}\n")
        return False
    with fp:
        lines = fp.read().splitlines()
    started = False
    for line in lines:
        if not started:
            if line[:1].isdigit():
                started = True
            else:
                continue
        vals = _floats(line, 2)
        if vals is None:
            continue  # permissive on bad lines (file_dif.c:373-375)
        dif.raw_t.append(vals[0])
        dif.raw_i.append(vals[1])
    return started and bool(dif.raw_t)


def dif_2_sample(dif: Dif, fp, n_inputs: int, n_outputs: int) -> bool:
    """Write one sample (dif_2_sample, file_dif.c:425-480)."""
    if dif is None or n_inputs == 0 or n_outputs == 0:
        return False
    n_bins = n_inputs - 1
    interval = (MAX_THETA - MIN_THETA) / n_bins
    bins = [0.0] * n_bins
    # the reference writes the [input] header BEFORE integrating, so an
    # all-zero spectrum leaves a partial file behind (file_dif.c:437-459);
    # behavior kept
    fp.write(f"[input] {n_inputs}\n")
    j = 0
    npts = len(dif.raw_t)
    while j < npts and dif.raw_t[j] < MIN_THETA:
        j += 1
    hi = MIN_THETA + interval
    max_i = 0.0
    for b in range(n_bins):
        acc = 0.0
        while j < npts and dif.raw_t[j] < hi:
            acc += dif.raw_i[j]
            j += 1
        hi += interval
        bins[b] = acc
        if acc > max_i:
            max_i = acc
    if max_i == 0.0:
        return False
    fp.write(f"{dif.temp / 273.15:7.5f}")
    for b in bins:
        fp.write(f" {b / max_i:7.5f}")
    fp.write("\n")
    fp.write(f"[output] {n_outputs}\n")
    # one-hot at space-1; space 0 (unknown) leaves every slot at -1
    # (file_dif.c:468-476)
    fp.write("1.0" if dif.space == 1 else "-1.0")
    for idx in range(1, n_outputs):
        fp.write(" 1.0" if idx == dif.space - 1 else " -1.0")
    fp.write("\n")
    return True


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    n_inputs = n_outputs = 0
    rruff_dir = None
    sample_dir = None
    i = 0
    while i < len(argv):
        a = argv[i]
        if a.startswith("-") and len(a) > 1:
            c = a[1]
            if c == "h":
                sys.stdout.write(
                    "usage: pdif rruff_directory -i n_in -o n_out "
                    "[-s sample_dir]\n")
                return 0
            if c in ("i", "o", "s"):
                value = a[2:] if len(a) > 2 else (
                    argv[i + 1] if i + 1 < len(argv) else "")
                if len(a) <= 2:
                    i += 1
                if c == "s":
                    sample_dir = value
                else:
                    digits = re.match(r"\d+", value.strip())
                    if not digits or int(digits.group(0)) == 0:
                        sys.stderr.write(
                            f"syntax error: bad -{c} parameter!\n")
                        return 1
                    if c == "i":
                        n_inputs = int(digits.group(0)) + 1  # + temperature
                    else:
                        n_outputs = int(digits.group(0))
            else:
                sys.stderr.write("syntax error: unrecognized option!\n")
                return 1
        else:
            if rruff_dir is not None:
                sys.stderr.write("syntax error: too many parameters!\n")
                return 1
            rruff_dir = a
        i += 1
    if rruff_dir is None or n_inputs == 0 or n_outputs == 0:
        sys.stderr.write("syntax error: missing parameters!\n")
        return 1
    if sample_dir is None:
        sample_dir = "./samples"
    sys.stdout.write(f">> received: {rruff_dir} -i {n_inputs} "
                     f"-o {n_outputs} -s {sample_dir}\n")
    if not os.path.isdir(sample_dir):
        sys.stderr.write(f"ERROR: can't open directory: {sample_dir}\n")
        return 1
    dif_dir = os.path.join(rruff_dir, "dif")
    try:
        names = sorted(f for f in os.listdir(dif_dir)
                       if not f.startswith("."))
    except OSError:
        sys.stderr.write(f"ERROR: can't open directory: {dif_dir}/\n")
        return 1
    for name in names:
        sys.stdout.write(f"Processing file: {name}\n")
        dif = read_dif(os.path.join(dif_dir, name))
        if dif is None:
            sys.stderr.write(f"ERROR:  reading {name} file! SKIP\n")
            continue
        if dif.lam == 0.710730:  # Mo wavelength (prepare_dif.c:226)
            sys.stderr.write(
                f"ERROR:  file {name} has wavelength of 0.710730! SKIP\n")
            continue
        raw_path = os.path.join(rruff_dir, "raw", name)
        if not read_raw(raw_path, dif):
            sys.stderr.write(f"ERROR: reading {raw_path} file! SKIP\n")
            continue
        out_path = os.path.join(sample_dir, name)
        try:
            with open(out_path, "w") as fp:
                if not dif_2_sample(dif, fp, n_inputs, n_outputs):
                    sys.stderr.write(
                        f"ERROR: writting {out_path} sample file!\n")
        except OSError:
            sys.stderr.write(
                f"ERROR: opening {out_path} sample file for WRITE!\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
