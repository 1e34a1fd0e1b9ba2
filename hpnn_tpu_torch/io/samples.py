"""Sample-file I/O and directory listing.

A sample file is text (``_NN(read,sample)``,
``src/libhpnn.c:1070-1145``):

    [input] N
    v1 v2 ... vN
    [output] M
    t1 t2 ... tM

The reference reads all N values from the SINGLE line following the header
(libhpnn.c:1102-1111) with raw ``strtod`` semantics -- a token strtod cannot
convert yields 0.0 and advances one character (``GET_DOUBLE`` +
``ptr=ptr2+1``, common.h:272-274), so short lines zero-fill and non-numeric
tokens read as 0.0 rather than failing; the only read failures are
unopenable/empty files and bad/zero section counts.  This parser replicates
that behavior exactly.  One deliberate
deviation remains at the loader level: a file whose section count is
smaller than the kernel's dimension makes the reference copy past its
allocation (libhpnn.c:1243, undefined behavior) -- the corpus loader
(``io.corpus``) skips such files with a diagnostic instead.
Directory listing skips dotfiles (``libhpnn.c:1194-1198``)
and preserves the OS readdir order, exactly like the reference (see
list_sample_dir's docstring).

:func:`read_sample_fast` is the bulk loader's entry: the native parser
(``csrc/sample_loader.c``, built by ``ops/build.py`` with the host C
compiler at first use) serves well-formed files and declines every other
file back to :func:`read_sample`.  ``HPNN_NO_NATIVE_IO=1`` turns it off;
``HPNN_IO_LIB`` names a library to load instead of the built one.  Unlike
the JAX package, a loader that fails to build or load raises (with the
compiler's output): there is no silent Python-parsing route.
"""

from __future__ import annotations

import ctypes
import os
import re
import threading

import numpy as np

from ..utils.nn_log import nn_error

# C strtod's accepted prefix: hex floats first (else the decimal branch
# would stop at the "0" of "0x1f"), then decimal w/ optional exponent
# (an incomplete exponent backtracks to the mantissa, like strtod), then
# inf/infinity and nan(chars), all case-insensitive.
_STRTOD_RE = re.compile(
    r"[+-]?(?:"
    r"0[xX](?:[0-9a-fA-F]+(?:\.[0-9a-fA-F]*)?|\.[0-9a-fA-F]+)"
    r"(?:[pP][+-]?\d+)?"
    r"|(?:\d+(?:\.\d*)?|\.\d+)(?:[eE][+-]?\d+)?"
    r"|[iI][nN][fF](?:[iI][nN][iI][tT][yY])?"
    r"|[nN][aA][nN](?:\([0-9A-Za-z_]*\))?"
    r")")

# a section count past any real workload (MNIST 784, XRD 851): the
# reference ALLOCs the claimed count and error-exits the process on OOM
# (common.h:161-167); aborting a 60k-file run on one corrupt header is
# hostile, so counts beyond this are a read failure + skip instead
# (documented deviation)
_MAX_COUNT = 1 << 20


_C_SPACE = " \t\n\r\v\f"  # C isspace set (C locale)


def _is_digit(ch: str) -> bool:
    """C ISDIGIT: ASCII '0'-'9' ONLY.  str.isdigit also accepts Unicode
    digits -- the latin-1 superscripts 0xB2/0xB3/0xB9 in a corrupt file
    would pass an .isdigit() gate and then raise ValueError from int()
    instead of taking the graceful error path."""
    return "0" <= ch <= "9"


def _strtod(s: str, pos: int) -> tuple[float, int]:
    """GET_DOUBLE (common.h:272-274): strtod skips leading C whitespace
    (which can include a newline) then parses its longest prefix at
    ``pos``; no conversion -> (0.0, pos) (strtod sets endptr=nptr).
    A NUL in the simulated buffer is never crossed -- it terminates the
    C string strtod sees."""
    p = pos
    while p < len(s) and s[p] in _C_SPACE:
        p += 1
    if p < len(s) and s[p] == "\0":
        return 0.0, pos
    m = _STRTOD_RE.match(s, p)
    if m is None:
        return 0.0, pos
    tok = m.group(0)
    low = tok.lstrip("+-").lower()
    if low.startswith("nan"):
        v = float("nan")
    elif low.startswith("inf"):
        v = float("-inf") if tok[0] == "-" else float("inf")
    elif low.startswith("0x"):
        v = float.fromhex(tok)
    else:
        v = float(tok)
    return v, m.end()


def _skip_blank(s: str, pos: int) -> int:
    """SKIP_BLANK (common.h:250-251): advance over non-ISGRAPH chars,
    stopping at newline, NUL, or end.  ISGRAPH is the C-locale set
    (0x21-0x7E) -- bytes >0x7E are skipped as blanks, exactly like the
    reference compiled under the C locale."""
    while pos < len(s):
        ch = s[pos]
        if ch == "\n" or ch == "\0" or 0x21 <= ord(ch) <= 0x7E:
            break
        pos += 1
    return pos


def _section_count(line: str, key: str) -> int | None:
    """The reference's count parse: ``ptr += len("[input")+1`` (skipping
    one char after the keyword, whatever it is), SKIP_BLANK, ISDIGIT
    check, then strtoull's digit prefix (GET_UINT, common.h:269-271) --
    so ``[input] 4.5`` reads count 4.  None = not a digit."""
    after = line.split(key, 1)[1][1:]
    pos = _skip_blank(after, 0)
    if pos >= len(after) or not _is_digit(after[pos]):
        return None
    j = pos
    while j < len(after) and _is_digit(after[j]):
        j += 1
    # (UINT)strtoull semantics, exactly like kernel_io._uint: saturate at
    # 2^64-1, then the macro's cast truncates to 32 bits -- BEFORE the
    # loader's _MAX_COUNT range check, so the two parsers agree with the
    # reference on absurd counts
    return min(int(after[pos:j]), 2**64 - 1) & 0xFFFFFFFF


def _parse_values_line(buf: str, n: int) -> np.ndarray:
    """The reference's value loop (libhpnn.c:1102-1111): n GET_DOUBLEs
    from ONE line; after each non-final value, skip exactly one char
    (``ptr=ptr2+1``) then SKIP_BLANK.  A failed conversion yields 0.0
    and the one-char skip still advances, which is what zero-fills short
    lines and reads non-numeric tokens as 0.0.

    ``buf`` is the SIMULATED getline buffer, not just the current line:
    the one-char skip steps PAST the line's NUL terminator into stale
    bytes left by the file's earlier (longer) lines, and strtod can then
    parse those -- e.g. a '[input] 5' header overwritten by a '1 2 3'
    values line leaves ' 5' at offsets 7-8, and the reference reads
    [1,2,3,0,5] (verified against the compiled reference).  Past the end of
    every previously written byte the C buffer holds malloc garbage;
    that region reads as zeros here (documented residual -- it is not
    reproducible even between builds of the reference)."""
    vals = np.empty(n, np.float64)
    pos = _skip_blank(buf, 0)
    for idx in range(n - 1):
        if pos >= len(buf):
            # beyond the simulated buffer every GET_DOUBLE yields 0.0 --
            # short-circuit the remaining iterations (bounded time)
            vals[idx:] = 0.0
            return vals
        v, end = _strtod(buf, pos)
        vals[idx] = v
        pos = _skip_blank(buf, min(end + 1, len(buf)))
    vals[n - 1] = _strtod(buf, pos)[0] if pos < len(buf) else 0.0
    return vals


class _GetlineSim:
    """The reference's READLINE/getline state: ONE growing buffer reused
    for every line of a file.

    * ``line`` is the C string the scanners see: the new line's bytes up
      to (and excluding) the terminator -- keyword searches must use
      :meth:`cline`, which additionally stops at any EMBEDDED NUL byte
      from the file, like strstr would.
    * ``buf`` is the full simulated buffer: the new line + an explicit
      NUL + the stale tail of earlier, longer lines -- the strtod value
      loops can walk into it (see _parse_values_line).
    * a read at EOF FAILS, leaving line and buf unchanged and setting
      ``feof``.  glibc sets the stream's EOF flag already on the read
      that RETURNS a final line with no trailing newline (verified with
      a compiled probe), so the reference's ``do{{scan;READLINE}}
      while(!feof)`` loops never scan such a line -- replicated here.
    * ``rewind`` clears feof but keeps the buffer (ann_load re-scans the
      file per section phase with the same buffer).
    """

    def __init__(self, lines: list[str]):
        self.lines = lines
        self.i = -1
        self.line = ""
        self.buf = ""
        self.feof = False

    def readline(self) -> None:
        if self.i + 1 < len(self.lines):
            self.i += 1
            new = self.lines[self.i]
            self.buf = new + "\0" + self.buf[len(new) + 1:]
            self.line = new
            if self.i == len(self.lines) - 1 and not new.endswith("\n"):
                self.feof = True
        else:
            self.feof = True

    def cline(self) -> str:
        """The C string strstr sees: up to the first embedded NUL."""
        return self.line.split("\0", 1)[0]

    def rewind(self) -> None:
        self.i = -1
        self.feof = False


def read_sample(path: str) -> tuple[np.ndarray | None, np.ndarray | None]:
    """Parse one sample file; (None, None) on failure, as the reference.

    Control flow mirrors _NN(read,sample) (libhpnn.c:1070-1145): the
    section keyword is matched anywhere in the current line, the values
    come from the next line (READLINE), and that VALUES line is then
    itself checked for the ``[output`` keyword in the same iteration.
    At EOF, getline leaves the buffer unchanged, so a header with no
    following line (re)parses the header line itself as values; a FINAL
    header line without a trailing newline is never scanned at all (the
    glibc feof timing, see _GetlineSim).  Files are decoded latin-1 so
    every byte maps to one char, like the byte-oriented reference (a
    corrupt byte reads as junk that strtod turns into 0.0, never a
    decode error).
    """
    try:
        fp = open(path, "r", encoding="latin-1")
    except OSError:
        return None, None
    with fp:
        lines = fp.readlines()
    if not lines:
        # the reference's line==NULL check (libhpnn.c:1083-1087) is dead
        # under glibc -- getline allocates even at immediate EOF, so an
        # empty file silently yields (NULL, NULL) with no message
        return None, None
    vec_in: np.ndarray | None = None
    vec_out: np.ndarray | None = None
    sim = _GetlineSim(lines)
    sim.readline()
    while True:
        cl = sim.cline()
        if "[input" in cl:
            n = _section_count(cl, "[input")
            if n is None or n == 0 or n > _MAX_COUNT:
                nn_error(f"sample {path} input read failed!\n")
                return None, None
            sim.readline()
            vec_in = _parse_values_line(sim.buf, n)
            cl = sim.cline()
        if "[output" in cl:
            n = _section_count(cl, "[output")
            if n is None or n > _MAX_COUNT:
                nn_error(f"sample {path} output read failed!\n")
                return None, None
            if n == 0:
                # the reference prints "input read failed" for a zero
                # OUTPUT count (copy-paste quirk, libhpnn.c:1122-1125)
                nn_error(f"sample {path} input read failed!\n")
                return None, None
            sim.readline()
            vec_out = _parse_values_line(sim.buf, n)
        sim.readline()
        if sim.feof:
            break
    return vec_in, vec_out


# --- native fast path -------------------------------------------------------
# csrc/sample_loader.c parses well-formed files ~10x faster than the Python
# token loop (the reference's own loader is C, libhpnn.c:1070-1145; at MNIST
# scale parsing dominates a run's start).  Any anomaly makes the C side
# DECLINE and the Python parser re-read the file, so diagnostics and
# edge-case behavior stay byte-identical.

_native_lib = None      # None: not probed yet; False: opted out; the CDLL
_native_lock = threading.Lock()


def _native():
    """The native loader's library, or None under ``HPNN_NO_NATIVE_IO``.
    Loads ``HPNN_IO_LIB`` when set, else builds/loads the port's own copy;
    raises when either fails (nothing is cached then, so the next call
    tries again)."""
    global _native_lib
    if _native_lib is not None:
        return _native_lib or None
    with _native_lock:  # the parallel loader's workers may probe too
        if _native_lib is not None:
            return _native_lib or None
        if os.environ.get("HPNN_NO_NATIVE_IO"):
            _native_lib = False
            return None
        path = os.environ.get("HPNN_IO_LIB")
        if path:
            try:
                lib = ctypes.CDLL(path)
            except OSError as exc:
                raise RuntimeError(f"HPNN_IO_LIB={path}: the native sample "
                                   f"loader does not load ({exc})") from exc
        else:
            from ..ops import build

            lib = build.load("sample_loader")
        fn = lib.hpnn_read_sample
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_char_p,
                       ctypes.POINTER(ctypes.c_double), ctypes.c_int,
                       ctypes.POINTER(ctypes.c_int),
                       ctypes.POINTER(ctypes.c_double), ctypes.c_int,
                       ctypes.POINTER(ctypes.c_int)]
        _native_lib = lib
    return lib


def native_io_status() -> str:
    """'on' when the native fast path serves reads, 'off' under
    ``HPNN_NO_NATIVE_IO`` -- the loader's load-stats line and the serving
    /metrics snapshot report it."""
    return "on" if _native() is not None else "off"


def read_sample_fast(path: str, n_in_hint: int, n_out_hint: int):
    """:func:`read_sample` with a native fast path sized by the expected
    dims: returns exactly what :func:`read_sample` would -- the C parser
    serves only the files it parses cleanly within the hinted capacities
    and declines the rest (rc -2) to the Python parser."""
    lib = _native()
    if lib is None or n_in_hint <= 0 or n_out_hint <= 0:
        return read_sample(path)
    in_buf = np.empty(n_in_hint, np.float64)
    out_buf = np.empty(n_out_hint, np.float64)
    n_in = ctypes.c_int(0)
    n_out = ctypes.c_int(0)
    rc = lib.hpnn_read_sample(
        path.encode(),
        in_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n_in_hint, ctypes.byref(n_in),
        out_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n_out_hint, ctypes.byref(n_out))
    if rc == -1:
        return None, None  # unopenable: the same answer, no second syscall
    if rc != 0:
        return read_sample(path)  # declined: Python re-reads, diagnostics
    return in_buf[:n_in.value], out_buf[:n_out.value]


def list_sample_dir(dirpath: str) -> list[str] | None:
    """File names (not paths) in dirpath, dotfiles skipped, READDIR order.

    The reference walks readdir order (libhpnn.c:1190-1214) and applies the
    seeded shuffle on top of it; os.listdir returns the same readdir order,
    so keeping it unsorted makes the shuffled sequence -- and therefore the
    whole training trajectory -- identical to the reference's on the same
    filesystem.  Note readdir order is filesystem-
    dependent, so runs are reproducible per-machine, exactly like the
    reference.
    """
    try:
        names = os.listdir(dirpath)
    except OSError:
        return None
    return [n for n in names if not n.startswith(".")
            and os.path.isfile(os.path.join(dirpath, n))]
