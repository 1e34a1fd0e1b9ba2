"""The comparison that decides ``correct``: what the program produced,
against the plain reference (``reference.py``) on the same inputs.

What is compared, each with a limit of its own (``PERF.md`` gives the
readings each limit was set from):

* ``order_errors``: in every epoch of the window, the training lines'
  files against the order the reference works out from the conf's seed
  and the directory listing, every row trained; exact.
* ``row_mismatch``: rows the reference replays whose N_ITER, OK/NO or
  SUCCESS/FAIL differ from the program's, or that it printed no line
  for; exact.  Replayed: the rows of the set-up's three steps (from the
  benchmark's initial weights), the first rows of the window's first
  epoch (the reference's own weights carried on, as many as
  ``replay_first_iterations`` of the program's N_ITER allow), and every
  row of the window's last ``replay_last_epochs`` epochs after its first,
  each from the program's weights before that epoch.
* ``err_gap``: the widest gap between the program's printed ``init=`` or
  ``final=`` and the reference's value printed the same way, over the same
  rows.
* ``w_gap``: after each set-up step, the gap between the program's and
  the reference's norm of each layer's change from the initial weights,
  over the larger of the reference's norm of that layer and of the median
  layer; the worst layer and step.
* ``epoch_w_gap``: the same gap for each whole window epoch replayed,
  the change from the program's weights before the epoch to its weights
  after it against the reference's from the same start.
* ``unreplayed``: of the last ``replay_last_epochs`` epochs after the
  window's first, those not replayed whole: missing (a window too short),
  or over ``replay_epoch_iterations`` of the program's N_ITER; exact.
"""

from __future__ import annotations

import numpy as np

from . import glibc, lines


def row_gaps(prog: list, ref: np.ndarray, seen: list | None = None
             ) -> tuple[int, float]:
    """(mismatched rows, widest printed error gap) of program rows against
    the reference's (S, 5) stats; a missing program row mismatches.  The
    mismatched pairs are appended to ``seen``."""
    mismatch, gap = 0, 0.0
    for i, (r, row) in enumerate(zip(prog, ref)):
        init, first_ok, n_iter, final, success = row
        bad = r is None or (r.n_iter != int(n_iter)
                            or r.first_ok != bool(first_ok)
                            or r.success != bool(success))
        if r is not None:
            gap = max(gap, abs(r.init - lines.printed(init)),
                      abs(r.final - lines.printed(final)))
        if bad:
            mismatch += 1
            if seen is not None:
                seen.append((i, r, row.tolist()))
    mismatch += max(0, len(ref) - len(prog))
    return mismatch, gap


def change_gap(w0, prog, ref) -> float:
    """Worst layer's gap of the change norms, as a share of the larger of
    that layer's reference change and the median layer's."""
    p = [float(np.linalg.norm(a - b)) for a, b in zip(prog, w0)]
    r = [float(np.linalg.norm(a - b)) for a, b in zip(ref, w0)]
    floor = float(np.median(r))
    return max(abs(pn - rn) / max(rn, floor, 1e-300)
               for pn, rn in zip(p, r))


def order_errors(epochs: list, names: list[str], seed: int
                 ) -> tuple[int, list]:
    """(errors, the orders): each window epoch's rows against the
    reference's shuffle of ``names`` continued epoch after epoch."""
    rng = glibc.Random(seed)
    errors, orders = 0, []
    for rows in epochs:
        order = glibc.shuffle(rng, len(names))
        orders.append(order)
        errors += abs(len(rows) - len(order))
        for r, idx in zip(rows, order):
            if r is None or r.name != names[idx][:16] or r.n_iter < 1:
                errors += 1
    return errors, orders


def replay_rows(rows: list, budget: int) -> int:
    """How many leading rows the reference replays: while the program's
    N_ITER of the rows stays within ``budget``; at least one."""
    spent, k = 0, 0
    while k < len(rows) and rows[k] is not None:
        if k and spent + rows[k].n_iter > budget:
            break
        spent += rows[k].n_iter
        k += 1
    return max(k, min(1, len(rows)))


def whole_epochs(epochs: list, last: int, budget: int
                 ) -> tuple[list[int], int]:
    """(the window epochs replayed whole: of the last ``last`` after the
    first, those whose rows all printed and took the program within
    ``budget`` iterations; how many of the ``last`` are not)."""
    fit = [e for e in range(max(1, len(epochs) - last), len(epochs))
           if all(r is not None for r in epochs[e])
           and sum(r.n_iter for r in epochs[e]) <= budget]
    return fit, last - len(fit)


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each number beside its limit, and whether all are within."""
    out = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    return all(numbers[k] <= limits[k] for k in limits), out
