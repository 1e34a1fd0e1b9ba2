"""The plain reference against a hand-worked case, the program's own
shuffle and the program's plain CPU route."""

import math

import numpy as np
import pytest
import torch

from toy import spec  # noqa: F401  (puts portbench on the path)
from pb import glibc, reference


def test_portbench_glibc_stream():
    # glibc: srandom(1); random() x 4
    r = glibc.Random(1)
    assert [r.random() for _ in range(4)] == [1804289383, 846930886,
                                              1681692777, 1714636915]


@pytest.mark.parametrize("seed,n", [(10958, 100), (2**31 + 7, 37), (1, 2)])
def test_portbench_shuffle_is_the_programs(seed, n):
    from hpnn_tpu_torch.utils.glibc_random import GlibcRandom, shuffled_indices

    mine, theirs = glibc.Random(seed), GlibcRandom(seed)
    for _ in range(3):  # one stream across epochs
        assert glibc.shuffle(mine, n) == shuffled_indices(theirs, n)


def _scalar_epoch(w, xs, ts, momentum):
    """The loop of ann.c written out in Python floats, one sample at a
    time, for a 2-2-2 network."""
    lr, min_it = (0.0005, 15) if momentum else (0.001, 31)
    w = [[list(r) for r in m] for m in w]

    def act(z):
        return 2.0 / (1.0 + math.exp(-z)) - 1.0

    def fwd(x):
        h = [act(sum(w[0][i][j] * x[j] for j in range(2))) for i in range(2)]
        o = [act(sum(w[1][i][j] * h[j] for j in range(2))) for i in range(2)]
        return h, o

    def err(o, t):
        return 0.5 * sum((t[i] - o[i]) ** 2 for i in range(2))

    rows = []
    for x, t in zip(xs, ts):
        trg = max([i for i in range(2) if t[i] == 1.0], default=0)
        dw = [[[0.0] * 2 for _ in range(2)] for _ in range(2)]
        h, o = fwd(x)
        ep = err(o, t)
        init, it = ep, 0
        while True:
            it += 1
            do = [(t[i] - o[i]) * (-0.5 * (o[i] * o[i] - 1.0))
                  for i in range(2)]
            dh = [sum(w[1][k][i] * do[k] for k in range(2))
                  * (-0.5 * (h[i] * h[i] - 1.0)) for i in range(2)]
            for li, (d, v) in enumerate(((dh, x), (do, h))):
                for i in range(2):
                    for j in range(2):
                        g = (d[i] * v[j]) * lr
                        if momentum:
                            dw[li][i][j] += g
                            w[li][i][j] += dw[li][i][j]
                            dw[li][i][j] *= 0.2
                        else:
                            w[li][i][j] += g
            h, o = fwd(x)
            epr = err(o, t)
            dep, ep = ep - epr, epr
            ok = max(range(2), key=lambda i: (o[i], -i)) == trg
            if it == 1:
                first = ok
            if it > reference.MAX_ITER:
                break
            ok = ok and it > min_it
            if not (dep > 1e-6 or not ok):
                break
        rows.append([init, float(first), float(it), dep,
                     float(ok and it > min_it)])
    return w, np.array(rows)


@pytest.mark.parametrize("momentum", [False, True])
def test_portbench_reference_two_samples_by_hand(momentum):
    w0 = [np.array([[1.5, -1.0], [-1.0, 1.5]]),
          np.array([[5.0, -5.0], [-5.0, 5.0]])]
    xs = np.array([[1.0, 0.5], [0.2, 0.9]])
    ts = np.array([[1.0, -1.0], [-1.0, 1.0]])
    want_w, want_rows = _scalar_epoch(w0, xs, ts, momentum)
    tr = reference.Trainer(w0, momentum, "cpu")
    got = tr.run(xs, ts).numpy()
    assert got[:, 2].tolist() == want_rows[:, 2].tolist()
    np.testing.assert_allclose(got, want_rows, rtol=0, atol=1e-12)
    for a, b in zip(tr.weights(), want_w):
        np.testing.assert_allclose(a, np.array(b), rtol=0, atol=1e-12)


@pytest.mark.parametrize("momentum", [False, True])
def test_portbench_reference_is_the_programs_cpu_route(momentum):
    from hpnn_tpu_torch.ops import train_epoch

    rng = np.random.default_rng(4)
    w0 = [rng.uniform(-0.25, 0.25, (8, 16)), rng.uniform(-0.35, 0.35, (2, 8))]
    centres = rng.uniform(0, 60, (2, 16))
    xs = centres[np.arange(4) % 2] + rng.normal(0, 3, (4, 16))
    ts = -np.ones((4, 2))
    ts[np.arange(4), np.arange(4) % 2] = 1.0
    tw = [torch.tensor(v) for v in w0]
    txs, tts = torch.tensor(xs), torch.tensor(ts)
    tr = reference.Trainer(w0, momentum, "cpu")
    got = tr.run(xs, ts).numpy()
    w, st = train_epoch(tw, txs, tts, "ANN", momentum, defer_stats=True)
    assert got[:, 2].tolist() == st[:, 2].tolist()
    np.testing.assert_allclose(got, st.numpy(), rtol=0, atol=1e-13)
    for a, b in zip(tr.weights(), w):
        np.testing.assert_allclose(a, b.numpy(), rtol=0, atol=1e-13)


def test_portbench_reference_stops_past_its_cap():
    """A replay capped at some iterations stops after the row that passes
    them: the rows it returns are the uncapped run's first rows."""
    w0 = [np.array([[1.5, -1.0], [-1.0, 1.5]]),
          np.array([[5.0, -5.0], [-5.0, 5.0]])]
    xs = np.array([[1.0, 0.5], [0.2, 0.9], [0.9, 0.4], [0.1, 1.0]])
    ts = np.array([[1.0, -1.0], [-1.0, 1.0]] * 2)
    whole = reference.Trainer(w0, True, "cpu").run(xs, ts).numpy()
    cap = int(whole[0, 2]) + 1
    part = reference.Trainer(w0, True, "cpu").run(xs, ts, cap=cap).numpy()
    assert len(part) == 2
    assert np.array_equal(part, whole[:2])


def test_portbench_whole_epochs_counts_what_it_cannot_replay():
    """Of the last epochs after the first, those missing from a short
    window, over the budget or with a row that printed no line count."""
    from pb import check, lines

    def epoch(n_iter, rows=3):
        return [lines.Row("f", 0.1, True, n_iter, 0.0, True)] * rows

    assert check.whole_epochs([epoch(900), epoch(16), epoch(16)], 2,
                              100) == ([1, 2], 0)
    assert check.whole_epochs([epoch(900), epoch(16)], 2, 100) == ([1], 1)
    assert check.whole_epochs([epoch(900)], 2, 100) == ([], 2)
    assert check.whole_epochs([epoch(900), epoch(900), epoch(16)], 2,
                              100) == ([2], 1)
    assert check.whole_epochs([epoch(16), epoch(16) + [None], epoch(16)], 2,
                              100) == ([2], 1)
