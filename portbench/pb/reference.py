"""The plain reference: hpnn's ANN training in plain PyTorch, float64, from
its published semantics (``src/ann.c`` of ovhpa/hpnn), with nothing of the
program under test imported or taken.

Per sample (``ann_train_BP`` / ``ann_train_BPM``, ``ann.c:2281-2372``)::

    iter = 0
    do { iter++
         d_L = (t - o) * dact(o); d_l = (W_{l+1}^T d_{l+1}) * dact(h_l)
         BP:  W_l += lr * (d_l h_{l-1}^T)                       lr 0.001
         BPM: dw_l += lr * (d_l h_{l-1}^T); W_l += dw_l; dw_l *= 0.2
                                            lr 0.0005, dw zeroed a sample
         dEp = Ep - Ep(new forward); ok = argmax(o) == target (first max;
         target = last index with t == 1, else 0)
         if iter == 1: first_ok = ok
         if iter > MAX (102399): break
         ok &= iter > MIN (31 BP, 15 BPM)
    } while (dEp > 1e-6 || !ok)

with act(x) = 2 / (1 + exp(-x)) - 1, dact(y) = -(y^2 - 1) / 2 and
Ep = sum((t - o)^2) / 2.  The stats row is (init Ep, first_ok, iter, dEp,
ok && iter > MIN).

Every iteration runs in place on one state: the update is multiplied by a
0/1 flag that is 0 once the sample has stopped, so an iteration past the
stop adds exactly zero and the loop may test its flag on the host only
every ``CHUNK`` iterations.  On a card the ``CHUNK`` iterations are one
CUDA graph of these same operations, replayed.
"""

from __future__ import annotations

import torch

MAX_ITER = 102399
DELTA = 1e-6
ALPHA = 0.2
CHUNK = 8


def hyper(momentum: bool) -> tuple[float, int]:
    """(learning rate, MIN iterations) of BP or BPM (``libhpnn.h:67-74``)."""
    return (0.0005, 15) if momentum else (0.001, 31)


def act(z):
    return 2.0 / (1.0 + torch.exp(-z)) - 1.0


def dact(y):
    return -0.5 * (y * y - 1.0)


def target_class(t: torch.Tensor) -> torch.Tensor:
    """Per row: the last index whose target is exactly 1.0, else 0."""
    idx = torch.arange(t.shape[-1], device=t.device)
    return torch.where(t == 1.0, idx, torch.zeros_like(idx)).amax(-1)


def forward(w, x):
    """All activations of rows x (rows, n_in)."""
    acts, v = [], x
    for wl in w:
        v = act(v @ wl.T)
        acts.append(v)
    return acts


def error(o, t):
    d = t - o
    return 0.5 * (d * d).sum(-1)


class _Sample:
    """One sample's state on the device (rows of one), stepped in place."""

    def __init__(self, w, momentum: bool):
        dev, f64 = w[0].device, torch.float64
        self.w, self.momentum = w, momentum
        self.lr, self.min_iter = hyper(momentum)

        def zeros(*shape, dtype=f64):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self.x = zeros(1, w[0].shape[1])
        self.t = zeros(1, w[-1].shape[0])
        self.p_trg = zeros(1, dtype=torch.long)
        self.dw = [torch.zeros_like(v) for v in w] if momentum else None
        self.acts = [zeros(1, v.shape[0]) for v in w]
        self.ep, self.init, self.dep, self.n_it = (zeros(1), zeros(1),
                                                   zeros(1), zeros(1))
        self.it = zeros()
        self.live = torch.ones(1, dtype=torch.bool, device=dev)
        self.ok_last = zeros(1, dtype=torch.bool)
        self.first_ok = zeros(1, dtype=torch.bool)
        self.graph = None

    def start(self, x, t) -> None:
        self.x.copy_(x)
        self.t.copy_(t)
        self.p_trg.copy_(target_class(t))
        for a, b in zip(self.acts, forward(self.w, self.x)):
            a.copy_(b)
        self.ep.copy_(error(self.acts[-1], self.t))
        self.init.copy_(self.ep)
        if self.dw is not None:
            for v in self.dw:
                v.zero_()
        for v in (self.dep, self.n_it, self.it):
            v.zero_()
        self.live.fill_(True)
        self.ok_last.fill_(False)
        self.first_ok.fill_(False)

    def iterate(self) -> None:
        w, x, t, acts = self.w, self.x, self.t, self.acts
        self.it.add_(1.0)
        on = self.live.to(torch.float64)
        o = acts[-1]
        ds = [(t - o) * dact(o)]
        for li in range(len(w) - 1, 0, -1):
            ds.insert(0, (ds[0] @ w[li]) * dact(acts[li - 1]))
        hs = [x, *acts[:-1]]
        for li in range(len(w)):
            g = (ds[li].T @ hs[li]) * self.lr
            if self.dw is not None:
                s = self.dw[li] + g
                w[li].add_(on * s)
                self.dw[li].copy_(ALPHA * s)
            else:
                w[li].add_(on * g)
        for a, b in zip(acts, forward(w, x)):
            a.copy_(b)
        epr = error(acts[-1], t)
        dep_new = self.ep - epr
        ok = torch.argmax(acts[-1], dim=-1) == self.p_trg
        live = self.live
        self.n_it.copy_(torch.where(live, self.it, self.n_it))
        self.dep.copy_(torch.where(live, dep_new, self.dep))
        self.ok_last.copy_(torch.where(live, ok, self.ok_last))
        self.first_ok.copy_(torch.where(self.it == 1.0, ok, self.first_ok))
        past_min = self.it > float(self.min_iter)
        goes_on = (dep_new > DELTA) | ~ok
        live.copy_(live & (self.it <= float(MAX_ITER))
                   & (~past_min | goes_on))
        self.ep.copy_(epr)

    def chunk(self) -> None:
        """CHUNK iterations: eager on the CPU, one graph replay on a card."""
        if self.x.device.type != "cuda":
            for _ in range(CHUNK):
                self.iterate()
            return
        if self.graph is None:
            self._capture()
        self.graph.replay()

    def _capture(self) -> None:
        """Record CHUNK iterations as one graph; the warm-up iterations
        run on a copy of the state and leave this one as it was."""
        saved = [v.clone() for v in self._tensors()]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                self.iterate()
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            for _ in range(CHUNK):
                self.iterate()
        for v, s in zip(self._tensors(), saved):
            v.copy_(s)

    def _tensors(self):
        return [*self.w, *(self.dw or []), *self.acts, self.ep, self.init,
                self.dep, self.n_it, self.it, self.live, self.ok_last,
                self.first_ok]

    def row(self) -> torch.Tensor:
        success = self.ok_last & (self.n_it > float(self.min_iter))
        return torch.stack([self.init, self.first_ok.double(), self.n_it,
                            self.dep, success.double()], dim=1)


class Trainer:
    """The reference's weights (float64 on ``device``) and its epoch of
    samples, one at a time."""

    def __init__(self, weights, momentum: bool, device):
        self.w = [torch.as_tensor(v, dtype=torch.float64).to(device).clone()
                  for v in weights]
        self.sample = _Sample(self.w, momentum)
        self.device = device

    def weights(self):
        return [v.cpu().numpy() for v in self.w]

    def run(self, xs, ts, cap: int | None = None):
        """Train rows xs (S, n_in), ts (S, n_out) in order; returns the
        float64 stats rows on the CPU, (S, 5), or fewer where the
        iterations so far pass ``cap`` after a row."""
        xs = torch.as_tensor(xs, dtype=torch.float64).to(self.device)
        ts = torch.as_tensor(ts, dtype=torch.float64).to(self.device)
        s, rows, spent = self.sample, [], 0
        for i in range(xs.shape[0]):
            s.start(xs[i:i + 1], ts[i:i + 1])
            while True:
                s.chunk()
                if not bool(s.live.any()):
                    break
            rows.append(s.row().clone())
            spent += int(rows[-1][0, 2])
            if cap is not None and spent > cap:
                break
        return torch.cat(rows).cpu()
