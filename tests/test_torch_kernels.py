"""The port's ``fused_linear_act`` and forward paths against the JAX
package, on the CPU.

On a CPU tensor the wrapper takes the kernel's plain torch version; the
JAX side is ``hpnn_tpu.ops.pallas_kernels.fused_linear_act`` in Pallas
interpret mode (what it runs on any non-TPU backend).  The cases and
tolerances are those of tests/test_pallas.py.  The CUDA kernel itself
runs only on the card: ``chip_smoke.py`` holds it against this same plain
version there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hpnn_tpu import ops as jax_ops
from hpnn_tpu.ops.pallas_kernels import (batched_forward_pallas,
                                         fused_linear_act as jax_fla)
from hpnn_tpu_torch import ops
from hpnn_tpu_torch.ops.kernels import (batched_forward_fused,
                                        fused_linear_act)


def _w(rng, n, m):
    return rng.uniform(-1, 1, (n, m)) / np.sqrt(m)


def _both(a, dtype):
    """One numpy array as a JAX array and a torch CPU tensor."""
    jd = {"f32": jnp.float32, "bf16": jnp.bfloat16, "f64": jnp.float64}
    td = {"f32": torch.float32, "bf16": torch.bfloat16, "f64": torch.float64}
    return (jnp.asarray(a, dtype=jd[dtype]),
            torch.as_tensor(a, dtype=torch.float64).to(td[dtype]))


@pytest.mark.parametrize("n,m,b,scale,act,atol", [
    # pre-activations are O(100) at MNIST pixel scale: float32
    # reduction-order differences reach ~1e-4 before the tanh
    (300, 784, 32, 255.0, True, 1e-4),
    (10, 300, 8, 1.0, False, 2e-5),     # the SNN head's raw product
    (13, 37, 5, 1.0, True, 2e-6),       # ragged: no tile divides it
    (64, 96, 700, 1.0, True, 1e-5),     # a batch of several tiles
], ids=["mnist-784x300", "no-act-300x10", "ragged-37x13", "batch-700"])
def test_fused_linear_act_matches_pallas(n, m, b, scale, act, atol):
    rng = np.random.default_rng(77 + n)
    w = _w(rng, n, m)
    lo = 0.0 if scale > 1 else -1.0
    xs = rng.uniform(lo, scale, (b, m))
    wj, wt = _both(w, "f32")
    xj, xt = _both(xs, "f32")
    want = np.asarray(jax_fla(wj, xj, act=act), np.float64)
    got = fused_linear_act(wt, xt, act=act)
    assert got.dtype == torch.float32 and got.shape == (b, n)
    np.testing.assert_allclose(got.double().numpy(), want, atol=atol,
                               rtol=0)


def test_fused_linear_act_bf16_f32_accumulation():
    """bfloat16 operands accumulate in float32: the error stays at the
    bfloat16 quantization level, not the reduction length's."""
    rng = np.random.default_rng(78)
    w = rng.uniform(-1, 1, (64, 2048)) / 45
    xs = rng.uniform(-1, 1, (16, 2048))
    wj, wt = _both(w, "bf16")
    xj, xt = _both(xs, "bf16")
    want = np.asarray(jax_fla(wj, xj, tile_m=512), np.float32)
    got = fused_linear_act(wt, xt)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=0.02, rtol=0)


@pytest.mark.parametrize("kind", ["ANN", "SNN"])
def test_batched_forward_fused_matches_pallas(kind):
    rng = np.random.default_rng(79)
    ws = [_w(rng, n, m) for m, n in [(19, 16), (16, 8), (8, 5)]]
    xs = rng.uniform(-1, 1, (6, 19))
    wj = tuple(_both(w, "f32")[0] for w in ws)
    wt = tuple(_both(w, "f32")[1] for w in ws)
    xj, xt = _both(xs, "f32")
    want = np.asarray(batched_forward_pallas(wj, xj, kind), np.float64)
    got = batched_forward_fused(wt, xt, kind).double().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _f64_case(kind, b=11):
    rng = np.random.default_rng(80)
    ws = [_w(rng, n, m) for m, n in [(19, 16), (16, 8), (8, 5)]]
    xs = rng.uniform(0, 255.0, (b, 19))
    want = np.asarray(jax_ops.run_batch(
        tuple(jnp.asarray(w) for w in ws), jnp.asarray(xs), kind))
    wt = tuple(torch.as_tensor(w) for w in ws)
    return wt, torch.as_tensor(xs), want


@pytest.mark.parametrize("kind", ["ANN", "SNN", "LNN"])
def test_f64_batched_forward_fused_matches_jax_run_batch(kind):
    """float64 through the fused path (plain on the CPU) against the JAX
    package's per-row run_batch: only summation order differs, 1e-13."""
    wt, xt, want = _f64_case(kind)
    got = batched_forward_fused(wt, xt, kind).numpy()
    np.testing.assert_allclose(got, want, atol=1e-13, rtol=0)


@pytest.mark.parametrize("kind", ["ANN", "SNN", "LNN"])
def test_f64_run_batch_matches_jax_run_batch(kind):
    """The CPU strict tier (per-row mv chains) against the JAX package's
    per-row run_batch, 1e-13 -- and its rows are independent of the batch
    they ride in, bit for bit."""
    wt, xt, want = _f64_case(kind)
    got = ops.run_batch(wt, xt, kind).numpy()
    np.testing.assert_allclose(got, want, atol=1e-13, rtol=0)
    alone = ops.run_batch(wt, xt[3:4].contiguous(), kind).numpy()
    assert np.array_equal(alone[0], got[3])


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_activations_match_jax(dtype):
    """ann_act (literal expression at f64, tanh(x/2) at f32) and the
    TINY-seeded softmax(x-1) (serial fold at f64) against the JAX
    package's, to a few ULP."""
    from hpnn_tpu.ops import activations as jact
    from hpnn_tpu_torch.ops import activations as tact

    rng = np.random.default_rng(81)
    x = rng.uniform(-8, 8, (7, 10))
    xj, xt = _both(x, dtype)
    tol = 1e-15 if dtype == "f64" else 1e-6
    np.testing.assert_allclose(tact.ann_act(xt).double().numpy(),
                               np.asarray(jact.ann_act(xj), np.float64),
                               atol=tol, rtol=0)
    np.testing.assert_allclose(tact.snn_softmax(xt).double().numpy(),
                               np.asarray(jact.snn_softmax(xj), np.float64),
                               atol=tol, rtol=0)


def test_cpu_tensors_never_launch_the_kernel():
    rng = np.random.default_rng(82)
    w = torch.as_tensor(_w(rng, 8, 5), dtype=torch.float32)
    xs = torch.as_tensor(rng.uniform(-1, 1, (3, 5)), dtype=torch.float32)
    before = fused_linear_act.launches
    fused_linear_act(w, xs)
    batched_forward_fused((w, w.T.contiguous()), xs, "SNN")
    assert fused_linear_act.launches == before == 0


def test_wrapper_rejects_bad_inputs():
    w = torch.zeros((4, 6), dtype=torch.float32)
    with pytest.raises(TypeError):
        fused_linear_act(w, torch.zeros((2, 6), dtype=torch.float64))
    with pytest.raises(TypeError):
        fused_linear_act(w.half(), torch.zeros((2, 6), dtype=torch.half))
    with pytest.raises(ValueError):
        fused_linear_act(w, torch.zeros((6, 2), dtype=torch.float32).T)
    with pytest.raises(ValueError):
        fused_linear_act(torch.zeros((6, 4)).T, torch.zeros((2, 6)))
    with pytest.raises(ValueError):
        fused_linear_act(w, torch.zeros((2, 5), dtype=torch.float32))


def test_select_run_batch_routing():
    """CPU: float64 strict = per-row run_batch, float64 fast = GEMM
    chain, float32/bf16 = the fused path (plain on the CPU).  CUDA: the
    fused kernel everywhere except fast-tier float64."""
    sel = ops.select_run_batch
    assert sel(torch.float64, "strict", device="cpu")[1] == "rows"
    assert sel(torch.float64, "fast", device="cpu")[1] == "gemm"
    for dt in (torch.float32, torch.bfloat16):
        for tier in ("strict", "fast"):
            assert sel(dt, tier, device="cpu")[1] == "fused"
            assert sel(dt, tier, device="cuda")[1] == "fused"
    assert sel(torch.float64, "strict", device="cuda")[1] == "fused"
    assert sel(torch.float64, "fast", device="cuda")[1] == "gemm"
    with pytest.raises(ValueError):
        sel(torch.float64, "exact")


# --- fused_bpm_update ---------------------------------------------------------

@pytest.mark.parametrize("n,m", [(300, 784), (10, 300), (230, 851),
                                 (230, 230), (7, 13)])
@pytest.mark.parametrize("dtype,atol", [("f64", 1e-12), ("f32", 1e-6)])
def test_fused_bpm_update_matches_pallas(n, m, dtype, atol):
    """The plain version against the Pallas kernel (interpret mode off the
    TPU) at the MNIST and XRD layers (851 columns are not 16-byte rows at
    either dtype, 230 not at float32) and a ragged shape; the reference
    order (tests/test_pallas.py:63): dw += lr*outer; W += dw; dw *= alpha."""
    from hpnn_tpu.ops.pallas_kernels import fused_bpm_update as jax_bpm
    from hpnn_tpu_torch.ops.kernels import fused_bpm_update

    rng = np.random.default_rng(63 + n)
    arrays = (_w(rng, n, m), rng.uniform(-0.01, 0.01, (n, m)),
              rng.uniform(-1, 1, n), rng.uniform(-1, 1, m))
    lr, alpha = 0.0005, 0.2
    jw, jdw = jax_bpm(*(_both(a, dtype)[0] for a in arrays), lr, alpha)
    ins = tuple(_both(a, dtype)[1] for a in arrays)
    before = tuple(v.clone() for v in ins)
    pw, pdw = fused_bpm_update(*ins, lr, alpha)
    np.testing.assert_allclose(pw.double().numpy(),
                               np.asarray(jw, np.float64), atol=atol, rtol=0)
    np.testing.assert_allclose(pdw.double().numpy(),
                               np.asarray(jdw, np.float64), atol=atol, rtol=0)
    assert all(torch.equal(a, b) for a, b in zip(ins, before))  # untouched
    assert pw.dtype == pdw.dtype == ins[0].dtype


def test_fused_bpm_update_cpu_never_launches():
    from hpnn_tpu_torch.ops.kernels import fused_bpm_update

    z = torch.zeros((3, 4), dtype=torch.float64)
    before = fused_bpm_update.launches
    fused_bpm_update(z, z, torch.zeros(3, dtype=torch.float64),
                     torch.zeros(4, dtype=torch.float64), 0.1, 0.2)
    assert fused_bpm_update.launches == before == 0


@pytest.mark.parametrize("case", ["dtype", "mixed", "d-shape", "h-shape",
                                  "dw-shape", "contiguity"])
def test_fused_bpm_update_rejects_bad_inputs(case):
    from hpnn_tpu_torch.ops.kernels import fused_bpm_update

    w = torch.zeros((4, 6), dtype=torch.float32)
    d, h = torch.zeros(4), torch.zeros(6)
    args = {"dtype": (w.half(), w.half(), d.half(), h.half()),
            "mixed": (w, w.double(), d, h),
            "d-shape": (w, w, torch.zeros(5), h),
            "h-shape": (w, w, d, torch.zeros(4)),
            "dw-shape": (w, torch.zeros((4, 5)), d, h),
            "contiguity": (torch.zeros((6, 4)).T, w, d, h)}[case]
    exc = TypeError if case in ("dtype", "mixed") else ValueError
    with pytest.raises(exc):
        fused_bpm_update(*args, 0.1, 0.2)


# --- fused_bpm_update's launch plan ------------------------------------------
# chip_smoke.py phase 13's shapes (N, M), a ragged one and a single row

BPM_SHAPES = [(300, 784), (10, 300), (230, 851), (230, 230), (4096, 4096),
              (7, 13), (1, 5)]


def _bpm_cover(plan, n, m):
    """How many times the plan's threads touch each weight: thread (x, y)
    of block (bx, by) owns columns [(bx*tx + x)*vec, +vec) and rows
    by*ty + y, stepping gy*ty, as the kernel walks them (a thread's rows
    and columns are independent, so the count is an outer product)."""
    cols = np.zeros(m, dtype=np.int64)
    for c in range(0, plan.gx * plan.tx * plan.vec, plan.vec):
        if c < m:
            cols[c:c + plan.vec] += 1
    rows = np.zeros(n, dtype=np.int64)
    step = plan.gy * plan.ty
    for first in range(min(step, n)):
        rows[first::step] += 1
    return np.outer(rows, cols)


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned",
                                                         "unaligned"])
@pytest.mark.parametrize("itemsize", [8, 4, 2], ids=["f64", "f32", "bf16"])
@pytest.mark.parametrize("n,m", BPM_SHAPES)
def test_fused_bpm_plan_covers_every_weight_once(n, m, itemsize, aligned):
    from hpnn_tpu_torch.ops.kernels import BPM_THREADS, fused_bpm_plan

    plan = fused_bpm_plan(n, m, itemsize, aligned=aligned)
    assert plan.tx % 32 == 0 and plan.tx * plan.ty <= BPM_THREADS
    assert plan.ty >= 1 and plan.gx >= 1 and 1 <= plan.gy <= 65535
    if plan.vec > 1:   # whole 16-byte vectors, never across a row's end
        assert plan.vec * itemsize == 16 and m % plan.vec == 0
    # the fewest 256-thread column blocks, and no block of idle columns
    assert plan.gx == -(-(-(-m // plan.vec)) // BPM_THREADS)
    assert (plan.gx - 1) * plan.tx * plan.vec < m
    assert (_bpm_cover(plan, n, m) == 1).all()


@pytest.mark.parametrize("n,m,itemsize,vec", [
    (300, 784, 4, 4), (300, 784, 8, 2), (10, 300, 4, 4), (10, 300, 8, 2),
    (230, 851, 4, 1), (230, 851, 8, 1), (230, 230, 4, 1), (230, 230, 8, 2),
    (4096, 4096, 4, 4), (4096, 4096, 8, 2), (300, 784, 2, 8),
    (10, 300, 2, 1), (230, 851, 2, 1), (230, 230, 2, 1), (4096, 4096, 2, 8)])
def test_fused_bpm_plan_vectors_where_the_pitch_allows(n, m, itemsize, vec):
    """16-byte rows take 16-byte vectors (8 bfloat16 values); 851 columns
    at every dtype, 230 at float32 and bfloat16 and 300 at bfloat16 are
    not 16-byte rows and take one column a thread, as does any shape whose
    pointers are not 16-byte aligned."""
    from hpnn_tpu_torch.ops.kernels import fused_bpm_plan

    assert fused_bpm_plan(n, m, itemsize).vec == vec
    assert fused_bpm_plan(n, m, itemsize, aligned=False).vec == 1


@pytest.mark.parametrize("n,m", BPM_SHAPES + [(70000, 4), (200000, 300)])
def test_fused_bpm_plan_takes_a_thread_a_row(n, m):
    """Every row has a thread of its own up to the grid's 65535 row blocks;
    past them the rows are shared out evenly by the stride."""
    from hpnn_tpu_torch.ops.kernels import fused_bpm_plan

    for item in (8, 4):
        p = fused_bpm_plan(n, m, item)
        if -(-n // p.ty) <= 65535:
            assert p.gy * p.ty >= n > (p.gy - 1) * p.ty, (n, m, item, p)
        else:
            assert p.gy == 65535
    assert fused_bpm_plan(4096, 4096, 4) == (4, 256, 1, 4, 4096)
    assert fused_bpm_plan(10, 300, 4) == (4, 96, 2, 1, 5)
