"""The fused layer forward on Hopper: ``fused_linear_act`` and the
whole-net ``batched_forward_fused`` built from it.

Source note (what the CUDA kernel is and why):

* **Replaces** the Pallas TPU kernel ``hpnn_tpu/ops/pallas_kernels.py``
  ``fused_linear_act`` (body ``_fused_linear_act_kernel``), which
  ``batched_forward_pallas`` composes per layer for run_nn and serving.
* **Computes** ``act(xs @ W.T)`` for W (N, M) and xs (B, M), both
  contiguous along M: float32 and bfloat16 accumulate in float32, float64
  in float64, the activation is applied once in the epilogue and the
  output is written once in the operand dtype.
* **Bound on the H100**: at the slice's shapes (784->300, 300->10,
  851->230, 230->230) the operands are at most a few MB.  At B <= 64 (the
  serving buckets) the bytes take well under a microsecond, so launch and
  memory latency set the time, and the lever is the number of SMs at work.
  At B = 4096 float32 and float64 are bound by the FMAs (784->300: 1.93
  GFLOP, 29 us at 67 TFLOP/s; float64 on the CUDA cores peaks near half
  of that) and by how evenly the tiles spread over the SMs, and bfloat16
  by the bytes against the tensor cores' rate.
* **The fixed order**: the reduction runs in stages of 32 along M (the
  last ragged); each stage's partial is an FMA chain from zero in
  ascending m (bfloat16: two tensor-core m16n8k16 MMAs from a zero
  accumulator); the partials are added from zero in ascending stage
  order; then the activation, one conversion, one store.  An output's
  bits depend on its row of xs and of W only, so the strict serving tier
  stays bit-identical to run_nn whatever the batch.
* **The plans** (:func:`_plan`, a pure function of B, N, M and the
  dtype, from crossovers measured on the H100): a small product takes
  the *direct* plan, one launch in which a block owns a small tile and all
  its stages, a warp a stage, reading its operands straight from L1/L2;
  a larger one a *staged* tile whose block walks its stages through a
  cp.async ring in shared memory, summing in registers.  Above 512 rows
  float32 and float64 take the tile that fits the card's waves (128x80
  for 300 outputs, 96x80 for 230: one block an SM, one wave).  When
  float32 or float64 staged tiles alone would leave most of the card's
  132 SMs idle, the stages are *split* over blocks: each writes its
  stages' partials un-summed to a workspace ``[S, B, N]`` and a second
  launch adds all S of them in the same order.  Every plan takes the same
  chain of adds, so every plan gives the same bits; ``chip_smoke.py``
  checks it across batch sizes.  float32 and float64 run on the CUDA
  cores (float32 stays full float32, float64 on FP64 FMAs), bfloat16 on
  the tensor cores at every batch size, rows padded to the MMA's 16.  The
  ``csrc/fused_linear_act.cu`` header has the details.

The wrapper takes the plain torch version only for tensors on the CPU; for
a CUDA tensor it launches the kernel or raises.  ``fused_linear_act.launches``
counts wrapper calls that launched the kernel (one a layer; a split plan
is two device launches), so a run can show its main path went through it.
"""

from __future__ import annotations

import ctypes
from collections import namedtuple

import torch

from .activations import ann_act, snn_softmax
from .steps import LNN, SNN

_ENTRY = {torch.float32: "hpnn_fused_linear_act_f32",
          torch.bfloat16: "hpnn_fused_linear_act_bf16",
          torch.float64: "hpnn_fused_linear_act_f64"}
_fns: dict[str, object] = {}
_INT32_MAX = 2**31 - 1
_GRID_Y_MAX = 65535

STAGE = 32            # the reduction's stage depth: fixed by the sum order
SMS = 132             # the H100 SXM's streaming multiprocessors
# output tile shapes (rows, columns) of the staged kernels, by the index
# the kernel takes: float32/float64 on the CUDA cores and bfloat16 on the
# tensor cores
SIMT_TILES = ((32, 32), (64, 64), (128, 64), (128, 80), (96, 80), (32, 16))
MMA_TILES = ((32, 32), (64, 64), (128, 64))
# float32/float64 above 512 rows: the tiles a plan fits to whole waves of
# the SMs (each runs one block an SM)
WAVE_TILES = (1, 2, 3, 4)
# blocks an SM that a split plan aims its stage groups at, by SIMT tile
SPLIT_BLOCKS = (4, 4, 1, 1, 1, 4)
DIRECT = 6            # the direct plan's index: a warp a stage, S <= 32
DIRECT_MAX_STAGES = 32
DIRECT_COLS = 8       # float32/float64 direct tile: 4 rows x 8 columns
# The direct plan wins while the layer's multiply-adds B*N*M stay under
# these (crossovers measured on the H100): its operands come from L1/L2
# once per output, so it suits a small product; bfloat16's tensor-core
# fragments reach much further.
DIRECT_MAX_MACS = {torch.float32: 4_000_000, torch.float64: 4_000_000,
                   torch.bfloat16: 110_000_000}

Plan = namedtuple("Plan", "tile bm bn stages per_group groups row_tiles "
                          "col_tiles workspace")
Plan.__doc__ = """A launch plan of :func:`fused_linear_act`: tile index
``tile`` (``bm`` x ``bn`` outputs a block; ``DIRECT``: every stage of the
tile at once, a warp a stage), ``stages`` of STAGE along M, ``per_group``
consecutive stages a block, ``groups`` blocks along the stages of one
tile; a grid of row_tiles x col_tiles x groups blocks.  ``workspace``
counts the accumulator-type elements of the stage partials (stages x B x
N when the stages are split, else 0)."""


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _plan(b: int, n: int, m: int, dtype: torch.dtype) -> Plan:
    """The launch plan for xs (b, m) @ W (n, m).T: a pure function of the
    shapes and the dtype, chosen from the H100's measured crossovers.

    * A small product takes the direct plan: one launch, every stage of a
      small tile at once.
    * bfloat16 takes a 32x32 tile up to 512 rows (and for a layer of at
      most 32 outputs), then 128x64 where those tiles fit one wave of the
      card and the reduction is long (M >= 512), else 64x64.
    * float32 and float64 up to 512 rows: 32x32 up to 64 rows (and for at
      most 32 outputs); above 256 rows 128x64 for a long reduction into a
      wide layer (M >= 512, N >= 256); else 64x64 for a long reduction at
      float64, else 32x32.
    * float32 and float64 above 512 rows are fitted to the card's waves:
      of the large tiles, the one whose tiles, at one block an SM, leave
      the least work on the busiest SM (fewest waves times outputs a
      tile); 32x16 for a layer of at most 16 outputs, 32x32 up to 32.
    * float32 and float64 split the stages into groups where the tiles
      alone would leave more than half the SMs idle, so that about
      ``SPLIT_BLOCKS`` blocks an SM run at once; a second launch then adds
      the stage partials.  bfloat16 never splits: its MMA tiles' partial
      stores measured slower than the unsplit walk at every batch."""
    stages = max(1, _cdiv(m, STAGE))   # M = 0: one empty stage, act(0)
    if stages <= DIRECT_MAX_STAGES and b * n * m <= DIRECT_MAX_MACS[dtype]:
        bm, bn = ((16, 8) if dtype == torch.bfloat16
                  else (32 // DIRECT_COLS, DIRECT_COLS))
        return Plan(DIRECT, bm, bn, stages, stages, 1, _cdiv(b, bm),
                    _cdiv(n, bn), 0)
    if dtype == torch.bfloat16:
        if n <= 32 or b <= 512:
            tile = 0
        elif _cdiv(b, 128) * _cdiv(n, 64) <= SMS and m >= 512:
            tile = 2
        else:
            tile = 1
        bm, bn = MMA_TILES[tile]
        return Plan(tile, bm, bn, stages, stages, 1, _cdiv(b, bm),
                    _cdiv(n, bn), 0)
    if b > 512 and n > 32:
        def busiest(t):
            tm, tn = SIMT_TILES[t]
            return _cdiv(_cdiv(b, tm) * _cdiv(n, tn), SMS) * tm * tn
        tile = min(WAVE_TILES, key=busiest)
    elif b > 512 and n <= 16:
        tile = 5
    elif n <= 32 or b <= 64:
        tile = 0
    elif m >= 512 and n >= 256 and b > 256:
        tile = 2
    elif m >= 512 and dtype == torch.float64:
        tile = 1
    else:
        tile = 0
    bm, bn = SIMT_TILES[tile]
    row_tiles, col_tiles = _cdiv(b, bm), _cdiv(n, bn)
    tiles = row_tiles * col_tiles
    per_group = stages
    if 2 * tiles < SMS:
        per_group = _cdiv(stages, min(stages,
                                      _cdiv(SPLIT_BLOCKS[tile] * SMS, tiles)))
    groups = _cdiv(stages, per_group)
    return Plan(tile, bm, bn, stages, per_group, groups, row_tiles,
                col_tiles, stages * b * n if groups > 1 else 0)


def _workspace(plan: Plan, dtype: torch.dtype, device) -> torch.Tensor:
    """The stage partials' buffer a launch of ``plan`` writes (float64 for
    float64 operands, else float32); empty when the stages are not
    split."""
    acc = torch.float64 if dtype == torch.float64 else torch.float32
    return torch.empty(plan.workspace, dtype=acc, device=device)


def _kernel_fn(entry: str):
    fn = _fns.get(entry)
    if fn is None:
        from . import build

        lib = build.load("fused_linear_act")
        lib.hpnn_cuda_error_string.argtypes = [ctypes.c_int]
        lib.hpnn_cuda_error_string.restype = ctypes.c_char_p
        fn = getattr(lib, entry)
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        fn.error_string = lib.hpnn_cuda_error_string
        _fns[entry] = fn
    return fn


def _check(w: torch.Tensor, xs: torch.Tensor) -> None:
    if not (isinstance(w, torch.Tensor) and isinstance(xs, torch.Tensor)):
        raise TypeError("fused_linear_act takes torch tensors")
    if w.dtype != xs.dtype:
        raise TypeError(f"fused_linear_act: w is {w.dtype} but xs is "
                        f"{xs.dtype}; cast both to one dtype")
    if xs.dtype not in _ENTRY:
        raise TypeError(f"fused_linear_act: unsupported dtype {xs.dtype} "
                        "(float32, bfloat16 or float64)")
    if w.device != xs.device:
        raise ValueError(f"fused_linear_act: w on {w.device}, xs on "
                         f"{xs.device}")
    if w.dim() != 2 or xs.dim() != 2 or w.shape[1] != xs.shape[1]:
        raise ValueError(f"fused_linear_act: need w (N, M) and xs (B, M); "
                         f"got {tuple(w.shape)} and {tuple(xs.shape)}")
    if not (w.is_contiguous() and xs.is_contiguous()):
        raise ValueError("fused_linear_act: w and xs must be contiguous")
    if max(xs.shape[0], w.shape[0], w.shape[1]) > _INT32_MAX:
        raise ValueError("fused_linear_act: dimensions must fit in int32")


def fused_linear_act_plain(w: torch.Tensor, xs: torch.Tensor,
                           act: bool = True) -> torch.Tensor:
    """The plain torch version of the kernel: bfloat16 upcast to float32,
    ``xs @ w.T``, the activation, cast back to the operand dtype."""
    compute = torch.float32 if xs.dtype == torch.bfloat16 else xs.dtype
    z = xs.to(compute) @ w.to(compute).T
    if act:
        z = ann_act(z)
    return z.to(xs.dtype)


def fused_linear_act(w: torch.Tensor, xs: torch.Tensor,
                     act: bool = True) -> torch.Tensor:
    """act(xs @ w.T): w (N, M), xs (B, M) -> (B, N) in the operand dtype.

    CPU tensors take :func:`fused_linear_act_plain`; CUDA tensors launch
    the hand-written kernel on the current stream (no synchronisation) or
    raise."""
    _check(w, xs)
    if xs.device.type == "cpu":
        return fused_linear_act_plain(w, xs, act)
    if xs.device.type != "cuda":
        raise ValueError(f"fused_linear_act: no kernel for device "
                         f"{xs.device}")
    b, m = xs.shape
    n = w.shape[0]
    out = torch.empty((b, n), dtype=xs.dtype, device=xs.device)
    if b == 0:
        return out
    plan = _plan(b, n, m, xs.dtype)
    if plan.col_tiles > _GRID_Y_MAX:
        raise ValueError(f"fused_linear_act: N={n} needs more than "
                         f"{_GRID_Y_MAX} column tiles")
    ws = _workspace(plan, xs.dtype, xs.device)
    fn = _kernel_fn(_ENTRY[xs.dtype])
    rc = fn(xs.data_ptr(), w.data_ptr(), out.data_ptr(),
            ws.data_ptr() if plan.workspace else None, b, n, m, int(act),
            plan.tile, plan.per_group, xs.device.index,
            torch.cuda.current_stream(xs.device).cuda_stream)
    if rc != 0:
        msg = fn.error_string(rc).decode()
        raise RuntimeError(f"fused_linear_act launch failed: {msg} ({rc})")
    fused_linear_act.launches += 1
    return out


fused_linear_act.launches = 0


def _forward_layers(weights, xs: torch.Tensor, kind: str, layer):
    """Whole-net forward with ``layer(w, v, act)`` per layer: hidden and
    ANN output layers activate in the layer; the SNN output layer is raw
    and takes softmax(x-1) in plain torch (as in the JAX package, where the
    softmax is XLA outside the Pallas kernel); the LNN output stays
    linear."""
    v = xs
    last = len(weights) - 1
    for i, w in enumerate(weights):
        if i == last and kind in (SNN, LNN):
            v = layer(w, v, False)
            if kind == SNN:
                v = snn_softmax(v)
        else:
            v = layer(w, v, True)
    return v


def batched_forward_fused(weights, xs: torch.Tensor,
                          kind: str) -> torch.Tensor:
    """xs (B, n_in) -> (B, n_out) with every layer product in
    :func:`fused_linear_act`."""
    return _forward_layers(weights, xs, kind, fused_linear_act)


def batched_forward_plain(weights, xs: torch.Tensor,
                          kind: str) -> torch.Tensor:
    """The same net with every layer in :func:`fused_linear_act_plain`, on
    any device: what the kernel path is checked against."""
    return _forward_layers(weights, xs, kind, fused_linear_act_plain)


# --- fused_bpm_update --------------------------------------------------------
# Source note: replaces the Pallas TPU kernel
# ``hpnn_tpu/ops/pallas_kernels.py`` ``fused_bpm_update`` (body
# ``_fused_bpm_kernel``), the reference's one-layer momentum step.  It
# computes step = dw + (lr*d[i])*h[j]; W' = W + step; dw' = alpha*step in
# the Pallas body's association, at float64, float32 and bfloat16 (each
# operation rounded to bfloat16, as the Pallas body in interpret mode and
# PyTorch's bfloat16 operations round).  Bound on the H100 by device memory
# (4 flops against 4 values moved a weight).  A thread owns a vector of
# consecutive columns of one row, 16-byte loads and streaming stores where
# the row pitch allows, on the grid :func:`fused_bpm_plan` picks
# (``csrc/fused_bpm_update.cu``).  Like the JAX package, no training route
# calls it: the epoch kernels fuse this step.

_BPM_ENTRY = {torch.float64: "hpnn_fused_bpm_update_f64",
              torch.float32: "hpnn_fused_bpm_update_f32",
              torch.bfloat16: "hpnn_fused_bpm_update_bf16"}
_bpm_fns: dict[torch.dtype, object] = {}
BPM_THREADS = 256       # threads a block

BpmPlan = namedtuple("BpmPlan", "vec tx ty gx gy")
BpmPlan.__doc__ = """A launch plan of :func:`fused_bpm_update`: ``vec``
columns a thread (16 bytes, or 1), blocks of ``tx`` column vectors by
``ty`` rows, a grid of ``gx`` x ``gy`` blocks; a thread walks its rows with
a stride of ``gy * ty`` (one row unless the rows outgrow the grid)."""


def fused_bpm_plan(n: int, m: int, itemsize: int,
                   aligned: bool = True) -> BpmPlan:
    """The launch plan for an (n, m) update at ``itemsize`` bytes a value:
    a pure function of its arguments.

    * 16-byte vectors (8 bfloat16, 4 float32, 2 float64) when every
      pointer is 16-byte aligned (``aligned``) and the row pitch
      ``m * itemsize`` is a multiple of 16, else one column a thread.
    * A block spans up to 256 threads of column vectors (a multiple of 32,
      the columns shared evenly over the fewest such blocks) and as many
      rows as fill its 256 threads.
    * A thread a row, up to the grid's 65535 row blocks (measured on the
      H100: a thread a row beat one wave of blocks walking many rows)."""
    vec = 16 // itemsize if aligned and (m * itemsize) % 16 == 0 else 1
    cols = _cdiv(m, vec)
    # as few column blocks as 256 threads allow, shared out evenly
    tx = _cdiv(_cdiv(cols, _cdiv(cols, BPM_THREADS)), 32) * 32
    ty = BPM_THREADS // tx
    return BpmPlan(vec, tx, ty, _cdiv(cols, tx),
                   max(1, min(_cdiv(n, ty), _GRID_Y_MAX)))


def _bpm_lib():
    from . import build

    lib = build.load("fused_bpm_update")
    if not _bpm_fns:
        p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        lib.hpnn_bpm_error_string.argtypes = [i]
        lib.hpnn_bpm_error_string.restype = ctypes.c_char_p
        lib.hpnn_bpm_empty.argtypes = [i, p]
        lib.hpnn_bpm_empty.restype = i
        for dtype, name in _BPM_ENTRY.items():
            fn = getattr(lib, name)
            fn.argtypes = [p, p, p, p, p, p, i, i, d, d, i, i, i, i, i, i, p]
            fn.restype = i
            _bpm_fns[dtype] = fn
    return lib


def _check_bpm(w, dw, d, h) -> None:
    if not all(isinstance(v, torch.Tensor) for v in (w, dw, d, h)):
        raise TypeError("fused_bpm_update takes torch tensors")
    if w.dtype not in _BPM_ENTRY or any(v.dtype != w.dtype
                                        for v in (dw, d, h)):
        raise TypeError(f"fused_bpm_update: w, dw, d and h must share one "
                        f"dtype of float64, float32 or bfloat16; got "
                        f"{w.dtype}, {dw.dtype}, {d.dtype}, {h.dtype}")
    if any(v.device != w.device for v in (dw, d, h)):
        raise ValueError("fused_bpm_update: all tensors on one device")
    if w.dim() != 2 or dw.shape != w.shape or d.shape != (w.shape[0],) \
            or h.shape != (w.shape[1],):
        raise ValueError(f"fused_bpm_update: need w, dw (N, M), d (N,), h "
                         f"(M,); got {tuple(w.shape)}, {tuple(dw.shape)}, "
                         f"{tuple(d.shape)}, {tuple(h.shape)}")
    if not all(v.is_contiguous() for v in (w, dw, d, h)):
        raise ValueError("fused_bpm_update: tensors must be contiguous")
    if max(w.shape) > _INT32_MAX:
        raise ValueError("fused_bpm_update: dimensions must fit in int32")


def _bf16_scalar(x) -> torch.Tensor:
    """A Python scalar rounded to bfloat16 (through float32), as a 0-d
    tensor: the JAX package's weak-typed scalar meets a bfloat16 array as
    a bfloat16 constant, where PyTorch would compute with it in float32."""
    return torch.tensor(float(x), dtype=torch.float32).to(torch.bfloat16)


def fused_bpm_update_plain(w, dw, d, h, lr, alpha):
    """The plain torch version: step = dw + (lr*d)[:, None] * h; returns
    (w + step, alpha * step).  At bfloat16 lr and alpha are rounded to
    bfloat16 first and every operation rounds its result to bfloat16 (the
    Pallas body in interpret mode rounds at the same points)."""
    if w.dtype == torch.bfloat16:
        lr, alpha = (_bf16_scalar(v).to(w.device) for v in (lr, alpha))
    step = dw + (lr * d)[:, None] * h[None, :]
    return w + step, alpha * step


def fused_bpm_update(w, dw, d, h, lr, alpha):
    """One BPM update of a layer: w, dw (N, M); d (N,); h (M,).  Returns
    (w', dw') and leaves the inputs untouched.

    CPU tensors take :func:`fused_bpm_update_plain`; CUDA tensors launch
    the hand-written kernel on the current stream (no synchronisation) or
    raise.  The plan launched is left in ``fused_bpm_update.plan``."""
    _check_bpm(w, dw, d, h)
    if w.device.type == "cpu":
        return fused_bpm_update_plain(w, dw, d, h, lr, alpha)
    if w.device.type != "cuda":
        raise ValueError(f"fused_bpm_update: no kernel for device "
                         f"{w.device}")
    w_out, dw_out = torch.empty_like(w), torch.empty_like(dw)
    _bpm_lib()
    fn = _bpm_fns[w.dtype]
    ptrs = (w.data_ptr(), dw.data_ptr(), h.data_ptr(), w_out.data_ptr(),
            dw_out.data_ptr())
    n, m = w.shape
    plan = fused_bpm_plan(n, m, w.element_size(),
                          aligned=all(p % 16 == 0 for p in ptrs))
    if w.dtype == torch.bfloat16:
        lr, alpha = (float(_bf16_scalar(v)) for v in (lr, alpha))
    rc = fn(w.data_ptr(), dw.data_ptr(), d.data_ptr(), h.data_ptr(),
            w_out.data_ptr(), dw_out.data_ptr(), n, m, float(lr),
            float(alpha), *plan, w.device.index,
            torch.cuda.current_stream(w.device).cuda_stream)
    if rc != 0:
        msg = _bpm_lib().hpnn_bpm_error_string(rc).decode()
        raise RuntimeError(f"fused_bpm_update launch failed: {msg} ({rc})")
    fused_bpm_update.launches += 1
    fused_bpm_update.plan = plan
    return w_out, dw_out


fused_bpm_update.launches = 0
fused_bpm_update.plan = None


def empty_launch(device) -> None:
    """Launch an empty kernel on ``device``'s current stream: the floor a
    launch of :func:`fused_bpm_update` cannot go below (timed beside it)."""
    dev = torch.device(device)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    rc = _bpm_lib().hpnn_bpm_empty(
        index, torch.cuda.current_stream(index).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"empty kernel launch failed ({rc})")
