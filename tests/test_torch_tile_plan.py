"""The launch plan of the tile kernel (``train_tile``), on the CPU.

``ops.convergence_tile_kernel.tile_plan`` is a pure function of the layer
shapes, the tile, the types' sizes and the card's limits; the CUDA kernel
(``csrc/train_tile.cu``) takes what it returns.  At the H100's limits (132
SMs, 232,448 shared bytes a block) for MNIST 784-300-10, XRD 851-230-230,
784-2304-10 (more rows than the card holds warps) and 784-4096-10 (whose
block scratch does not fit on chip at tile 512) x tiles 1, 8, 32, 128 and
512 x every entry point's types x BP and BPM:

* every row of every layer has exactly one owner (row i: block i mod
  blocks, slot i // blocks, within the slots the plan sizes);
* the shared-memory regions fit, do not overlap and are 16-byte aligned,
  at least one lane's input is on chip, and the block's scratch is on
  chip whole unless it and one lane's input do not fit, then whole in
  the block's workspace slice;
* the grid is no larger than the card's SMs (one block an SM).

Only an input layer too wide for one lane's input is refused (the
wrapper raises ValueError); wide hidden layers launch at every tile the
autotuner tries; and ``train_tile(..., _plan=...)`` on CPU tensors gives
the plain version's bits and launches nothing.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from hpnn_tpu_torch.ops import autotune
from hpnn_tpu_torch.ops import convergence_tile as ct
from hpnn_tpu_torch.ops import convergence_tile_kernel as ctk
from hpnn_tpu_torch.ops.convergence_tile import (_accum_dtype,
                                                 storage_wdtype,
                                                 train_epoch_tiled_plain)

SMS, SMEM = ctk.H100
TOPOLOGIES = {"mnist": ((300, 784), (10, 300)),
              "xrd": ((230, 851), (230, 230)),
              "wide": ((2304, 784), (10, 2304)),
              "wide4096": ((4096, 784), (10, 4096))}
TILES = (1, 8, 32, 128, 512)
SAMPLES = 1024   # the autotuner's probe corpus at tile 512


def _sizes(key):
    """Bytes of the activation, resident weight and add types of an entry
    point's (activation dtype, weight dtype, add dtype) key."""
    adt, wdt, add = key
    at = 4 if adt == torch.bfloat16 else adt.itemsize
    return at, wdt.itemsize, (add or wdt).itemsize


def _region_sizes(plan, shapes, at, wb, ab, momentum):
    """What csrc/train_tile.cu carves for each region."""
    n_in, n_out = shapes[0][1], shapes[-1][0]
    n1 = shapes[1][0] if len(shapes) > 1 else 0
    lanes, r0 = plan.lanes, plan.rows[0]
    return {"state_at": 5 * lanes * at, "state_int": (8 * lanes + 1) * 4,
            "dd": lanes * plan.rp * at,
            "own": r0 * lanes * at if len(shapes) > 1 else 0,
            "col": r0 * n1 * at, "ho": lanes * n_out * at,
            "hdl": lanes * n_out * at, "t": lanes * n_out * at,
            "w0": r0 * n_in * wb, "x": plan.x_lanes * n_in * at,
            "dw0": r0 * n_in * ab if momentum else 0}


@pytest.mark.parametrize("momentum", (False, True), ids=("BP", "BPM"))
@pytest.mark.parametrize("key", list(ctk._ENTRY),
                         ids=lambda k: ctk._ENTRY[k][len("hpnn_train_tile_"):])
@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("topo", list(TOPOLOGIES))
def test_plan_owns_every_row_once_and_fits(topo, tile, key, momentum):
    shapes = TOPOLOGIES[topo]
    at, wb, ab = _sizes(key)
    plan = ctk.tile_plan(shapes, SAMPLES, tile, at, wb, ab, momentum,
                         SMS, SMEM)
    assert not plan.refused
    assert 1 <= plan.blocks <= SMS
    assert plan.warps * 32 <= ctk.MAX_THREADS
    assert plan.lanes == min(tile, SAMPLES)
    assert 1 <= plan.x_lanes <= plan.lanes
    # every row of every layer: one owner, in a slot the plan sizes
    for (n, _), slots in zip(shapes, plan.rows):
        owners = {}
        for i in range(n):
            block, slot = i % plan.blocks, i // plan.blocks
            assert slot < slots
            owners.setdefault(block, []).append(i)
        assert sorted(i for rows in owners.values() for i in rows) \
            == list(range(n))
        assert max(len(rows) for rows in owners.values()) == slots
    assert plan.rp % 4 == 0 and plan.rp >= max(plan.rows)
    # the regions on chip fit beside the kernel's static shared memory,
    # do not overlap and are aligned
    chip = dict(zip(ctk.REGIONS, plan.on_chip))
    offs = dict(zip(ctk.REGIONS, plan.offsets))
    sizes = _region_sizes(plan, shapes, at, wb, ab, momentum)
    assert chip["x"]
    scratch = [chip[k] for k in ctk.SCRATCH]
    assert all(scratch) or not any(scratch)
    if not chip["dd"]:
        # off chip only where the scratch and one lane's input do not fit
        need = sum(ctk._align(sizes[k]) for k in ctk.SCRATCH)
        assert need + ctk._align(shapes[0][1] * at) > SMEM - ctk.STATIC_SMEM
    spans = sorted((offs[k], offs[k] + sizes[k]) for k in ctk.REGIONS
                   if chip[k] and sizes[k])
    assert all(lo % 16 == 0 for lo, _ in spans)
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert spans[-1][1] <= plan.smem_bytes \
        <= SMEM - ctk.STATIC_SMEM
    # what is not on chip: the scratch and the head's vectors in the
    # block's workspace slice, the targets and W_0's and dw_0's rows in
    # place
    ws = sorted((offs[k], offs[k] + sizes[k])
                for k in (*ctk.SCRATCH, "ho", "hdl") if not chip[k])
    assert all(lo % 16 == 0 for lo, _ in ws)
    assert all(a[1] <= b[0] for a, b in zip(ws, ws[1:]))
    assert (ws[-1][1] if ws else 0) <= plan.ws_bytes
    if tile <= 32 and topo in ("mnist", "xrd"):
        assert chip["ho"] and chip["hdl"] and chip["t"] and chip["w0"]
    if topo != "wide4096" or tile <= 128:
        assert chip["dd"]


@pytest.mark.parametrize("topo", ("mnist", "xrd", "wide"))
def test_plan_at_phase_widths(topo):
    """The plans chip_smoke.py's main runs launch: the group's inputs and
    W_0's rows on chip (MNIST at tile 32 and f64 just fits)."""
    tile = {"mnist": 32, "xrd": 4, "wide": 8}[topo]
    plan = ctk.tile_plan(TOPOLOGIES[topo], 512, tile, 8, 8, 8, False)
    chip = dict(zip(ctk.REGIONS, plan.on_chip))
    assert plan.blocks == SMS and plan.x_lanes == plan.lanes == tile
    assert chip["w0"] and chip["ho"] and chip["hdl"] and chip["t"]
    assert plan.rows[0] == {"mnist": 3, "xrd": 2, "wide": 18}[topo]


@pytest.mark.parametrize("force, field, want", [
    ({"resident": False}, "w0", False),
    ({"head": False}, "ho", False),
    ({"x_lanes": 3}, "x_lanes", 3),
    ({"x_lanes": 1, "head": False}, "x_lanes", 1),
    ({"scratch": False}, "dd", False)])
def test_forced_plan(force, field, want):
    plan = ctk.tile_plan(TOPOLOGIES["mnist"], 19, 8, 8, 8, 8, True,
                         force=force)
    got = (dict(zip(ctk.REGIONS, plan.on_chip))[field]
           if field in ctk.REGIONS else getattr(plan, field))
    assert got == want
    with pytest.raises(ValueError, match="unknown plan keys"):
        ctk.tile_plan(TOPOLOGIES["mnist"], 19, 8, 8, 8, 8, True,
                      force={"warps": 4})


@pytest.mark.parametrize("at, n_in", [(8, 30000), (4, 60000), (8, 1 << 15)])
def test_too_wide_is_refused(at, n_in):
    """One lane's input must fit in a block's shared memory; wider is
    refused."""
    plan = ctk.tile_plan(((10, n_in), (10, 10)), 19, 8, at, at, at, False)
    assert plan.refused and plan.smem_bytes > SMEM - ctk.STATIC_SMEM


@pytest.mark.parametrize("dtype, storage", [(torch.float64, None),
                                            (torch.float32, "bf16"),
                                            (torch.bfloat16, None)])
def test_too_wide_raises_value_error(dtype, storage):
    """What the wrapper launches for CUDA tensors, at the H100's limits: a
    30000-wide input layer at float64 (and 60000 at float32) is refused
    with ValueError, MNIST is not."""
    n_in = 30000 if dtype == torch.float64 else 60000
    w = (torch.zeros(10, n_in, dtype=dtype), torch.zeros(10, 10, dtype=dtype))
    xs = torch.zeros(4, n_in, dtype=dtype)
    with pytest.raises(ValueError, match="more than the card has"):
        ctk.launch_plan(w, xs, 8, storage, False, ctk.H100)
    w = (torch.zeros(300, 784, dtype=dtype), torch.zeros(10, 300, dtype=dtype))
    plan = ctk.launch_plan(w, torch.zeros(4, 784, dtype=dtype), 8, storage,
                           True, ctk.H100)
    assert not plan.refused and plan.lanes == 4


@pytest.mark.parametrize("force", [{"resident": False}, {"x_lanes": 2},
                                   {"head": False, "resident": False},
                                   {"scratch": False}])
@pytest.mark.parametrize("kind, momentum", [("ANN", False), ("SNN", True),
                                            ("LNN", False)])
def test_forced_plan_on_cpu_tensors_is_the_plain_version(kind, momentum,
                                                         force):
    rng = np.random.default_rng(11)
    w = (torch.tensor(rng.uniform(-0.3, 0.3, (6, 12))),
         torch.tensor(rng.uniform(-0.3, 0.3, (4, 6))))
    xs = torch.tensor(rng.uniform(0, 1, (7, 12)))
    ts = -torch.ones(7, 4, dtype=torch.float64)
    ts[np.arange(7), rng.integers(0, 4, 7)] = 1.0
    before = ctk.train_tile.launches
    wk, sk = ctk.train_tile(w, xs, ts, kind, momentum, tile=3,
                            max_iter=40, _plan=force)
    wp, sp = train_epoch_tiled_plain(w, xs, ts, kind, momentum, tile=3,
                                     max_iter=40)
    assert ctk.train_tile.launches == before
    assert all(torch.equal(a, b) for a, b in zip(wk, wp))
    assert torch.equal(sk, sp)


WIDE_HIDDEN = {"784-2800-10": ((2800, 784), (10, 2800)),
               "784-4096-10": ((4096, 784), (10, 4096)),
               "784-4096-4096-10": ((4096, 784), (4096, 4096),
                                    (10, 4096))}


@pytest.mark.parametrize("dtype, storage", [(torch.float64, None),
                                            (torch.float64, "f32"),
                                            (torch.float32, None),
                                            (torch.bfloat16, "bf16")])
@pytest.mark.parametrize("topo", list(WIDE_HIDDEN))
def test_wide_hidden_layers_launch_at_every_autotuner_tile(topo, dtype,
                                                           storage):
    """Wide hidden layers are never refused: at every tile ``--tile auto``
    tries, the plan launches, with the block's scratch in its workspace
    slice where it does not fit on chip (784-4096-10 at tile 512 and
    float64)."""
    shapes = WIDE_HIDDEN[topo]
    w = tuple(torch.zeros(n, m, dtype=dtype) for n, m in shapes)
    xs = torch.zeros(2 * max(autotune._DEFAULT_TILES), shapes[0][1],
                     dtype=dtype)
    for tile in autotune._DEFAULT_TILES:
        for momentum in (False, True):
            plan = ctk.launch_plan(w, xs, tile, storage, momentum, ctk.H100)
            assert not plan.refused and plan.lanes == tile
            chip = dict(zip(ctk.REGIONS, plan.on_chip))
            assert chip["x"] and plan.smem_bytes <= SMEM - ctk.STATIC_SMEM
            if not chip["dd"]:
                assert plan.ws_bytes > 0
    plan = ctk.launch_plan(w, xs, 512, storage, False, ctk.H100)
    if topo != "784-2800-10" and dtype == torch.float64:
        assert not dict(zip(ctk.REGIONS, plan.on_chip))["dd"]


def test_autotuner_candidates_survive_wide_hidden_layers(monkeypatch):
    """The autotuner's probe at 784-4096-10 float64 reaches every candidate
    tile: each gets a launch plan from the wrapper at the H100's limits
    (the epoch itself stands in, on the CPU, for the launch)."""
    seen = []

    def epoch(weights, xs, ts, kind, momentum, tile, storage, max_iter):
        seen.append(ctk.launch_plan(weights, xs, tile, storage, momentum,
                                    ctk.H100))
        return weights, SimpleNamespace(n_iter=torch.full(
            (xs.shape[0],), max_iter, dtype=torch.int32))

    monkeypatch.setattr(ct, "train_epoch_tiled", epoch)
    shapes = WIDE_HIDDEN["784-4096-10"]
    dec = autotune._measure_tile(shapes, torch.float64, "ANN", False, "cpu",
                                 autotune._DEFAULT_TILES, (None, "bf16"),
                                 "kernel")
    assert set(dec["cells"]) == {f"tile{t}-native-kernel"
                                 for t in autotune._DEFAULT_TILES}
    assert [p.lanes for p in seen] == [t for t in autotune._DEFAULT_TILES
                                       for _ in range(2)]
    assert not dict(zip(ctk.REGIONS, seen[-1].on_chip))["dd"]


def test_entry_keys_match_the_storage_rule():
    """Every entry point's key is the (activations, resident weights, add)
    triple the wrapper derives from a dtype and a storage mode."""
    keys = {(dt, storage_wdtype(dt, st), _accum_dtype(st))
            for dt in (torch.float64, torch.float32, torch.bfloat16)
            for st in (None, "bf16", "f32")
            if not (dt == torch.float64 and st == "bf16")
            and not (dt == torch.bfloat16 and st == "f32")}
    assert keys == set(ctk._ENTRY)
