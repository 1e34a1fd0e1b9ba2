"""The launch plan of the port's ``fused_linear_act`` (``ops/kernels.py``
``_plan``), on the CPU.

The CUDA kernel runs only on the card, where ``chip_smoke.py`` holds every
plan bit for bit against every other (its batch-invariance phase).  What
the CPU can check is the plan itself: that the blocks it launches cover
every (row tile, column tile, stage) exactly once, that every plan keeps
the stage of 32 the fixed summation order is built on, that the workspace
the wrapper allocates is the one the kernel indexes, and that the plan
depends on (B, N, M, dtype) and nothing else.
"""

import itertools

import pytest
import torch

from hpnn_tpu_torch.ops import kernels as K

# (N, M): the main path's layers (784->300, 300->10, 851->230, 230->230)
# and a ragged one no tile divides
LAYERS = [(300, 784), (10, 300), (230, 851), (230, 230), (13, 37)]
BATCHES = [1, 3, 64, 512, 4096, 10000]
DTYPES = [torch.float32, torch.bfloat16, torch.float64]
CASES = list(itertools.product(LAYERS, BATCHES, DTYPES))
IDS = [f"{m}to{n}-B{b}-{str(d).split('.')[1]}" for (n, m), b, d in CASES]


def _cdiv(a, b):
    return -(-a // b)


def _blocks(plan):
    """(row tile, column tile, stage) of every stage every block of the
    plan's grid walks: block z of a tile takes stages [z*G, (z+1)*G)."""
    for x in range(plan.row_tiles):
        for y in range(plan.col_tiles):
            for z in range(plan.groups):
                lo = z * plan.per_group
                for s in range(lo, min(plan.stages, lo + plan.per_group)):
                    yield x, y, s


@pytest.mark.parametrize("layer,b,dtype", CASES, ids=IDS)
def test_plan_covers_every_tile_and_stage_once(layer, b, dtype):
    n, m = layer
    plan = K._plan(b, n, m, dtype)
    assert K.STAGE == 32
    assert plan.stages == max(1, _cdiv(m, 32))
    if plan.tile == K.DIRECT:
        # every stage of a tile in one block, a warp a stage
        assert plan.groups == 1 and plan.stages <= K.DIRECT_MAX_STAGES
        assert (plan.bm, plan.bn) == ((16, 8) if dtype == torch.bfloat16
                                      else (32 // plan.bn, plan.bn))
    else:
        tiles = K.MMA_TILES if dtype == torch.bfloat16 else K.SIMT_TILES
        assert (plan.bm, plan.bn) == tiles[plan.tile]
    # the tiles cover the output, with no tile wholly outside it
    assert plan.row_tiles == _cdiv(b, plan.bm)
    assert plan.col_tiles == _cdiv(n, plan.bn)
    # every group holds at least one stage, and the groups cover them all
    assert 1 <= plan.per_group <= plan.stages
    assert plan.groups == _cdiv(plan.stages, plan.per_group)
    assert (plan.groups - 1) * plan.per_group < plan.stages
    seen = list(_blocks(plan))
    assert len(seen) == len(set(seen))
    assert set(seen) == set(itertools.product(range(plan.row_tiles),
                                              range(plan.col_tiles),
                                              range(plan.stages)))
    # bfloat16 runs on 16x8 MMA tiles at every batch size
    if dtype == torch.bfloat16:
        assert plan.bm % 16 == 0 and plan.bn % 8 == 0


@pytest.mark.parametrize("layer,b,dtype", CASES, ids=IDS)
def test_workspace_matches_what_the_kernel_indexes(layer, b, dtype):
    n, m = layer
    plan = K._plan(b, n, m, dtype)
    ws = K._workspace(plan, dtype, "cpu")
    acc = torch.float64 if dtype == torch.float64 else torch.float32
    assert ws.dtype == acc
    if plan.groups > 1:
        # the kernel writes stage s, row r, column c at (s*B + r)*N + c
        assert ws.numel() == plan.workspace == plan.stages * b * n
        last = ((plan.stages - 1) * b + (b - 1)) * n + (n - 1)
        assert last == ws.numel() - 1
    else:
        assert ws.numel() == plan.workspace == 0


def test_plan_is_a_pure_function_of_its_arguments():
    first = {c: K._plan(c[1], c[0][0], c[0][1], c[2]) for c in CASES}
    # the same arguments again, in another order, after other calls
    for c in reversed(CASES):
        again = K._plan(c[1], c[0][0], c[0][1], c[2])
        assert again == first[c]
        assert all(isinstance(v, int) for v in again)


def test_only_plans_that_leave_the_card_idle_split():
    """A float32 or float64 staged plan splits its stages only where its
    tiles alone would leave more than half the SMs idle, into about as
    many groups as put the tile's ``SPLIT_BLOCKS`` blocks on every SM;
    every other plan, the direct one and every bfloat16 plan included,
    walks all of a tile's stages in one block and needs no workspace."""
    for (n, m), b, dtype in CASES:
        plan = K._plan(b, n, m, dtype)
        tiles = plan.row_tiles * plan.col_tiles
        if (plan.tile == K.DIRECT or 2 * tiles >= K.SMS
                or dtype == torch.bfloat16):
            assert plan.groups == 1 and plan.workspace == 0
        else:
            assert plan.groups > 1
            target = K.SPLIT_BLOCKS[plan.tile] * K.SMS
            assert tiles * plan.groups >= K.SMS or plan.per_group == 1
            assert tiles * (plan.groups - 1) < target


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("b", [513, 1000, 4096, 10000])
@pytest.mark.parametrize("layer", [(300, 784), (230, 851), (230, 230),
                                   (100, 500)])
def test_large_batches_fit_their_tiles_to_the_waves(layer, b, dtype):
    """Above 512 rows a float32 or float64 plan takes, of the large tiles,
    the one that leaves the least work on the busiest SM at one block an
    SM: the fewest waves of the card times the outputs of a tile."""
    n, m = layer
    plan = K._plan(b, n, m, dtype)
    assert plan.tile in K.WAVE_TILES

    def busiest(tile):
        bm, bn = K.SIMT_TILES[tile]
        waves = _cdiv(_cdiv(b, bm) * _cdiv(n, bn), K.SMS)
        return waves * bm * bn

    assert busiest(plan.tile) == min(busiest(t) for t in K.WAVE_TILES)


def test_main_path_layers_fill_one_wave_at_4096_rows():
    """At B=4096 the main path's float32/float64 layers of 300 and 230
    outputs run their tiles in one wave of the SMs (128x80 and 96x80
    tiles, the fastest plans measured on the H100), and the 10-output
    layer takes the narrow 32x16 tile."""
    for dtype in (torch.float32, torch.float64):
        for n, m, shape in ((300, 784, (128, 80)), (230, 851, (96, 80)),
                            (230, 230, (96, 80))):
            plan = K._plan(4096, n, m, dtype)
            assert (plan.bm, plan.bn) == shape and plan.groups == 1
            assert plan.row_tiles * plan.col_tiles <= K.SMS
        plan = K._plan(4096, 10, 300, dtype)
        assert (plan.bm, plan.bn) == (32, 16) and plan.groups == 1


def test_serving_buckets_run_their_stages_at_once():
    """The strict serving tier's buckets (powers of two up to 64 rows) at
    the MNIST input layer do not walk 25 stages in series on a handful of
    blocks: either the stages are split across blocks that fill the card,
    or the direct plan runs every stage of a tile at once."""
    for b in (1, 2, 4, 8, 16, 32, 64):
        for dtype in DTYPES:
            plan = K._plan(b, 300, 784, dtype)
            if plan.tile == K.DIRECT:
                assert plan.per_group == plan.stages
            else:
                assert plan.groups > 1
                assert plan.row_tiles * plan.col_tiles * plan.groups >= K.SMS
