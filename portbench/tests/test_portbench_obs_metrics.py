"""The readers of the program's own counters and spans (B1's phase
cycles, the card's gap between epochs, the join's render, the kernel
file's parse) on hand-built contexts: their formulas, and None where the
program recorded nothing, as a program without the counter or span
records nothing."""

import types

import pytest

from toy import spec


def _read(name, **epoch_metrics):
    ctx = types.SimpleNamespace(epoch_metrics=epoch_metrics)
    return spec.load_module("metrics", name).read(ctx)


CYCLES = {"barrier": 600, "head": 250, "rows": 100, "other": 50}


@pytest.mark.parametrize("name,phase", [("b1_barrier_pct", "barrier"),
                                        ("b1_head_pct", "head")])
def test_portbench_b1_phase_shares(name, phase):
    assert _read(name, b1_cycles=CYCLES) == pytest.approx(
        100.0 * CYCLES[phase] / 1000)
    assert _read(name, b1_cycles={**CYCLES, phase: 0}) == 0.0
    assert _read(name) is None
    assert _read(name, b1_cycles={}) is None
    assert _read(name, b1_cycles=dict.fromkeys(CYCLES, 0)) is None


def test_portbench_b1_phase_shares_sum_with_the_rest():
    rest = (CYCLES["rows"] + CYCLES["other"]) / 10
    assert _read("b1_barrier_pct", b1_cycles=CYCLES) \
        + _read("b1_head_pct", b1_cycles=CYCLES) + rest == pytest.approx(100)


def test_portbench_epoch_boundary_us():
    assert _read("epoch_boundary_us", boundary_ms=[0.004, 0.006, 0.011]) \
        == pytest.approx(7.0)
    assert _read("epoch_boundary_us") is None
    assert _read("epoch_boundary_us", boundary_ms=[]) is None


def test_portbench_join_render_s():
    assert _read("join_render_s", render_s=0.41) == 0.41
    assert _read("join_render_s") is None
    assert _read("join_render_s", render_s=0.0) is None


@pytest.fixture
def ring():
    from hpnn_tpu_torch.obs import trace

    trace.disable()
    trace.enable(capacity=16)
    yield trace
    trace.disable()


def test_portbench_kernel_parse_s_reads_the_span(ring):
    ring.record("configure", 10.0, 13.0)
    ring.record("kernel_parse", 11.0, 12.25)
    assert _read("kernel_parse_s") == 1.25


def test_portbench_kernel_parse_s_none_without_the_span(ring):
    ring.record("configure", 10.0, 13.0)
    assert _read("kernel_parse_s") is None
    # evicted from a full ring
    ring.record("kernel_parse", 11.0, 12.0)
    for i in range(16):
        ring.record(f"later{i}", 14.0, 15.0)
    assert _read("kernel_parse_s") is None


def test_portbench_kernel_parse_s_none_with_tracing_off():
    from hpnn_tpu_torch.obs import trace

    trace.disable()
    assert _read("kernel_parse_s") is None
