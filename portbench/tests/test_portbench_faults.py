"""A whole run of the harness on the program's CPU route at a toy size:
sound it comes out correct; the control (the program's own float32 path
in place of the configuration's float64) and each fault the cell can have,
planted under the timed path and acting on the window's epochs alone,
come out not correct.  The card's look is skipped: the run is told to use
the CPU.  One card, so there is no exchange between chips to leave out."""

import pytest

from toy import run, toy_cell
from pb import faults


def _sound(tmp_path, **kw):
    return run(toy_cell(str(tmp_path / "cache"), **kw))


@pytest.mark.parametrize("train,rows", [("BP", 1), ("BPM", 2)])
def test_portbench_sound_run_is_correct(tmp_path, train, rows):
    r = _sound(tmp_path, train=train, rows=rows)
    assert r["correct"], r["check"]
    assert r["window"]["epochs"] >= 3
    assert r["check"]["epoch_w_gap"]["value"] <= 1e-12
    assert r["check"]["unreplayed"]["value"] == 0
    assert r["attempted"] == 8 * r["window"]["epochs"] and r["failed"] == 0
    assert list(r)[-1] == "check"


def test_portbench_control_float32_fails(tmp_path):
    r = run(toy_cell(str(tmp_path / "cache")), dtype="f32")
    assert not r["correct"]
    assert r["check"]["row_mismatch"]["value"] > 0


@pytest.mark.parametrize("fault", sorted(faults.EPOCH_FAULTS))
@pytest.mark.parametrize("train", ["BP", "BPM"])
def test_portbench_fault_fails(tmp_path, fault, train):
    """The set-up's steps run sound (``w_gap`` and their rows read as a
    sound run's); the window's epochs carry the fault."""
    with faults.planted(fault):
        r = run(toy_cell(str(tmp_path / "cache"), train=train))
    assert not r["correct"], r["check"]
    assert r["check"]["w_gap"]["value"] <= 1e-12


def test_portbench_fault_order_fails(tmp_path):
    """Every epoch of the window trained in another order than the conf's
    seed gives: ``order_errors`` reads it."""
    with faults.planted("order"):
        r = run(toy_cell(str(tmp_path / "cache")))
    assert not r["correct"]
    assert r["check"]["order_errors"]["value"] > 0
