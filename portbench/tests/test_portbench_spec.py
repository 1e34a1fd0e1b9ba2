"""Every name in BENCHMARK.json finds its file, and the file is what the
harness reads."""

import os
import re

import pytest

from toy import BENCH, spec

BENCHMARK = spec.load_json(os.path.join(os.path.dirname(BENCH),
                                        "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("w", BENCHMARK["workloads"], ids=lambda w: w["name"])
def test_portbench_cell_files_found(w):
    cell = spec.cell(w["name"], BENCHMARK)
    assert cell.config["name"] == w["config"]
    assert cell.traffic["name"] == w["traffic"]
    spec.load_module("corpora", cell.config["corpus"]["generator"]).generate
    spec.load_module("roofline", cell.traffic["kernel"]).work
    for key in ("warmup_rows", "replay_first_iterations",
                "replay_last_epochs", "replay_epoch_iterations"):
        assert int(cell.check[key]) > 0
    assert set(cell.config["check"]["limits"]) == {
        "order_errors", "row_mismatch", "err_gap", "w_gap", "epoch_w_gap",
        "unreplayed"}
    assert cell.end_to_end and cell.per_layer


@pytest.mark.parametrize("c", BENCHMARK["configs"], ids=lambda c: c["name"])
def test_portbench_config_files(c):
    cfg = spec.load_json(os.path.join(os.path.dirname(BENCH), c["file"]))
    assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
    assert cfg["reduced"] == c["reduced"]
    assert cfg["type"] == "ANN" and cfg["dtype"] == "f64"


@pytest.mark.parametrize("m", BENCHMARK["per_layer"], ids=lambda m: m["name"])
def test_portbench_metric_readers(m):
    assert callable(spec.load_module("metrics", m["name"]).read)
    cells = {w["name"] for w in BENCHMARK["workloads"]}
    assert set(m["workloads"]) <= cells
    assert m["moves"] in {e["name"] for e in BENCHMARK["end_to_end"]}


def test_portbench_names_and_bounds():
    names = ([c["name"] for c in BENCHMARK["configs"]]
             + [w["name"] for w in BENCHMARK["workloads"]]
             + [m["name"] for m in BENCHMARK["end_to_end"]
                + BENCHMARK["per_layer"]])
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    for m in BENCHMARK["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in BENCHMARK["end_to_end"]}
    assert BENCHMARK["paths"] == ["portbench"]
    assert 1 <= BENCHMARK["run_seconds"] <= 51
    assert all(w["chips"] == 1 for w in BENCHMARK["workloads"])
