"""BENCHMARK.json and every file it names: the contract's shape, and the
configuration files against the system's own parameter counts."""
import json
import math
import re

import pytest

from bench import harness as H
from bench.work import counts

BM = H.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E = {m["name"]: m for m in BM["end_to_end"]}
CELLS = [w["name"] for w in BM["workloads"]]


def test_top_level_keys():
    assert set(BM) == {"command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"}
    assert BM["command"][:2] == ["python3", "bench/run.py"]
    assert BM["paths"] == ["bench"]
    assert 1 <= BM["run_seconds"] <= 51
    # the full check, at 24 cells, fits its 43200 s
    assert (2 + 14 * 24) * (BM["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert len(json.dumps(BM)) < 64 * 1024


def test_names_units_and_keys():
    names = []
    for c in BM["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.append(c["name"])
    for w in BM["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
    for m in BM["end_to_end"] + BM["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BM["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    all_names = names + CELLS + [m["name"] for m in BM["end_to_end"]
                                 + BM["per_layer"]]
    assert all(NAME.match(n) for n in all_names)
    assert len(set(CELLS)) == len(CELLS)
    assert len({(w["config"], w["traffic"]) for w in BM["workloads"]}) \
        == len(CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_parse(cell):
    spec = H.cell_spec(cell)
    assert spec["traffic"]["entry"] in ("agg", "train")
    assert (H.BENCH / "entries" / f"{spec['traffic']['entry']}.py").exists()
    assert spec["cell"]["limits"]
    e2e, per_layer = H.metrics_for(cell, BM)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and per_layer


def test_every_metric_moves_what_its_cells_report():
    for m in BM["per_layer"]:
        assert m["moves"] in E2E
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS
            assert cell in E2E[m["moves"]].get("workloads", CELLS)
        assert (H.BENCH / "metrics" / f"{m['name']}.py").exists()


@pytest.mark.parametrize("config", [c["name"] for c in BM["configs"]])
def test_config_counts_match_the_system(config):
    from repro_torch.models.model import param_shapes
    c = {x["name"]: x for x in BM["configs"]}[config]
    model = H.load_json(H.ROOT / c["file"])
    assert c["reduced"] == model["reduced"]
    shapes = [s for _, s in H.flatten(param_shapes(H.port_config(model)))]
    n = sum(math.prod(s) for s in shapes)
    assert (n, len(shapes)) == (model["params"], model["leaves"])
    assert counts.param_leaves(model) == (n, len(shapes))
