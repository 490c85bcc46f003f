"""Every cell of BENCHMARK.json finds its parts by name, and the file
keeps the contract's shape: each per-layer metric's cells report the
end-to-end metric it moves."""
import json
import re

import bench_tiny
from bench import check, spec

BENCH = json.loads((bench_tiny.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_cell_resolves_its_files():
    for w in BENCH["workloads"]:
        cell = spec.resolve(w["name"])
        assert cell.config["name"] == w["config"]
        assert set(cell.config["reduced"]) == set(
            next(c for c in BENCH["configs"] if c["name"] == w["config"])["reduced"])
        spec.driver(cell.traffic["engine"])
        spec.reference(cell.config["reference"])
        assert cell.limits and set(cell.limits) <= set(check.NAMES)
        for m in cell.per_layer:
            assert callable(spec.metric_reader(m["name"]).read)
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer


def test_metrics_move_what_their_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for c in m.get("workloads", cells):
            assert c in cells
            assert "workloads" not in moved or c in moved["workloads"], (m["name"], c)


def test_names_and_keys_keep_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = ([c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    for m in BENCH["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert len((bench_tiny.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
