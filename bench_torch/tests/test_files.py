"""Every cell of ``BENCHMARK.json`` is found by name in files of its own,
and nothing of the benchmark imports the JAX package."""

from __future__ import annotations

import importlib
import re
from pathlib import Path

import pytest

from bench_torch.run import HERE, ROOT, cell_metrics, load_benchmark, load_json, read_metric

BENCH = load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_a_cell_names_files_that_exist(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    wl = load_json("workloads", cell)
    assert wl["config"] == entry["config"] and wl["traffic"] == entry["traffic"]
    load_json("configs", wl["config"])
    load_json("traffic", wl["traffic"])
    driver = importlib.import_module(f"bench_torch.drivers.{wl['driver']}")
    for fn in ("setup", "window", "traced_slice", "check", "control"):
        assert callable(getattr(driver, fn))
    assert wl["limits"] and all(v > 0 for v in wl["limits"].values())
    e2e = {m["name"] for m in cell_metrics(BENCH, cell, "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = cell_metrics(BENCH, cell, "per_layer")
    assert layer and {m["moves"] for m in layer} <= e2e


@pytest.mark.parametrize("name", [m["name"] for m in BENCH["per_layer"]])
def test_a_metric_has_a_reader_that_stays_silent_on_nothing(name):
    assert (HERE / "metrics" / f"{name}.py").is_file()
    assert read_metric(name, {}) is None


def test_configs_and_paths_are_the_benchmarks_own():
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("bench_torch/")
    assert BENCH["paths"] == ["bench_torch"]


def test_nothing_imports_the_jax_package():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|fit_tpu)\b", re.M)
    for path in Path(HERE).rglob("*.py"):
        assert not pattern.search(path.read_text()), path
