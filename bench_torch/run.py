"""Run one cell of ``BENCHMARK.json`` once and print one JSON line.

    python3 -m bench_torch.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell's file ``bench_torch/workloads/<cell>.json``
names its configuration, traffic mix, driver and the limits of its
comparison. The run warms up every shape the cell uses (set-up), measures
for ``--seconds``, with ``--trace 1`` also profiles a fixed slice after the
window, then frees the program and compares what the timed path produced
with the plain fp32 reference. It exits 1 without printing a result when
the machine has no card or fewer cards than the cell asks for.
"""

from __future__ import annotations

import time

T_START = time.time()  # process start, as near as Python gets: setup_s counts from here

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class NoCard(RuntimeError):
    """The machine lacks the cards the cell asks for."""


class Run:
    """One run of one cell: its arguments, its files and what it observed."""

    def __init__(self, workload: str, seed: int, seconds: float, trace: bool, bench: Optional[dict] = None,
                 device: str = "cuda", overrides: Optional[dict] = None):
        self.name = workload
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.workload = load_json("workloads", workload)
        self.config = load_json("configs", self.workload["config"])
        self.traffic = dict(load_json("traffic", self.workload["traffic"]))
        self.traffic.update(overrides or {})
        self.limits: Dict[str, float] = self.workload["limits"]
        self.bench = bench if bench is not None else load_benchmark()
        entry = [w for w in self.bench.get("workloads", []) if w["name"] == workload]
        self.chips = int(entry[0]["chips"]) if entry else 1
        self.t_start = T_START
        self.t_window = None  # time.time() at the first timed unit
        self.stderr = sys.stderr

    def log(self, msg: str) -> None:
        print(f"[bench_torch] {msg}", file=self.stderr, flush=True)

    def mark(self, what: str) -> None:
        """Log how far into the process ``what`` was reached (set-up's parts)."""
        self.log(f"{time.time() - self.t_start:.2f} s: {what}")


def load_json(kind: str, name: str) -> dict:
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} {name!r}: {path} is missing")
    with open(path) as f:
        return json.load(f)


def load_benchmark() -> dict:
    path = ROOT / "BENCHMARK.json"
    with open(path) as f:
        return json.load(f)


def cell_metrics(bench: dict, cell: str, kind: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics that this cell reports:
    those that list it, and those with no ``workloads`` key."""
    return [m for m in bench.get(kind, []) if cell in m.get("workloads", [cell])]


def read_metric(name: str, obs: dict) -> Optional[float]:
    """The per-layer metric ``name`` by its reader ``metrics/<name>.py``;
    None where the reader finds nothing to read."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_torch.metrics.{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(obs)


def require_cards(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise NoCard("no CUDA device: the benchmark measures the card and never falls back to the CPU")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell asks for {chips} cards, the machine has {torch.cuda.device_count()}")


def set_cache_dirs() -> None:
    """Kernel and bytecode caches at fixed paths inside the checkout (the
    program's own nvcc cache is ``build/fit_tpu_torch/``, fixed in its
    code). Python's bytecode goes there too, before torch is imported:
    where the interpreter cannot write beside its packages, each run would
    otherwise compile some 1,900 modules again (about 8 s on the card's
    host)."""
    cache = ROOT / "build" / "bench_torch" / "cache"
    sys.pycache_prefix = str(cache / "pycache")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")


def execute(run: Run) -> dict:
    """Set-up, window, traced slice and comparison of one run; the result
    line as a dict."""
    import torch

    driver = importlib.import_module(f"bench_torch.drivers.{run.workload['driver']}")
    run.mark("imports done")
    state = driver.setup(run)
    run.mark("set-up done")
    obs = driver.window(run, state)
    if run.t_window is None:
        raise RuntimeError("the driver never opened its window")
    e2e = dict(obs.pop("end_to_end"))
    e2e["setup_s"] = run.t_window - run.t_start
    if run.trace:
        obs["trace"] = driver.traced_slice(run, state, obs)
    on_card = run.device == "cuda"
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    compared, attempted, failed = driver.check(run, state)
    correct = failed == 0 and all(c["value"] <= c["limit"] for c in compared.values())

    if run.trace:
        tr = obs["trace"]
        wanted = cell_metrics(run.bench, run.name, "per_layer")
        metrics = {}
        for m in wanted:
            value = read_metric(m["name"], obs)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        extra = {"busy_s": tr.busy_s, "window_s": tr.window_s}
        breakdown = {"device_ops": tr.top_device_ops(), "idle_gaps": tr.idle_gaps()}
    else:
        wanted = cell_metrics(run.bench, run.name, "end_to_end")
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]} for m in wanted if m["name"] in e2e}
        extra, breakdown = {}, None
    device = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
        "count": run.chips,
        "memory_peak_bytes": int(peak),
        **extra,
    }
    line = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed), "metrics": metrics,
            "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["compared"] = compared
    for name, c in compared.items():
        run.log(f"compared {name}: {c['value']!r} (limit {c['limit']!r})")
    return line


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--rate", type=float, default=None,
                        help="serving cells: offer this many requests a second instead of the cell's rate (the knee sweep)")
    args = parser.parse_args(argv)
    set_cache_dirs()
    try:
        bench = load_benchmark()
        overrides = {"rate": args.rate} if args.rate is not None else None
        run = Run(args.workload, args.seed, args.seconds, bool(args.trace), bench, overrides=overrides)
        require_cards(run.chips)
    except (NoCard, FileNotFoundError, ModuleNotFoundError) as exc:
        print(f"[bench_torch] {exc}", file=sys.stderr)
        return 1
    line = execute(run)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
