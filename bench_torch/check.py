"""Readings that the limits of ``correct`` are set from, in one process.

    python3 -m bench_torch.check --workload <cell> --seeds 1,2,... [--control-seeds 7,8,9] [--seconds 1]

For each of ``--seeds`` it runs the cell's set-up, a short window of the
timed path at the cell's own size and the cell's comparison, and prints
the numbers compared (the program's readings, the lower end of each
limit). For each of ``--control-seeds`` it prints the driver's control
readings: the reference computed in the precision below the configured
one (fp8 for bf16) against the fp32 reference, and each planted fault the
driver knows (the upper end). The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys

from bench_torch import common
from bench_torch.run import Run, load_benchmark, require_cards, set_cache_dirs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--seconds", type=float, default=1.0)
    args = parser.parse_args(argv)
    set_cache_dirs()
    bench = load_benchmark()
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    for seed in seeds:
        run = Run(args.workload, seed, args.seconds, False, bench)
        require_cards(run.chips)
        driver = importlib.import_module(f"bench_torch.drivers.{run.workload['driver']}")
        state = driver.setup(run)
        obs = driver.window(run, state)
        compared, attempted, failed = driver.check(run, state)
        values = {k: v["value"] for k, v in compared.items()}
        print(json.dumps({"seed": seed, "kind": "program", "readings": values, "attempted": attempted,
                          "failed": failed, "end_to_end": obs["end_to_end"]}), flush=True)
        del state
        common.free_card()
    for seed in controls:
        run = Run(args.workload, seed, args.seconds, False, bench)
        driver = importlib.import_module(f"bench_torch.drivers.{run.workload['driver']}")
        for kind, values in driver.control(run).items():
            print(json.dumps({"seed": seed, "kind": kind, "readings": values}), flush=True)
        common.free_card()
    return 0


if __name__ == "__main__":
    sys.exit(main())
