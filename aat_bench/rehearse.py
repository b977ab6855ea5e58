"""Rehearse one cell on the CPU at a small size, with the kernels' plain
versions: the same set-up, window, spans and reference check as a card
run, at the sizes the configuration's generator gives for a rehearsal.

    AAT_TORCH_DEVICE=cpu python -m aat_bench.rehearse --workload <cell>
        --seed <n> --seconds <s> --trace <0|1>

It prints the compared numbers and whether they pass, and no metric: a
CPU run measures nothing of the card.
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch

from aat_bench import cell as cells
from aat_bench import harness
from aat_bench.run import parse


def rehearse(workload: str, seed: int, seconds: float, traced: bool,
             root: str = cells.ROOT, bench_dir: str = cells.BENCH_DIR,
             control: bool = False) -> dict:
    os.environ["AAT_TORCH_DEVICE"] = "cpu"
    c = cells.find(cells.load_bench(root), workload, root, bench_dir)
    gen = cells.load_module("generators", c.config["generator"], bench_dir)
    config, traffic = gen.small(c.config, c.traffic)
    result = harness.run_cell(c, seed, seconds, traced,
                              [torch.device("cpu")], time.perf_counter(),
                              root=root,
                              bench_dir=bench_dir, config=config,
                              traffic=traffic, control=control)
    return {"rehearsal": "cpu", "correct": result["correct"],
            "attempted": result["attempted"], "failed": result["failed"],
            "metrics_read": sorted(result["metrics"]),
            "checks": result["checks"]}


def main(argv=None) -> int:
    args = parse(argv)
    print(json.dumps(rehearse(args.workload, args.seed, args.seconds,
                              bool(args.trace))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
