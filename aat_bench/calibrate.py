"""Readings that the limits of ``correct`` are set from, on the card at the
cell's own size: the program's compared numbers on many seeds, and the
control's (the reference computed in the precision below the one the
configuration states, in the program's place) on a few.

    python -m aat_bench.calibrate --workload <cell> --seeds 11,12,...
        --control-seeds 21,22,23

For each seed it writes the inputs, runs one screen of each query a run's
check would sample, and compares them as a run does (the entry's
``check``): with the program's screens for a program seed, with the
entry's ``Control`` in the program's place for a control seed.  One JSON
line per seed, with the cards it ran on: as a run does, it cuts
``CUDA_VISIBLE_DEVICES`` to the cell's ``chips`` before torch is imported
and refuses with fewer.  The benchmark's runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

from aat_bench import cards
from aat_bench import cell as cells
from aat_bench import screening


def readings(c: cells.Cell, seed: int, device,
             control: bool, config: dict | None = None,
             traffic: dict | None = None,
             bench_dir: str = cells.BENCH_DIR) -> dict:
    config = config or c.config
    traffic = traffic or c.traffic
    workdir = tempfile.mkdtemp(prefix="aat_bench_")
    try:
        gen = cells.load_module("generators", config["generator"], bench_dir)
        inputs = gen.make(config, seed, workdir)
        entry = cells.load_module("entries", traffic["entry"], bench_dir)
        kind = entry.Control if control else entry.Session
        session = kind(config, traffic, inputs, cells.ROOT, device)
        every = [(i, 0, "") for i in range(len(session.queries))]
        picked = {q for q, _, _ in screening.sample(
            every, session.query, traffic["check"]["sample"], seed)}
        outputs = []
        for i in range(len(session.queries)):
            if session.query(i) in picked:
                rc, out = session.screen(i)
                outputs.append((i, rc, out))
        session.release()
        got = {n: float(v) for n, v, _ in entry.check(session, outputs, seed,
                                                       device)}
        return {"seed": seed, "kind": "control" if control else "program",
                "readings": got}
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m aat_bench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    args = p.parse_args(argv)
    c = cells.find(cells.load_bench(), args.workload)
    cards.narrow(c.chips)
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < c.chips:
        print(f"{c.name} needs {c.chips} card(s); {have} visible",
              file=sys.stderr)
        return 2
    os.environ["AAT_TORCH_DEVICE"] = "cuda"
    on = [{"index": i, "kind": torch.cuda.get_device_name(i)}
          for i in range(c.chips)]
    dev = torch.device("cuda", 0)
    for seeds, control in ((args.seeds, False), (args.control_seeds, True)):
        for s in filter(None, seeds.split(",")):
            print(json.dumps({"workload": c.name, "cards": on,
                              **readings(c, int(s), dev, control)}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
