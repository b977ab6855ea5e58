"""Run one benchmark cell on the card and print its result.

    python -m aat_bench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout.  The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device`` and, traced, ``breakdown``; the numbers the
reference check compared, each beside its limit, come last there
(``checks``) and as the last lines of standard error.

Before torch is imported, ``CUDA_VISIBLE_DEVICES`` is cut to the cell's
``chips`` cards (``cards.narrow``).  Without a visible card, or with fewer
than the cell asks for, the run exits with 2 before it measures anything;
if the window used fewer cards than the cell asks for (the program fell
back to fewer), it exits with 2 after it and prints no result.  If the
measured process has loaded jax, jaxlib, flax or the JAX package, it exits
with 3 and prints no result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from aat_bench import cards  # noqa: E402
from aat_bench import cell as cells  # noqa: E402


def _environment() -> None:
    """One thread a math library: the host work of a screen is one thread
    of Python and numpy, and idle worker threads that spin beside it made
    runs of one seed spread by 20% on a shared host."""
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"


def parse(argv=None):
    p = argparse.ArgumentParser(prog="python -m aat_bench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def report(result: dict) -> None:
    for name, c in result["checks"].items():
        print(f"check {name}: {float(c['value'])!r} "
              f"(limit {float(c['limit'])!r})",
              file=sys.stderr)
    print(json.dumps(result))


def main(argv=None) -> int:
    args = parse(argv)
    _environment()
    c = cells.find(cells.load_bench(), args.workload)
    cards.narrow(c.chips)
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < c.chips:
        print(f"{args.workload} needs {c.chips} card(s); "
              f"{have} visible: no result", file=sys.stderr)
        return 2
    os.environ["AAT_TORCH_DEVICE"] = "cuda"
    from aat_bench import harness
    try:
        result = harness.run_cell(c, args.seed, args.seconds,
                                  bool(args.trace),
                                  [torch.device("cuda", i)
                                   for i in range(c.chips)], T0)
    except harness.ForbiddenModules as e:
        print(f"{e}: no result", file=sys.stderr)
        return 3
    used = result["device"]["count"]
    if used < c.chips:
        how = "device work" if args.trace else "allocations"
        print(f"{args.workload} asks for {c.chips} card(s); the window used "
              f"{used} (counted by the {how} on each card): no result",
              file=sys.stderr)
        return 2
    report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
