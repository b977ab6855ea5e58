"""What the ``aat_screen`` entries share: calling the CLI in process with
the argv a user passes, and choosing the screens the reference checks."""

from __future__ import annotations

import contextlib
import importlib
import io

import numpy as np

PROGRAM = "alignment_algos_tpu_torch.cli.screen"


def call(argv: list) -> tuple[int, str]:
    """``aat_screen``'s ``main(argv)`` in this process: (exit code,
    stdout)."""
    main = importlib.import_module(PROGRAM).main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(list(argv))
    return int(rc or 0), buf.getvalue()


class Session:
    """One cell's screens: the i-th screen runs query ``queries[i % n]``
    with ``args`` after the query and library paths; subclasses set
    ``args`` and ``work``."""

    args: list = []

    def __init__(self, cfg: dict, traffic: dict, inputs: dict, root: str,
                 device):
        self.cfg, self.traffic, self.inputs = cfg, traffic, inputs
        self.device = device
        self.queries = list(traffic["queries"])

    def query(self, i: int) -> int:
        return self.queries[i % len(self.queries)]

    def argv(self, i: int) -> list:
        return [self.inputs["queries"][self.query(i)],
                self.inputs["library"]] + self.args

    def screen(self, i: int) -> tuple[int, str]:
        return call(self.argv(i))

    def work(self, i: int) -> dict:
        raise NotImplementedError

    def warmup_index(self) -> int:
        """The longest query's screen: it holds the largest buffers."""
        return int(np.argmax(self.queries))

    def release(self) -> None:
        """Nothing of the program outlives a screen here."""


def repeat_mismatch(outputs: list, query_of) -> int:
    """Completed screens whose stdout differs from the first completed
    screen of the same query (the program is deterministic)."""
    first, bad = {}, 0
    for i, rc, out in outputs:
        if rc != 0:
            continue
        q = query_of(i)
        if q not in first:
            first[q] = out
        elif out != first[q]:
            bad += 1
    return bad


def sample(outputs: list, query_of, k: int, seed: int) -> list:
    """Up to k completed screens of distinct queries: the one of the
    longest query, then others drawn from the seed."""
    seen = {}
    for i, rc, out in outputs:
        if rc == 0 and query_of(i) not in seen:
            seen[query_of(i)] = (i, out)
    if not seen:
        return []
    qs = sorted(seen)
    rest = qs[:-1]
    rng = np.random.default_rng(seed)
    pick = [qs[-1]] + [rest[j] for j in sorted(
        rng.choice(len(rest), min(k - 1, len(rest)), replace=False))]
    return [(q,) + seen[q] for q in pick]


def hit_rows(out: str) -> list:
    """The ranked hits of a screen's stdout: [(rank, score, index, name)]."""
    rows = []
    for line in out.splitlines():
        parts = line.split("\t")
        if len(parts) == 4 and parts[0].isdigit():
            rows.append((int(parts[0]), float(parts[1]), int(parts[2]),
                         parts[3]))
    return rows


def render(hits: list, names: list) -> str:
    """Ranked hits [(index, score)] as the screen prints them."""
    return "".join(f"{r}\t{s:g}\t{i}\t{names[i]}\n"
                   for r, (i, s) in enumerate(hits, start=1))
