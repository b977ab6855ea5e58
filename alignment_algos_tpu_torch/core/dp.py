"""DP matrix orchestration (DPMatrix in dpmatrix.h) on PyTorch + CUDA.

A copy of ``alignment_algos_tpu/core/dp.py`` whose builds run on the
port's engines.  ``DPMatrix._build`` routes as the reference's does
(core/dp.py:105-137):

1. constant-affine whole-matrix forward builds: the host fast path
   :mod:`..ops.dp_affine`, when H's magnitude also stays in its exact
   range (:func:`_affine_h_exact`; the reference checks only the costs);
2. rectangles with a side of ``AUTO_MIN_SIZE`` or more, or every build under
   the ``torch`` backend: K7 through :mod:`..ops.dp_engine`, on the device
   that ``AAT_TORCH_DEVICE`` names;
3. smaller rectangles, or every build under the ``numpy`` backend: the host
   oracle :mod:`..ops.dp_ref`.

``AAT_DP_BACKEND`` (``auto`` by default, ``torch`` or ``numpy``) picks the
backend, as it does for the JAX package (where the device backend is called
``jax``).  ``reevaluate`` rebuilds the cost model and runs the engine again,
the cheap-rebuild path of gn2's iterative rounds (dpmatrix.h:213-218).
:func:`build` runs one build of a cost model on K7 or on ``dp_ref``, outside
any ``DPMatrix``.
"""

from __future__ import annotations

import os

import numpy as np

from ..ops import dp_affine, dp_engine, dp_ref
from ..scoring.base import DPCosts
from ..utils.params import AlignT
from ..utils.torchenv import device_from_env

FWD = "fwd"
REV = "rev"
BACKENDS = ("torch", "numpy", "auto")
AUTO_MIN_SIZE = 40   # the reference's _AUTO_MIN_SIZE

_backend = os.environ.get("AAT_DP_BACKEND", "auto")


def set_backend(name: str) -> None:
    """Select the DP backend for every later build in this process."""
    global _backend
    if name not in BACKENDS:
        raise ValueError(f"DP backend {name!r}: expected one of {BACKENDS}")
    _backend = name


def _use_device(rows: int, cols: int) -> bool:
    if _backend not in BACKENDS:
        raise ValueError(f"AAT_DP_BACKEND={_backend!r}: expected one of "
                         f"{BACKENDS}")
    if _backend != "auto":
        return _backend == "torch"
    return max(rows, cols) >= AUTO_MIN_SIZE


def _affine_h_exact(c: DPCosts, gi: float, ge: float) -> bool:
    """Whether ``dp_affine`` stays exact on ``c`` once its own gate passed.

    That gate bounds max|S| + max(|gi|, |ge|)(Q + T) but not H, which
    reaches max|S| min(Q, T); past 2^24 the reassociated sums round apart
    from ``dp_ref``'s (a fault of the reference's gate, shown in
    tests/test_torch_dp_engine.py).  The same tiers bound H's magnitude
    too: 2^22 for integer costs, 2^14 for multiples of 1/256."""
    s = float(np.abs(c.S).max()) if c.S.size else 0.0
    bound = (s * min(c.q_size, c.t_size)
             + max(abs(float(gi)), abs(float(ge))) * (c.q_size + c.t_size))
    integer = (gi == round(gi) and ge == round(ge)
               and bool(np.all(c.S == np.round(c.S))))
    return bound < (2 ** 22 if integer else 2 ** 14)


def build(c, q0: int, q1: int, t0: int, t1: int, direction: str = FWD,
          local: bool = False, bug_compat: bool = True, *,
          device=None) -> dp_ref.DPResult:
    """One build of the cost model ``c`` over the rectangle (q0, q1, t0,
    t1): K7 through :mod:`..ops.dp_engine` on ``device``, or the host
    oracle ``dp_ref`` where ``device`` is None."""
    if device is None:
        if direction == FWD:
            return dp_ref.build_forward(c, q0, q1, t0, t1, local=local)
        return dp_ref.build_reverse(c, q0, q1, t0, t1, local=local,
                                    bug_compat=bug_compat)
    if direction == FWD:
        return dp_engine.build_forward(c, q0, q1, t0, t1, local,
                                       device=device)
    return dp_engine.build_reverse(c, q0, q1, t0, t1, local, bug_compat,
                                   device=device)


class DPMatrix:
    def __init__(self, query_seq, templ_seq, evaluator, direction: str = FWD,
                 align_type: AlignT = AlignT.GLOBAL,
                 sub_bounds: tuple[int, int, int, int] | None = None,
                 bug_compat: bool = True) -> None:
        self.query_seq = query_seq
        self.templ_seq = templ_seq
        self.evaluator = evaluator
        self.direction = direction
        self.align_type = AlignT(align_type)
        self.islocal = self.align_type == AlignT.LOCAL
        self.sub_bounds = sub_bounds  # (q1_end, t1_end, q2_beg, t2_beg)
        self.bug_compat = bug_compat
        self.costs: DPCosts | None = None
        self.res: dp_ref.DPResult | None = None
        self._build()

    # --- reference-compatible accessors -----------------------------------
    def get_query_size(self) -> int:
        return self.query_seq.size()

    def get_template_size(self) -> int:
        return self.templ_seq.size()

    def get_cell(self, i: int, j: int) -> tuple[float, int, int]:
        """(score, prev_query_idx, prev_template_idx)."""
        return (float(self.res.H[i, j]), int(self.res.PQ[i, j]),
                int(self.res.PT[i, j]))

    def score(self, i: int, j: int) -> float:
        return float(self.res.H[i, j])

    def prev(self, i: int, j: int) -> tuple[int, int]:
        return int(self.res.PQ[i, j]), int(self.res.PT[i, j])

    def get_sim(self, i: int, j: int) -> float:
        return float(self.costs.S[i, j])

    def deletion(self, q1: int, q2: int, t1: int, t2: int) -> float:
        return self.costs.deletion(q1, q2, t1, t2)

    def insertion(self, q1: int, q2: int, t1: int, t2: int) -> float:
        return self.costs.insertion(q1, q2, t1, t2)

    def set_evaluator(self, evaluator, direction: str) -> None:
        self.evaluator = evaluator
        self.direction = direction
        self.reevaluate()

    def reevaluate(self) -> None:
        self._build()

    # ----------------------------------------------------------------------
    def _build(self) -> None:
        self.costs = self.evaluator.build_costs(self.query_seq,
                                                self.templ_seq)
        c = self.costs
        if self.sub_bounds is not None:
            q0, t0, q1, t1 = self.sub_bounds
        else:
            q0, t0, q1, t1 = 0, 0, c.q_size - 1, c.t_size - 1

        if self.direction == FWD and self.sub_bounds is None:
            aff = dp_affine.affine_consts(c)
            if aff is not None and _affine_h_exact(c, *aff):
                self.res = dp_affine.build_forward_affine(
                    c, q0, q1, t0, t1, aff[0], aff[1], local=self.islocal)
                return

        device = (device_from_env() if _use_device(q1 - q0 + 1, t1 - t0 + 1)
                  else None)
        self.res = build(c, q0, q1, t0, t1, self.direction, self.islocal,
                         self.bug_compat, device=device)

    def dump_matrix(self) -> str:
        """operator<< on DPMatrix (dpmatrix.h:116-129): tab-separated scores."""
        lines = []
        for i in range(self.get_query_size()):
            lines.append("\t".join(_fmt_g6(v) for v in self.res.H[i]) + "\t")
        return "\n".join(lines) + "\n"


def _fmt_g6(v: float) -> str:
    """C++ ostream default formatting (6 significant digits, %g-style)."""
    s = f"{float(v):.6g}"
    return s
