"""DP matrix orchestration on PyTorch + CUDA (counterpart of
``alignment_algos_tpu/core/dp.py``).

The port's :class:`DPMatrix` is the reference class with one method
replaced, ``_build``, which routes the build as the reference does
(core/dp.py:105-137):

1. constant-affine whole-matrix forward builds: the shared host fast path
   ``dp_affine``;
2. rectangles with a side of ``AUTO_MIN_SIZE`` or more, or every build under
   the ``torch`` backend: K7 through :mod:`..ops.dp_engine`, on the device
   that ``AAT_TORCH_DEVICE`` names;
3. smaller rectangles, or every build under the ``numpy`` backend: the
   shared host oracle ``dp_ref``.

``AAT_DP_BACKEND`` (``auto`` by default, ``torch`` or ``numpy``) picks the
backend, as it does for the JAX package (where the device backend is
called ``jax``).  Constructor, accessors and ``reevaluate`` (gn2's
per-round rebuild) are the reference's.  :func:`build` runs one build of
a cost model on K7 or on ``dp_ref``, outside any ``DPMatrix``.
"""

from __future__ import annotations

import os

from alignment_algos_tpu.core import dp as _ref
from alignment_algos_tpu.ops import dp_affine, dp_ref

from ..ops import dp_engine
from ..utils.torchenv import device_from_env

FWD = _ref.FWD
REV = _ref.REV
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


class DPMatrix(_ref.DPMatrix):
    """``core.dp.DPMatrix`` whose device builds run on K7."""

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
            if aff is not None:
                self.res = dp_affine.build_forward_affine(
                    c, q0, q1, t0, t1, aff[0], aff[1], local=self.islocal)
                return

        device = (device_from_env() if _use_device(q1 - q0 + 1, t1 - t0 + 1)
                  else None)
        self.res = build(c, q0, q1, t0, t1, self.direction, self.islocal,
                         self.bug_compat, device=device)
