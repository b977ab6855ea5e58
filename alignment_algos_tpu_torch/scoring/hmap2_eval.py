"""HMAP2 evaluator (hmap2_eval.{h,cpp}): the HMAP profile-profile functional
form scored against a structure (SMAP) template, parameterized by Gn2Params.
Identical similarity/gap math to HMAPaliEval (position-specific affine gaps
from pre_calculate'd template gap values; z-normalized, zero-shifted sim)."""

from __future__ import annotations

from ..seq.hmap import HMAPSequence
from ..structure.smap import SMAPSequence
from .base import DPCosts
from .gn2_eval import Gn2Params
from .hmap_eval import HMAPaliEval


class Hmap2Eval(HMAPaliEval):
    def __init__(self, params: Gn2Params) -> None:
        super().__init__(params)

    def build_costs(self, query: HMAPSequence, templ: SMAPSequence) -> DPCosts:
        return super().build_costs(query, templ)
