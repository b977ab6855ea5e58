"""The port's general-gap DP builds with tracebacks (K7's plain version,
through ``ops/dp_engine``) against the JAX package's ``dp_engine`` (the XLA
scan on the CPU) and the numpy ``dp_ref`` engine, on the same cost models.
Tolerance 0 everywhere: H, PQ and PT are compared with
``np.testing.assert_array_equal``.  Shapes stay at 16 or fewer so that the
XLA compiles stay cheap.  The port gets each cost model as its own
``DPCosts`` over the same arrays (:func:`port_costs`)."""

import dataclasses

import numpy as np
import pytest
import torch

from alignment_algos_tpu.ops import dp_engine as jde
from alignment_algos_tpu.ops import dp_ref
from alignment_algos_tpu.scoring.base import DPCosts
from alignment_algos_tpu.utils.params import AlignT
from alignment_algos_tpu_torch.ops import dp_engine
from alignment_algos_tpu_torch.scoring import base as tbase
from alignment_algos_tpu_torch.utils import params as tparams

from util import random_costs

CPU = torch.device("cpu")


def port_costs(c):
    """The JAX package's cost model ``c`` as the port's ``DPCosts`` over
    the same arrays."""
    kw = {f.name: getattr(c, f.name) for f in dataclasses.fields(c)}
    if kw["del_align"] is not None:
        kw["del_align"] = tparams.AlignT(kw["del_align"])
    return tbase.DPCosts(**kw)

# tests/test_dp_engine.py's CASES: (q2, t2, align_type, zero_flags, local)
CASES = [
    (8, 9, AlignT.GLOBAL, False, False),
    (9, 7, AlignT.SEMI_LOCAL, True, False),
    (10, 10, AlignT.GLOBAL, False, True),
    (14, 11, AlignT.GLOBAL_LOCAL, True, False),
    (7, 13, AlignT.LOCAL, True, True),
]


def assert_same(*results):
    for r in results[1:]:
        np.testing.assert_array_equal(r.H, results[0].H)
        np.testing.assert_array_equal(r.PQ, results[0].PQ)
        np.testing.assert_array_equal(r.PT, results[0].PT)


def check_forward(c, q0, q1, t0, t1, local):
    got = dp_engine.build_forward(port_costs(c), q0, q1, t0, t1, local,
                                  device=CPU)
    assert got.H.dtype == np.float32 and got.PQ.dtype == np.int32
    assert_same(got, jde.build_forward_jax(c, q0, q1, t0, t1, local=local),
                dp_ref.build_forward(c, q0, q1, t0, t1, local=local))
    return got


@pytest.mark.parametrize("q2,t2,atype,zf,local", CASES)
def test_forward_matches_jax_and_dp_ref(q2, t2, atype, zf, local):
    rng = np.random.default_rng(q2 * 100 + t2)
    check_forward(random_costs(rng, q2, t2, atype, zf), 0, q2 - 1, 0,
                  t2 - 1, local)


@pytest.mark.parametrize("bounds", [(2, 3, 10, 12), (1, 1, 14, 13),
                                    (4, 2, 7, 9)])
def test_subrectangles(bounds):
    """build_subdpm rectangles (q0, t0, q1, t1), as tests/test_dp_engine.py
    and the SSSS loop fills use them."""
    q0, t0, q1, t1 = bounds
    c = random_costs(np.random.default_rng(0), 16, 15, AlignT.GLOBAL, False)
    check_forward(c, q0, q1, t0, t1, False)


@pytest.mark.parametrize("bug_compat", [True, False])
def test_reverse_matches_jax_and_dp_ref(bug_compat):
    """The closing-cell insertion winner of the reverse build records t1-1
    under bug_compat (dpmatrix.h:868); a large similarity at (5, 1) makes
    an insertion win there."""
    c = random_costs(np.random.default_rng(5), 10, 10, AlignT.GLOBAL, False)
    c.S[5, 1] += np.float32(200.0)
    got = dp_engine.build_reverse(port_costs(c), 0, 9, 0, 9, False,
                                  bug_compat, device=CPU)
    assert_same(got, jde.build_reverse_jax(c, 0, 9, 0, 9,
                                           bug_compat=bug_compat),
                dp_ref.build_reverse(c, 0, 9, 0, 9, bug_compat=bug_compat))
    assert got.PQ[0, 0] == 5
    assert got.PT[0, 0] == (8 if bug_compat else 1)


@pytest.mark.parametrize("q2,t2,atype,zf,local", CASES[1:4])
def test_reverse_cases(q2, t2, atype, zf, local):
    rng = np.random.default_rng(q2 * 7 + t2)
    c = random_costs(rng, q2, t2, atype, zf)
    got = dp_engine.build_reverse(port_costs(c), 0, q2 - 1, 0, t2 - 1,
                                  local, device=CPU)
    assert_same(got, jde.build_reverse_jax(c, 0, q2 - 1, 0, t2 - 1,
                                           local=local),
                dp_ref.build_reverse(c, 0, q2 - 1, 0, t2 - 1, local=local))


def test_batched_matches_jax():
    rng = np.random.default_rng(9)
    costs = [random_costs(rng, 12, 11, AlignT.SEMI_LOCAL, True)
             for _ in range(3)]
    got = dp_engine.build_forward_batched([port_costs(c) for c in costs],
                                          device=CPU)
    want = jde.build_forward_jax_batched(costs)
    assert len(got) == 3
    for g, w, c in zip(got, want, costs):
        assert_same(g, w, dp_ref.build_forward(c, 0, 11, 0, 10))


def _collapsed_deletion_ties(c, res, local):
    """Interior cells whose deletion candidates differ before the add of
    the similarity and tie after it (the first of them is the
    traceback)."""
    q2, t2 = c.S.shape
    n = 0
    for i in range(2, q2 - 1):
        for j in range(3, t2 - 1):
            x = res.H[i - 1, 1:j - 1] - c.D[1:j - 1, j]
            v = x + c.S[i, j]
            if local:
                v = np.maximum(np.float32(0.0), v)
            top = v == v.max()
            n += int(top.sum() > 1 and np.unique(x[top]).size > 1)
    return n


@pytest.mark.parametrize("local", [False, True])
def test_trap_argmax_after_add_and_clamp(local):
    """|S| near 1e8, where an ulp exceeds the cost differences: candidates
    that differ before the add round to one value after it, and the first
    of them must win (not the larger before the add).  In local mode most
    candidates clamp to zero and the first k among the zeros wins."""
    rng = np.random.default_rng(17)
    c = random_costs(rng, 14, 13, AlignT.GLOBAL, False)
    if local:
        c.S[1:-1, 1:-1] = -np.abs(c.S[1:-1, 1:-1]) * np.float32(5.0e7)
        c.S[3:-3, 3:-3] += np.float32(2.0e8)
    else:
        c.S[1:-1, 1:-1] = np.float32(1.0e8) + c.S[1:-1, 1:-1] * np.float32(3)
    res = check_forward(c, 0, 13, 0, 12, local)
    assert _collapsed_deletion_ties(c, res, local) > 0


def test_trap_insertion_ties_take_the_lowest_row():
    """Integer similarities and a constant insertion cost: insertion
    candidates from two rows tie, and the lower row is the traceback
    (ascending k, strict >)."""
    rng = np.random.default_rng(23)
    q2, t2 = 15, 12
    S = rng.integers(-2, 3, (q2, t2)).astype(np.float32)
    S[[0, -1], :] = 0.0
    S[:, [0, -1]] = 0.0
    D = np.full((t2, t2), 9.0, np.float32)
    D[np.subtract.outer(np.arange(t2), np.arange(t2)) > -2] = 0.0
    c = DPCosts(S=S, D=D, A=np.ones(t2, np.float32),
                B=np.zeros(t2, np.float32), ins_zero_head_q=False,
                ins_zero_tail_q=False)
    res = check_forward(c, 0, q2 - 1, 0, t2 - 1, False)
    ties = 0
    for i in range(3, q2 - 1):
        for j in range(2, t2 - 1):
            k = res.PQ[i, j]
            if res.PT[i, j] == j - 1 and k < i - 1:      # an insertion won
                cand = res.H[1:i - 1, j - 1] - np.float32(1.0) + S[i, j]
                hits = np.flatnonzero(cand == res.H[i, j]) + 1
                assert hits[0] == k
                ties += hits.size > 1
    assert ties > 0


def test_wrapper_routes_cpu_tensors_and_rejects_bad_input():
    """On CPU tensors K7's wrapper is its plain version (no launch); it
    rejects what the kernel does not take."""
    c = random_costs(np.random.default_rng(3), 9, 11, AlignT.GLOBAL, True)
    c = port_costs(c)
    tabs = dp_engine.device_tables([c], 0, 8, 0, 10, device=CPU)
    b = dict(q0=0, q1=8, t0=0, t1=10)
    n = dp_engine.dp_forward_tb.launches
    for got, want in zip(dp_engine.dp_forward_tb(*tabs, **b),
                         dp_engine.dp_forward_tb_plain(*tabs, **b)):
        assert torch.equal(got, want)
    assert dp_engine.dp_forward_tb.launches == n
    with pytest.raises(TypeError):
        dp_engine.dp_forward_tb(tabs[0].double(), *tabs[1:], **b)
    with pytest.raises(ValueError):
        dp_engine.dp_forward_tb(tabs[0][:, :, :5].contiguous(), *tabs[1:],
                                **b)
    with pytest.raises(ValueError):
        dp_engine.dp_forward_tb(*tabs[:2], tabs[2].transpose(1, 2), *tabs[3:],
                                **b)
    for bad in (dict(b, q1=9), dict(b, t0=9), dict(b, q0=7)):
        with pytest.raises(ValueError):
            dp_engine.dp_forward_tb(*tabs, **bad)
    with pytest.raises(ValueError):
        dp_engine.build_forward_batched(
            [c, port_costs(random_costs(np.random.default_rng(4), 9, 12))],
            device=CPU)


@pytest.mark.parametrize("bounds", [(2, 3, 1, 6), (1, 6, 2, 3)])
def test_one_row_or_column_routes_to_dp_ref(bounds):
    q0, q1, t0, t1 = bounds
    c = random_costs(np.random.default_rng(1), 8, 8, AlignT.GLOBAL, False)
    got = dp_engine.build_forward(port_costs(c), q0, q1, t0, t1, device=CPU)
    assert_same(got, dp_ref.build_forward(c, q0, q1, t0, t1))
    assert (got.PQ[q1, t1], got.PT[q1, t1]) == (q0, t0)


# ----------------------------------------------- the affine fast path's gate

class _Fixed:
    """An evaluator whose ``build_costs`` returns one fixed cost model."""

    def __init__(self, costs):
        self.costs = costs

    def build_costs(self, query, templ):
        return self.costs


class _Len:
    """A sequence of a given size (``DPMatrix`` asks for nothing else)."""

    def __init__(self, n):
        self.n = n

    def size(self):
        return self.n


def _constant_affine(base, q2, t2, gi, ge, at, s_diag, s_off):
    """Integer constant-affine costs of ``base``'s classes (the JAX
    package's ``scoring.base`` or the port's): S = s_diag on the main
    diagonal and s_off elsewhere inside the sentinel border."""
    S = np.zeros((q2, t2), np.float32)
    S[1:-1, 1:-1] = s_off
    d = np.arange(1, min(q2, t2) - 1)
    S[d, d] = s_diag
    gi_v = np.full(t2, gi, np.float32)
    ge_v = np.full(t2, ge, np.float32)
    D = base.affine_deletion_table(np.minimum.outer(gi_v, gi_v),
                                   np.minimum.outer(ge_v, ge_v), at)
    zh, zt = base.ins_zero_flags(at)
    return base.DPCosts(S=S, D=D, A=gi_v.copy(), B=ge_v.copy(),
                        ins_zero_head_q=zh, ins_zero_tail_q=zt,
                        del_gi_vec=gi_v, del_ge_vec=ge_v, del_align=at)


@pytest.mark.parametrize("gi,ge,s_off", [(3.0, 1.0, 2 ** 21 - 1),
                                         (3.0, 1.0, 2 ** 21 - 2),
                                         (5.0, 1.0, 2 ** 21 - 4)])
@pytest.mark.parametrize("at", ["GLOBAL", "SEMI_LOCAL", "LOCAL"])
def test_affine_fast_path_is_not_exact_past_2_24(at, gi, ge, s_off,
                                                 monkeypatch):
    """The reference's gate (``dp_affine.affine_consts``) bounds the costs,
    max|S| + max(|gi|, |ge|)(Q + T) < 2^22, but not H: with S = 2^21 - 1
    on a 40 x 37 matrix's diagonal H reaches 7.3e7, where float32 holds
    only multiples of 8, and the reassociated sums of ``dp_affine`` round
    apart from ``dp_ref``'s candidate by candidate.  The copy keeps the
    reference's fault (H, PQ or PT differ); the port's ``DPMatrix`` bounds
    H too and builds such a model on the general engine, equal to
    ``dp_ref``, while the JAX package's ``DPMatrix`` keeps its behaviour."""
    from alignment_algos_tpu.core import dp as rdp
    from alignment_algos_tpu.scoring import base as rbase
    from alignment_algos_tpu_torch.core import dp as tdp
    from alignment_algos_tpu_torch.ops import dp_affine as tdp_affine
    from alignment_algos_tpu_torch.ops import dp_ref as tdp_ref

    monkeypatch.setenv("AAT_TORCH_DEVICE", "cpu")
    q2, t2 = 40, 37
    s_diag = 2 ** 21 - 1
    mine = _constant_affine(tbase, q2, t2, gi, ge, tparams.AlignT[at],
                            s_diag, s_off)
    theirs = _constant_affine(rbase, q2, t2, gi, ge, AlignT[at], s_diag,
                              s_off)
    local = at == "LOCAL"
    aff = tdp_affine.affine_consts(mine)
    assert aff is not None                     # the reference's gate passes
    ref = tdp_ref.build_forward(mine, 0, q2 - 1, 0, t2 - 1, local=local)
    assert ref.H.max() > 2 ** 24
    fast = tdp_affine.build_forward_affine(mine, 0, q2 - 1, 0, t2 - 1, *aff,
                                           local=local)
    assert not (np.array_equal(fast.H, ref.H)
                and np.array_equal(fast.PQ, ref.PQ)
                and np.array_equal(fast.PT, ref.PT))
    assert not tdp._affine_h_exact(mine, *aff)
    got = tdp.DPMatrix(_Len(q2), _Len(t2), _Fixed(mine),
                       align_type=tparams.AlignT[at]).res
    assert_same(got, ref)
    jax_res = rdp.DPMatrix(_Len(q2), _Len(t2), _Fixed(theirs),
                           align_type=AlignT[at]).res
    assert_same(jax_res, fast)


def test_affine_fast_path_still_routes_blosum_scale_models(monkeypatch):
    """BLOSUM-scale integer costs keep the fast path, equal to dp_ref."""
    from alignment_algos_tpu_torch.core import dp as tdp
    from alignment_algos_tpu_torch.ops import dp_ref as tdp_ref

    calls = []
    fast = tdp.dp_affine.build_forward_affine
    monkeypatch.setattr(tdp.dp_affine, "build_forward_affine",
                        lambda *a, **k: calls.append(1) or fast(*a, **k))
    rng = np.random.default_rng(6)
    c = _constant_affine(tbase, 60, 52, 11.0, 1.0, tparams.AlignT.SEMI_LOCAL,
                         11.0, 0.0)
    c.S[1:-1, 1:-1] = rng.integers(-4, 12, (58, 50))
    got = tdp.DPMatrix(_Len(60), _Len(52), _Fixed(c),
                       align_type=tparams.AlignT.SEMI_LOCAL).res
    assert calls == [1]
    assert_same(got, tdp_ref.build_forward(c, 0, 59, 0, 51))
