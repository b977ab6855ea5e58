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


@pytest.mark.parametrize("local", [False, True])
def test_negative_zero_model_is_dp_ref_bit_for_bit(local):
    """S all -0.0 with zero D, A and B at 9 x 8 (ROADMAP C5): the port's
    build equals ``dp_ref`` as float32 bits (every H cell +0.0, since IEEE
    0.0 + (-0.0) is +0.0).  The JAX engine equals both in value, PQ and PT;
    in global mode its H is -0.0 on the diagonal (1, 1) .. (6, 6), where
    XLA folds the boundary cell's ``0.0 + S`` (JAX ``ops/dp_engine.py:56``)
    into S's -0.0 and the match chain carries it down the diagonal."""
    f32 = np.float32
    c = DPCosts(S=np.full((9, 8), -0.0, f32), D=np.zeros((8, 8), f32),
                A=np.zeros(8, f32), B=np.zeros(8, f32),
                ins_zero_head_q=False, ins_zero_tail_q=False)
    got = dp_engine.build_forward(port_costs(c), 0, 8, 0, 7, local,
                                  device=CPU)
    ref = dp_ref.build_forward(c, 0, 8, 0, 7, local=local)
    np.testing.assert_array_equal(got.H.view(np.int32), ref.H.view(np.int32))
    assert_same(got, ref)
    assert not np.signbit(ref.H).any()
    jax = jde.build_forward_jax(c, 0, 8, 0, 7, local=local)
    assert_same(jax, ref)
    differ = list(zip(*np.nonzero(jax.H.view(np.int32)
                                  != ref.H.view(np.int32))))
    assert differ == ([] if local else [(d, d) for d in range(1, 7)])
    assert all(np.signbit(jax.H[d]) for d in differ)


def test_first_max_takes_the_first_maximum_bits():
    """``_first_max`` returns the value at the first argmax: -0.0 before
    +0.0 gives -0.0 (``amax`` may return either zero)."""
    neg = torch.tensor(np.float32(-3.0e38))
    x = torch.tensor([[-1.0, -0.0, 0.0, -2.0], [-5.0, 0.0, -0.0, 0.0]])
    val, arg = dp_engine._first_max(x, neg, 1)
    assert arg.tolist() == [1, 1]
    assert torch.signbit(val).tolist() == [True, False]


# ------------------------------------------------------- K7's launch plan

# (q2, t2, (q0, q1, t0, t1) or None for the whole matrix)
PLAN_SHAPES = [(386, 404, None), (182, 224, None), (258, 7302, None),
               (12, 7302, None), (40, 3000, None), (9, 7, None),
               (41, 33, None), (16, 15, (4, 7, 2, 9)),
               (130, 97, (7, 120, 11, 90)), (386, 404, (10, 300, 250, 390)),
               (258, 7302, (3, 200, 5000, 7100))]


def _whole(q2, t2, bounds):
    return bounds or (0, q2 - 1, 0, t2 - 1)


@pytest.mark.parametrize("cluster", [16, 8])
@pytest.mark.parametrize("q2,t2,bounds", PLAN_SHAPES)
def test_k7_plan_gives_each_interior_column_one_block(q2, t2, bounds,
                                                      cluster):
    q0, q1, t0, t1 = _whole(q2, t2, bounds)
    plan = dp_engine.k7_plan(q2, t2, q0, q1, t0, t1, cluster)
    assert plan.cluster == cluster and len(plan.cuts) == cluster + 1
    owners = np.zeros(t2, np.int64)
    for lo, hi in zip(plan.cuts[:-1], plan.cuts[1:]):
        assert lo <= hi
        owners[lo:hi] += 1
    assert (owners[t0 + 2:t1] == 1).all()
    assert owners.sum() == t1 - t0 - 2
    assert plan.smem_bytes <= dp_engine.K7_SMEM_LIMIT


@pytest.mark.parametrize("q2,t2,bounds", [(386, 404, (10, 300, 250, 390)),
                                          (258, 7302, (3, 200, 5000, 7100))])
def test_k7_plan_of_a_subrectangle_starting_inside_a_later_slice(q2, t2,
                                                                 bounds):
    """The sub-rectangle's t0 falls inside a slice other than the first of
    the whole matrix's plan; its own plan cuts only [t0+2, t1-1]."""
    q0, q1, t0, t1 = bounds
    whole = dp_engine.k7_plan(q2, t2, 0, q2 - 1, 0, t2 - 1)
    inside = [b for b, (lo, hi) in enumerate(zip(whole.cuts[:-1],
                                                 whole.cuts[1:]))
              if lo <= t0 < hi]
    assert inside and inside[0] > 0
    plan = dp_engine.k7_plan(q2, t2, q0, q1, t0, t1)
    assert plan.cuts[0] == t0 + 2 and plan.cuts[-1] == t1
    assert all(a <= b for a, b in zip(plan.cuts, plan.cuts[1:]))


def test_k7_plan_modes_at_the_tools_and_screen_shapes():
    """nalign's 386 x 404 and gn2's 182 x 224 keep D, Cm and the history
    in shared memory on a 16-block cluster; a 7,302-column bucket past K3's
    cap streams them.  Every resident plan fits the H100's 232,448 bytes,
    and the shared bytes are the kernel's layout."""
    plans = {sh: dp_engine.k7_plan(*sh, 0, sh[0] - 1, 0, sh[1] - 1)
             for sh in ((386, 404), (182, 224), (258, 7302))}
    assert [p.mode for p in plans.values()] == ["resident", "resident",
                                                "streamed"]
    assert all(p.cluster == 16 for p in plans.values())
    for q2 in (12, 40, 182, 386):
        for t2 in (7, 33, 224, 404, 700, 1500):
            plan = dp_engine.k7_plan(q2, t2, 0, q2 - 1, 0, t2 - 1)
            if plan.mode == "resident":
                assert plan.smem_bytes <= 232_448
    # two rows and the parts' pairs; streamed: the left column's history;
    # resident: D, Cm and the history of the block's columns
    p = plans[(258, 7302)]
    assert p.smem_bytes == 4 * (2 * 7302 + 4 * dp_engine.K7_THREADS + 258)
    p = plans[(182, 224)]
    widths = np.diff(p.cuts)
    d_rows = np.maximum(0, np.asarray(p.cuts[1:]) - 3)
    assert p.smem_bytes == 4 * (2 * 224 + 4 * dp_engine.K7_THREADS
                                + int((widths * (d_rows + 2 * 178)).max()))
    with pytest.raises(ValueError):
        dp_engine.k7_plan(40, 40000, 0, 39, 0, 39999)


@pytest.mark.parametrize("cluster", [16, 8])
@pytest.mark.parametrize("q2,t2,bounds", [(258, 7302, None),
                                          (12, 7302, None),
                                          (40, 3000, None),
                                          (258, 7302, (3, 200, 5000, 7100))])
def test_k7_streamed_slices_hold_equal_candidate_counts(q2, t2, bounds,
                                                        cluster):
    """Streamed slices are cut by gap candidates, not width: each slice's
    count is within one column's worth (the heaviest column's candidates)
    of the equal share, so the right-hand slices are the narrow ones."""
    q0, q1, t0, t1 = _whole(q2, t2, bounds)
    plan = dp_engine.k7_plan(q2, t2, q0, q1, t0, t1, cluster)
    assert plan.mode == "streamed"
    cand = dp_engine.k7_candidates(q0, q1, t0, t1)
    sums = np.asarray([cand[lo - t0 - 2:hi - t0 - 2].sum()
                       for lo, hi in zip(plan.cuts[:-1], plan.cuts[1:])])
    assert sums.sum() == cand.sum()
    assert np.abs(sums - cand.sum() / cluster).max() <= cand.max()
    widths = np.diff(plan.cuts)
    assert widths[0] > widths[-1]


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
