"""The port's CUDA kernels on the card: K1 (scores) and K2 (tracebacks) are
bit-equal to their plain PyTorch versions, run on the same card, and K1
agrees with the numpy Gotoh oracle; K3 (general-gap DP, both modes), K5
(HMAP similarity) and K6 (z-norm, one launch over many buckets) equal
their plain versions, K3 equals the numpy ``dp_ref`` engine and K5 + K6
equal the host ``build_costs`` S; a profile screen with a template past
K3's shared-memory cap scores it on K7, equal to ``dp_ref``, on the
device route and on the host-build route; the sharded library screen and
the grid on meshes that name the card several times; K8
(the traceback decode) equals its plain version and the numpy decode;
``to_device``'s layout on the card (the transpose kernel) equals the host
route's bit for bit, and K1 and K2 on it equal their plain versions on the
host route's.

Needs an NVIDIA GPU and nvcc; skips elsewhere.  Imports only the port (no
JAX, nothing of the JAX package), so it runs where JAX is not installed:

    AAT_TORCH_DEVICE=cuda python -m pytest --noconftest -m cuda \
        tests/test_torch_cuda.py
"""

import io
import os
import sys

import numpy as np
import pytest
import torch

from alignment_algos_tpu_torch import native
from alignment_algos_tpu_torch.ops import (dp_pallas, dp_scores, expf,
                                           hmap_device)
from alignment_algos_tpu_torch.ops import swaffine
from alignment_algos_tpu_torch.scoring.base import (DPCosts,
                                                    affine_deletion_table)
from alignment_algos_tpu_torch.utils.params import AlignT

pytestmark = pytest.mark.cuda

PAD = 20          # pad code: a wall row/column of the table, as aat_screen
SHAPES = [(13, 29, 5), (29, 13, 4), (16, 16, 3), (512, 512, 1024)]
GAPS = [(4.73, 0.34), (11.0, 1.0)]


@pytest.fixture(scope="module")
def cuda():
    # decided here, never at import: every xdist worker collects the same
    # tests whether or not it sees a card
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _inputs(q, t, b, seed, shared_query):
    """Random codes with a lane padded by the wall and an all-wall lane
    (score 0); a BLOSUM-like integer table with the pad wall."""
    rng = np.random.default_rng(seed)
    qc = rng.integers(0, 20, q if shared_query else (b, q))
    tc = rng.integers(0, 20, (b, t))
    tc[0] = PAD
    if b > 1:
        tc[1, t // 2:] = PAD
    table = np.full((21, 21), -1.0e4, np.float32)
    table[:20, :20] = rng.integers(-4, 12, (20, 20))
    return qc, tc, table


@pytest.mark.parametrize("gi,ge", GAPS)
@pytest.mark.parametrize("q,t,b", SHAPES)
@pytest.mark.parametrize("shared_query", [True, False])
def test_k1_equals_plain(cuda, q, t, b, gi, ge, shared_query):
    qc, tc, table = _inputs(q, t, b, q * t + b, shared_query)
    qd, td, tab, gap = swaffine.to_device(qc, tc, table, gi, ge, cuda)
    got = swaffine.sw_affine_scores(qd, td, tab, gap)
    torch.cuda.synchronize()
    want = swaffine.sw_affine_scores_plain(
        swaffine.skewed_similarity(qd, td, tab), gap, q=q, t=t)
    assert torch.equal(got, want)
    assert got[0].item() == 0.0


@pytest.mark.parametrize("gi,ge", GAPS)
@pytest.mark.parametrize("q,t,b", SHAPES)
def test_k2_equals_plain(cuda, q, t, b, gi, ge):
    qc, tc, table = _inputs(q, t, b, q + t * b, False)
    qd, td, tab, gap = swaffine.to_device(qc, tc, table, gi, ge, cuda)
    got = swaffine.sw_affine_tb(qd, td, tab, gap)
    torch.cuda.synchronize()
    want = swaffine.sw_affine_tb_plain(
        swaffine.skewed_similarity(qd, td, tab), gap, q=q, t=t)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)


@pytest.mark.parametrize("gi,ge", GAPS)
def test_k1_matches_numpy_oracle(cuda, gi, ge):
    q, t, b = 40, 56, 4
    qc, tc, table = _inputs(q, t, b, 5, True)
    qd, td, tab, gap = swaffine.to_device(qc, tc, table, gi, ge, cuda)
    got = swaffine.sw_affine_scores(qd, td, tab, gap).cpu().numpy()
    s = table[qc[None, :, None], tc[:, None, :]]
    # float32 gaps keep every oracle op in float32 under any numpy version
    want = swaffine.sw_affine_reference(s, np.float32(gi), np.float32(ge))
    np.testing.assert_array_equal(got, want)


# K1 and K2 give each thread R query rows (R = 1, 2, 4, 8, 16 by Q) and a
# warp 32*R rows; a longer query runs in chunks of 512.  Shapes at those
# edges: Q = 1, one row past a power of two, 32*R - 1 and 32*R + 1 at R = 16,
# 2*32*R + 7 (three chunks), odd T, B = 1, 33 and 5120.
EDGE_SHAPES = [(1, 1, 1), (32, 7, 1), (33, 9, 3), (257, 17, 2),
               (511, 45, 33), (513, 39, 33), (1031, 77, 33), (40, 37, 5120)]


def _edge_inputs(q, t, b, seed, shared_query):
    """Random codes; with 3 or more lanes an all-wall lane and a lane
    walled from T/2, as a pad-walled library."""
    rng = np.random.default_rng(seed)
    qc = rng.integers(0, 20, q if shared_query else (b, q))
    tc = rng.integers(0, 20, (b, t))
    if b >= 3:
        tc[0] = PAD
        tc[1, t // 2:] = PAD
    table = np.full((21, 21), -1.0e4, np.float32)
    table[:20, :20] = rng.integers(-4, 12, (20, 20))
    return qc, tc, table


@pytest.mark.parametrize("gi,ge", GAPS)
@pytest.mark.parametrize("q,t,b", EDGE_SHAPES)
@pytest.mark.parametrize("shared_query", [True, False],
                         ids=["shared", "q_lane"])
def test_k1_stripe_edges_equal_plain(cuda, q, t, b, gi, ge, shared_query):
    qc, tc, table = _edge_inputs(q, t, b, q * 7 + t + b, shared_query)
    qd, td, tab, gap = swaffine.to_device(qc, tc, table, gi, ge, cuda)
    got = swaffine.sw_affine_scores(qd, td, tab, gap)
    torch.cuda.synchronize()
    want = swaffine.sw_affine_scores_plain(
        swaffine.skewed_similarity(qd, td, tab), gap, q=q, t=t)
    assert torch.equal(got, want)


@pytest.mark.parametrize("gi,ge", GAPS)
@pytest.mark.parametrize("q,t,b", EDGE_SHAPES)
@pytest.mark.parametrize("shared_query", [True, False],
                         ids=["shared", "q_lane"])
def test_k2_stripe_edges_equal_plain(cuda, q, t, b, gi, ge, shared_query):
    qc, tc, table = _edge_inputs(q, t, b, q + 5 * t + b, shared_query)
    qd, td, tab, gap = swaffine.to_device(qc, tc, table, gi, ge, cuda)
    got = swaffine.sw_affine_tb(qd, td, tab, gap)
    torch.cuda.synchronize()
    want = swaffine.sw_affine_tb_plain(
        swaffine.skewed_similarity(qd, td, tab), gap, q=q, t=t)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)


@pytest.mark.parametrize("gi,ge", GAPS)
def test_k1_chunked_matches_numpy_oracle(cuda, gi, ge):
    """Three query chunks (1031 rows) on 2 lanes, against the oracle."""
    q, t, b = 1031, 61, 2
    qc, tc, table = _edge_inputs(q, t, b, 9, True)
    qd, td, tab, gap = swaffine.to_device(qc, tc, table, gi, ge, cuda)
    got = swaffine.sw_affine_scores(qd, td, tab, gap).cpu().numpy()
    s = table[qc[None, :, None], tc[:, None, :]]
    want = swaffine.sw_affine_reference(s, np.float32(gi), np.float32(ge))
    np.testing.assert_array_equal(got, want)


def test_wrapper_counts_launches_and_rejects_bad_input(cuda):
    qc, tc, table = _inputs(8, 9, 3, 0, True)
    qd, td, tab, gap = swaffine.to_device(qc, tc, table, 11.0, 1.0, cuda)
    n1, n2 = swaffine.sw_affine_scores.launches, swaffine.sw_affine_tb.launches
    swaffine.sw_affine_scores(qd, td, tab, gap)
    swaffine.sw_affine_tb(qd, td, tab, gap)
    assert swaffine.sw_affine_scores.launches == n1 + 1
    assert swaffine.sw_affine_tb.launches == n2 + 1
    with pytest.raises(ValueError):
        swaffine.sw_affine_scores(qd, td.cpu(), tab, gap)
    with pytest.raises(TypeError):
        swaffine.sw_affine_scores(qd, td.long(), tab, gap)
    with pytest.raises(ValueError):
        swaffine.sw_affine_scores(qd, td + 30, tab, gap)


# ------------------------------- the codes' layout on the card (to_device)

LAYOUTS = [(1, 1), (7, 33), (33, 32), (65, 4132), (1000, 1025)]


def _same_tensors(got, want):
    """Card tensors against the host route's: dtype, shape, contiguity and
    every bit."""
    for g, w in zip(got, want, strict=True):
        assert g.is_cuda and g.is_contiguous()
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("b,t", LAYOUTS)
@pytest.mark.parametrize("shared_query", [True, False])
def test_to_device_equals_the_host_transpose(cuda, b, t, shared_query):
    rng = np.random.default_rng(b * t)
    qc = rng.integers(0, 21, 40 if shared_query else (b, 40))
    tc = rng.integers(0, 21, (b, t)).astype(np.int32)
    table = rng.standard_normal((21, 21)).astype(np.float32)
    n = swaffine.transpose_codes.launches
    got = swaffine.to_device(qc, tc, table, 4.73, 0.34, cuda)
    torch.cuda.synchronize()
    assert swaffine.transpose_codes.launches == n + 1 + (not shared_query)
    _same_tensors(got, swaffine.to_device(qc, tc, table, 4.73, 0.34, "cpu"))


@pytest.mark.parametrize("b,t", [(0, 7), (5, 0), (0, 0)])
def test_to_device_of_an_empty_array_makes_no_launch(cuda, b, t):
    qc = np.zeros((b, 9), np.int32)
    tc = np.zeros((b, t), np.int32)
    table = np.zeros((21, 21), np.float32)
    n = swaffine.transpose_codes.launches
    got = swaffine.to_device(qc, tc, table, 11.0, 1.0, cuda)
    # the (b, 9) per-lane queries launch once they hold a lane
    assert swaffine.transpose_codes.launches == n + (b > 0)
    assert (got[0].shape, got[1].shape) == ((9, b), (t, b))
    _same_tensors(got, swaffine.to_device(qc, tc, table, 11.0, 1.0, "cpu"))


def test_transpose_codes_rejects_bad_input(cuda):
    x = torch.zeros((4, 6), dtype=torch.int32, device=cuda)
    for bad in (x.long(), x[:, ::2], x[0]):
        with pytest.raises(ValueError):
            swaffine.transpose_codes(bad)


@pytest.mark.parametrize("gi,ge", GAPS)
@pytest.mark.parametrize("shared_query", [True, False])
def test_k1_k2_on_the_card_layout_equal_plain_on_the_host_layout(
        cuda, gi, ge, shared_query):
    # a padded library whose Tmax (45) is no multiple of 32, each template
    # padded by the wall code to its own length; the plain versions run on
    # the host route's tensors, the kernels on the card route's
    rng = np.random.default_rng(45)
    b, tmax = 37, 45
    qc, tc, table = _inputs(70, tmax, b, 45, shared_query)
    for i, n in enumerate(rng.integers(1, tmax + 1, b)):
        tc[i, n:] = PAD
    tc[2] = rng.integers(0, 20, tmax)
    dev = swaffine.to_device(qc, tc, table, gi, ge, cuda)
    host = swaffine.to_device(qc, tc, table, gi, ge, "cpu")
    got = swaffine.sw_affine_scores(*dev)
    want = swaffine.sw_affine_scores(*host)
    assert torch.equal(got.cpu(), want)
    for g, w in zip(swaffine.sw_affine_tb(*dev), swaffine.sw_affine_tb(*host),
                    strict=True):
        assert torch.equal(g.cpu(), w)


def test_to_device_spans_on_the_card(cuda):
    from alignment_algos_tpu_torch.utils import profiling
    qc, tc, table = _inputs(8, 33, 7, 0, False)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        before = len(profiling.records())
        swaffine.to_device(qc, tc, table, 11.0, 1.0, cuda)
    recs = profiling.records()[before:]
    root = [r for r in recs if r.name == "to_device"]
    assert len(root) == 1
    # the host layout, the copy, then the transposes' launches
    assert [(r.name, r.parent) for r in recs[1:]] == [
        ("to_device.layout", root[0].id), ("to_device.copy", root[0].id),
        ("to_device.layout", root[0].id)]
    assert recs[2].counts == {"h2d_bytes": 4 * (qc.size + tc.size
                                                + table.size + 2)}


# ------------------------------------------------- K3, K5, K6 (exact DP path)

def random_costs(rng, q2, t2, align_type=AlignT.GLOBAL, zero_flags=False):
    """tests/util.py's random cost model, as the port's ``DPCosts``."""
    S = rng.standard_normal((q2, t2)).astype(np.float32) * np.float32(2.0)
    S[[0, -1], :] = 0
    S[:, [0, -1]] = 0
    gi = rng.uniform(0.5, 5.0, t2).astype(np.float32)
    ge = rng.uniform(0.05, 1.0, t2).astype(np.float32)
    D = affine_deletion_table(np.minimum.outer(gi, gi).astype(np.float32),
                              np.minimum.outer(ge, ge).astype(np.float32),
                              align_type)
    return DPCosts(S=S, D=D, A=np.minimum(gi, np.roll(gi, 1)),
                   B=np.minimum(ge, np.roll(ge, 1)),
                   ins_zero_head_q=zero_flags, ins_zero_tail_q=zero_flags)


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Tolerance 0: equal values and NaN at the same places."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return (a.shape == b.shape and torch.equal(na, nb)
            and torch.equal(torch.where(na, 0.0, a), torch.where(nb, 0.0, b)))


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Tolerance 0 as float32 bits: NaN at the same places, every other
    value equal as int32 (so -0.0 != +0.0: a reordered max shows)."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return (a.shape == b.shape and torch.equal(na, nb)
            and torch.equal(torch.where(na, 0.0, a).view(torch.int32),
                            torch.where(nb, 0.0, b).view(torch.int32)))


def _dp_tables(rng, n, q2, t2, dev, *, vec_d, with_c, align, zero):
    """K3 inputs from random per-pair data: S with zero borders, gap
    vectors (vec_d: rebuilt into D on the device) or a full random D, A/B
    (and C) insertion coefficients."""
    S = (rng.standard_normal((n, q2, t2)) * 2.0).astype(np.float32)
    S[:, [0, -1], :] = 0.0
    S[:, :, [0, -1]] = 0.0
    gi = rng.uniform(0.5, 5.0, (n, t2)).astype(np.float32)
    ge = rng.uniform(0.05, 1.0, (n, t2)).astype(np.float32)
    if vec_d:
        D = np.stack([gi, ge], axis=1)
    else:
        D = rng.uniform(0.0, 9.0, (n, t2, t2)).astype(np.float32)
    A = np.minimum(gi, np.roll(gi, 1, axis=1))
    B = np.minimum(ge, np.roll(ge, 1, axis=1))
    C = rng.normal(0.0, 1.0, (n, t2)).astype(np.float32)
    t = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
         for x in (S, D, A, B, C)]
    return dp_scores.prepare_tables(
        *t, zero_head=zero, zero_tail=zero, off=2 if vec_d else 1,
        has_c=with_c, vec_d=vec_d,
        del_free=vec_d and align in (AlignT.LOCAL, AlignT.SEMI_LOCAL,
                                     AlignT.LOCAL_GLOBAL))


# (1, 802, 770): past the TPU kernels' VMEM cap (no size gate here)
K3_SHAPES = [(1, 3, 3), (3, 9, 7), (9, 13, 21), (1, 40, 33), (4, 258, 386),
             (1, 802, 770)]


@pytest.mark.parametrize("local", [False, True])
@pytest.mark.parametrize("vec_d", [True, False], ids=["vec_d", "full_d"])
@pytest.mark.parametrize("n,q2,t2", K3_SHAPES)
def test_k3_equals_plain(cuda, n, q2, t2, vec_d, local):
    rng = np.random.default_rng(n * 1000 + q2 + t2)
    tabs = _dp_tables(rng, n, q2, t2, cuda, vec_d=vec_d, with_c=not vec_d,
                      align=AlignT.SEMI_LOCAL, zero=vec_d)
    for full_h in (False, True):
        got = dp_scores.dp_general(*tabs, local=local, full_h=full_h)
        torch.cuda.synchronize()
        want = dp_scores.dp_general_plain(*tabs, local=local, full_h=full_h)
        assert _same_bits(got, want), (full_h, (got - want).abs().max())


# the ragged (vector-form) launch: flag sets of SEMI_LOCAL (ins_zero flags
# and free deletion overhangs) and GLOBAL (none)
RAGGED_FLAGS = {
    "semi_local": dict(zero_head=True, zero_tail=True, del_free=True),
    "global": dict(zero_head=False, zero_tail=False, del_free=False)}


def _ragged_buckets(rng, shapes, dev, *, with_c=False, special=""):
    """``dp_general_ragged``'s input from random data, one bucket per (n,
    q2, t2): S with zero borders, gap vectors, A/B (and C).  ``special``:
    ``zero`` puts -0.0 into S, the gap vectors and A/B, ``nan`` one NaN
    into S of the first pair and into gi of the last."""
    out = []
    for n, q2, t2 in shapes:
        S = (rng.standard_normal((n, q2, t2)) * 2.0).astype(np.float32)
        S[:, [0, -1], :] = 0.0
        S[:, :, [0, -1]] = 0.0
        gi = rng.uniform(0.5, 5.0, (n, t2)).astype(np.float32)
        ge = rng.uniform(0.05, 1.0, (n, t2)).astype(np.float32)
        A = np.minimum(gi, np.roll(gi, 1, axis=1))
        B = np.minimum(ge, np.roll(ge, 1, axis=1))
        if special == "zero":
            S[rng.random(S.shape) < 0.3] = -0.0
            S[:, -1, -1] = -0.0
            gi[:, ::3] = -0.0
            ge[:, 1::2] = -0.0
            A[:, ::2] = -0.0
            B[:, 1::3] = -0.0
        elif special == "nan":
            S[0, q2 // 2, t2 // 2] = np.nan
            gi[-1, t2 // 2] = np.nan
        C = (rng.normal(0.0, 1.0, (n, t2)).astype(np.float32) if with_c
             else None)
        out.append(tuple(None if x is None else
                         torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                         for x in (S, np.stack([gi, ge], axis=1), A, B, C)))
    return out


def _ragged_vs_plain(buckets, local, flags):
    got = dp_scores.dp_general_ragged(buckets, local=local, **flags)
    torch.cuda.synchronize()
    want = dp_scores.dp_general_ragged_plain(buckets, local=local, **flags)
    assert _same_bits(got, want), (got, want)
    return got


@pytest.mark.parametrize("local", [False, True])
@pytest.mark.parametrize("flags", list(RAGGED_FLAGS))
@pytest.mark.parametrize("n,q2,t2", K3_SHAPES)
def test_k3_ragged_equals_plain(cuda, n, q2, t2, flags, local):
    rng = np.random.default_rng(n * 1000 + q2 + t2 + 7)
    n0 = dp_scores.dp_general_ragged.launches
    _ragged_vs_plain(_ragged_buckets(rng, [(n, q2, t2)], cuda), local,
                     RAGGED_FLAGS[flags])
    assert dp_scores.dp_general_ragged.launches == n0 + 1


# t2 from 3 to 770, q2 from 3 to 802, in no order of length
MIXED_SHAPES = [(2, 40, 130), (1, 258, 770), (3, 9, 3), (5, 258, 386),
                (1, 3, 500), (4, 100, 33), (1, 802, 7), (2, 258, 258),
                (6, 17, 129)]


@pytest.mark.parametrize("with_c", [False, True], ids=["no_c", "c"])
@pytest.mark.parametrize("local", [False, True])
@pytest.mark.parametrize("flags", list(RAGGED_FLAGS))
def test_k3_ragged_mixed_lengths_equal_plain(cuda, flags, local, with_c):
    """One launch over nine buckets of mixed shapes: each score lands in
    its bucket-order slot whatever the launch order."""
    rng = np.random.default_rng(31 + local + 2 * with_c)
    buckets = _ragged_buckets(rng, MIXED_SHAPES, cuda, with_c=with_c)
    got = _ragged_vs_plain(buckets, local, RAGGED_FLAGS[flags])
    assert got.shape == (sum(n for n, _, _ in MIXED_SHAPES),)
    # bucket by bucket, each alone, gives the same bits
    parts = [dp_scores.dp_general_ragged([b], local=local,
                                         **RAGGED_FLAGS[flags])
             for b in buckets]
    assert _same_bits(got, torch.cat(parts))


@pytest.mark.parametrize("local", [False, True])
@pytest.mark.parametrize("flags", list(RAGGED_FLAGS))
@pytest.mark.parametrize("special", ["zero", "nan"])
def test_k3_signed_zero_and_nan_equal_plain(cuda, special, flags, local):
    """-0.0 and NaN in S and in the gap vectors: the ragged launch, and the
    table form (scores and full H) on the same costs, equal the plain
    version as float32 bits."""
    rng = np.random.default_rng(5 + local)
    buckets = _ragged_buckets(rng, [(3, 11, 11), (2, 40, 33),
                                    (2, 258, 130)], cuda, special=special)
    got = _ragged_vs_plain(buckets, local, RAGGED_FLAGS[flags])
    if special == "nan":
        assert torch.isnan(got).any()
    f = RAGGED_FLAGS[flags]
    for S, G, A, B, _ in buckets:
        tabs = dp_scores.prepare_tables(
            S, G, A, B, torch.zeros_like(A), zero_head=f["zero_head"],
            zero_tail=f["zero_tail"], off=2, has_c=False, vec_d=True,
            del_free=f["del_free"])
        for full_h in (False, True):
            got = dp_scores.dp_general(*tabs, local=local, full_h=full_h)
            torch.cuda.synchronize()
            want = dp_scores.dp_general_plain(*tabs, local=local,
                                              full_h=full_h)
            assert _same_bits(got, want), full_h


def test_k3_ragged_rejects_bad_input(cuda):
    rng = np.random.default_rng(8)
    (S, G, A, B, _), = _ragged_buckets(rng, [(2, 9, 8)], cuda)
    for bad, err in (([], ValueError),
                     ([(S.cpu(), G, A, B, None)], ValueError),
                     ([(S.double(), G, A, B, None)], TypeError),
                     ([(S, G[:, :1].contiguous(), A, B, None)], ValueError),
                     ([(S.transpose(1, 2), G, A, B, None)], ValueError)):
        with pytest.raises(err):
            dp_scores.dp_general_ragged(bad)


@pytest.mark.parametrize("local", [False, True])
def test_k3_matches_dp_ref(cuda, local):
    rng = np.random.default_rng(11)
    costs = [random_costs(rng, 40, 29, AlignT.GLOBAL_LOCAL, True)
             for _ in range(2)]
    got = dp_pallas.forward_h_batched(costs, local=local, device=cuda)
    want = dp_pallas.forward_h_reference(costs, local=local)
    np.testing.assert_array_equal(got, want)
    sc = dp_scores.forward_scores_batch(costs, local=local, device=cuda)
    np.testing.assert_array_equal(sc, want[:, -1, -1])


def _profiles(rng, lengths):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.path.join(root, "tools"))
    from make_profiles import make_profile
    from alignment_algos_tpu_torch.seq.hmap import HMAPSequence
    return [HMAPSequence.from_stream(io.StringIO(
        make_profile(rng, f"s{i}", n))) for i, n in enumerate(lengths)]


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("q_len,t_len,n", [(30, 61, 3), (256, 300, 4)])
def test_k5_k6_equal_plain_and_host(cuda, q_len, t_len, n, normalize):
    from alignment_algos_tpu_torch.scoring.hmap_eval import HMAPaliEval
    from alignment_algos_tpu_torch.utils.params import HMAPaliParams
    assert expf.host_libm_loaded(), "host libm expf not loaded"
    rng = np.random.default_rng(q_len + n)
    params = HMAPaliParams()
    params.normalize_mtx = normalize
    ev = HMAPaliEval(params)
    seqs = _profiles(rng, [q_len] + [t_len] * n)
    query, templates = seqs[0], seqs[1:]
    lib = hmap_device.DeviceLibrary(templates, ev, device=cuda)
    (t2, b), = lib.buckets.items()
    qp = {k: torch.from_numpy(v).to(cuda)
          for k, v in hmap_device.pack_sequence(query).items()}
    args = (qp["aa"], qp["zsse"], qp["conf"], b["aa"], b["zsse"], b["conf"],
            float(np.float32(params.alpha)))
    raw = hmap_device.hmap_sim(*args)
    torch.cuda.synchronize()
    assert _same(raw, hmap_device.hmap_sim_plain(*args))
    shift = float(-np.float32(params.zero_shift))
    S = hmap_device.hmap_znorm(raw, shift, normalize=normalize)
    torch.cuda.synchronize()
    assert _same_bits(S, hmap_device.hmap_znorm_plain(raw, shift,
                                                      normalize=normalize))
    S = S.cpu().numpy()
    for i, t in enumerate(templates):
        host = ev.build_costs(query, t).S
        assert (S[i].view(np.uint32) == host.view(np.uint32)).all(), i


def test_new_wrappers_count_launches_and_reject_bad_input(cuda):
    rng = np.random.default_rng(3)
    tabs = _dp_tables(rng, 2, 9, 8, cuda, vec_d=True, with_c=False,
                      align=AlignT.GLOBAL, zero=False)
    n3 = dp_scores.dp_general.launches
    dp_scores.dp_general(*tabs)
    dp_scores.dp_general(*tabs, full_h=True)
    assert dp_scores.dp_general.launches == n3 + 2
    with pytest.raises(ValueError):
        dp_scores.dp_general(tabs[0].cpu(), *tabs[1:])
    with pytest.raises(TypeError):
        dp_scores.dp_general(tabs[0].double(), *tabs[1:])
    with pytest.raises(ValueError):
        dp_scores.dp_general(tabs[0][:, :, :-1].contiguous(), *tabs[1:])
    with pytest.raises(ValueError):
        dp_scores.dp_general(tabs[0].transpose(1, 2), *tabs[1:])
    S = torch.rand((2, 9, 8), device=cuda)
    n5 = hmap_device.hmap_sim_ragged.launches
    n6 = hmap_device.hmap_znorm_ragged.launches
    hmap_device.hmap_znorm(S, -0.12)
    hmap_device.hmap_znorm(S, -0.12, normalize=False)
    hmap_device.hmap_znorm_ragged([S, S[:1].contiguous()], -0.12)
    assert hmap_device.hmap_znorm_ragged.launches == n6 + 3
    with pytest.raises(TypeError):
        hmap_device.hmap_znorm(S.double(), -0.12)
    q = torch.rand((9, 20), device=cuda)
    t = torch.rand((2, 8, 20), device=cuda)
    zq, zt = torch.rand((9, 3), device=cuda), torch.rand((2, 8, 3),
                                                         device=cuda)
    cq, ct = torch.rand(9, device=cuda), torch.rand((2, 8), device=cuda)
    hmap_device.hmap_sim(q, zq, cq, t, zt, ct, 0.5)
    assert hmap_device.hmap_sim_ragged.launches == n5 + 1
    with pytest.raises(ValueError):
        hmap_device.hmap_sim(q, zq, cq, t, zt, ct.cpu(), 0.5)
    with pytest.raises(ValueError):
        hmap_device.hmap_sim(q, zq, cq, t[:, :, :19].contiguous(), zt, ct,
                             0.5)
    with pytest.raises(ValueError):
        hmap_device.hmap_sim_ragged(q, zq, cq, [], 0.5)
    assert hmap_device.hmap_sim_ragged.launches == n5 + 1


# K5's buckets (n, t2): t2 = 3 (an empty interior), one off a tile's 64
# columns either side, 32 (one column a thread), one template and several
K5_BUCKETS = [(2, 3), (1, 63), (3, 65), (1, 64), (2, 127), (1, 129),
              (4, 32), (1, 33), (5, 258), (1, 386)]


def _k5_inputs(rng, q2, buckets, dev, special=True):
    """A random query and template stacks on ``dev``; with ``special``,
    NaN and inf profile and SSE entries and zero confidences."""
    def t(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    q = [t(q2, 20), t(q2, 3), rng.uniform(0.0, 1.0, q2).astype(np.float32)]
    stacks = [[t(n, t2, 20), t(n, t2, 3),
               rng.uniform(0.0, 1.0, (n, t2)).astype(np.float32)]
              for n, t2 in buckets]
    if special:
        q[0][1, 4] = np.nan
        q[1][q2 // 2, 1] = np.inf
        q[2][min(2, q2 - 1)] = 0.0
        stacks[1][0][0, 5, 7] = np.inf
        stacks[2][1][2, 9, 0] = -np.inf
        stacks[2][2][1, :] = 0.0
        stacks[-1][0][0, 100, 3] = np.nan
    return ([torch.from_numpy(x).to(dev) for x in q],
            [tuple(torch.from_numpy(x).to(dev) for x in st)
             for st in stacks])


def _k5_vs_plain(q, stacks, alpha):
    n5 = hmap_device.hmap_sim_ragged.launches
    got = hmap_device.hmap_sim_ragged(*q, stacks, alpha)
    assert hmap_device.hmap_sim_ragged.launches == n5 + 1
    want = hmap_device.hmap_sim_ragged_plain(*q, stacks, alpha)
    torch.cuda.synchronize()
    assert len(got) == len(want) == len(stacks)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.is_contiguous(), i
        assert torch.equal(g.view(torch.int32), w.view(torch.int32)), i
    return got


@pytest.mark.parametrize("q2", [3, 33, 31, 258])
def test_k5_ragged_equals_plain_on_mixed_buckets(cuda, q2):
    """One K5 launch over ten buckets (t2 = 3, off the 64-column tile by
    one either side, one-template buckets, NaN/inf entries, zero
    confidences) equals the plain version per bucket as float32 bits; the
    outputs are views into one allocation; each bucket alone equals its
    part of the ragged launch."""
    rng = np.random.default_rng(40 + q2)
    q, stacks = _k5_inputs(rng, q2, K5_BUCKETS, cuda)
    got = _k5_vs_plain(q, stacks, 0.66)
    base = got[0].untyped_storage().data_ptr()
    assert all(g.untyped_storage().data_ptr() == base for g in got)
    for st, g in zip(stacks, got):
        alone = hmap_device.hmap_sim(*q, *st, 0.66)
        assert torch.equal(alone.view(torch.int32), g.view(torch.int32))


@pytest.fixture(scope="module")
def screen_library(cuda, tmp_path_factory):
    """chip_smoke.py's seeded 1024-template ``--profiles 1`` library on the
    card: (query, templates, params, DeviceLibrary, query tensors)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import chip_smoke as cs
    from alignment_algos_tpu_torch.cli import screen as cli
    d = str(tmp_path_factory.mktemp("screen"))
    qfn, lib_dir, _, _ = cs.make_profile_library(d)
    query, templates, _ = cli.read_profiles(qfn, lib_dir)
    params = hmap_device.HMAPaliParams()
    lib = hmap_device.DeviceLibrary(templates, hmap_device.HMAPaliEval(
        params), device=cuda)
    return query, templates, params, lib, hmap_device.query_tensors(query,
                                                                    cuda)


def test_k5_ragged_equals_plain_on_the_1024_template_screen(screen_library):
    _, _, params, lib, qt = screen_library
    stacks = [(b["aa"], b["zsse"], b["conf"]) for b in lib.buckets.values()]
    assert len(stacks) > 200
    _k5_vs_plain([qt["aa"], qt["zsse"], qt["conf"]], stacks,
                 float(np.float32(params.alpha)))


def test_profile_screen_launches_k5_k6_k3_once(screen_library):
    query, templates, params, lib, _ = screen_library
    counters = (hmap_device.hmap_sim_ragged, hmap_device.hmap_znorm_ragged,
                dp_scores.dp_general_ragged, dp_scores.dp_general)
    before = [fn.launches for fn in counters]
    scores, _ = hmap_device.screen_hmap_device(query, templates, params,
                                               library=lib, device=lib.device)
    assert [fn.launches - n for fn, n in zip(counters, before)] == \
        [1, 1, 1, 0]
    assert np.isfinite(scores).all() and len(scores) == len(templates)


def _znorm_stacks(rng, shapes):
    """Random similarity stacks of the given (n, q2, t2), borders zeroed."""
    out = []
    for n, q2, t2 in shapes:
        S = (rng.standard_normal((n, q2, t2)) * 1.5 + 0.3).astype(np.float32)
        S[:, [0, -1], :] = 0.0
        S[:, :, [0, -1]] = 0.0
        out.append(S)
    return out


def _znorm_edge_stacks(dev):
    """A 1 x 1 region, a 1 x 698 one, a pair past 2^17 region elements, a
    bucket whose first region element is -0.0 (one pair all -0.0), a
    constant region (std 0), NaN and inf, and a full 5 x 258 x 258
    bucket."""
    rng = np.random.default_rng(21)
    tiny, row, big, negz, const, odd, full = _znorm_stacks(
        rng, [(2, 3, 3), (1, 3, 700), (1, 300, 450), (3, 5, 6), (2, 6, 9),
              (2, 7, 5), (5, 258, 258)])
    negz[:, 1, 1] = -0.0
    negz[1, 1:-1, 1:-1] = -0.0
    const[:, 1:-1, 1:-1] = np.float32(1.7)
    odd[0, 2, 2], odd[1, 3, 1] = np.nan, np.inf
    return [torch.from_numpy(x).to(dev)
            for x in (tiny, row, big, negz, const, odd, full)]


def _k6_vs_plain(Ss, normalize):
    got = hmap_device.hmap_znorm_ragged(Ss, -0.12, normalize=normalize)
    want = hmap_device.hmap_znorm_ragged_plain(Ss, -0.12, normalize=normalize)
    torch.cuda.synchronize()
    assert len(got) == len(want) == len(Ss)
    for i, (g, w) in enumerate(zip(got, want)):
        assert _same_bits(g, w), (i, tuple(g.shape), normalize)
    return got


@pytest.mark.parametrize("normalize", [True, False])
def test_k6_ragged_equals_plain_on_edge_shapes(cuda, normalize):
    Ss = _znorm_edge_stacks(cuda)
    n6 = hmap_device.hmap_znorm_ragged.launches
    got = _k6_vs_plain(Ss, normalize)
    assert hmap_device.hmap_znorm_ragged.launches == n6 + 1
    # each stack alone, as the one-bucket wrapper launches it
    for S, g in zip(Ss, got):
        assert _same_bits(hmap_device.hmap_znorm(S, -0.12,
                                                 normalize=normalize), g)
        assert _same_bits(g, hmap_device.hmap_znorm_plain(
            S, -0.12, normalize=normalize))


@pytest.mark.parametrize("normalize", [True, False])
def test_k6_ragged_equals_plain_on_a_64_bucket_library(cuda, normalize):
    """64 buckets of 1-6 pairs, q2 258 and t2 130-386, in one launch."""
    rng = np.random.default_rng(22)
    widths = rng.choice(np.arange(130, 387), 64, replace=False)
    shapes = [(int(rng.integers(1, 7)), 258, int(t2)) for t2 in widths]
    Ss = [torch.from_numpy(x).to(cuda)
          for x in _znorm_stacks(rng, shapes)]
    _k6_vs_plain(Ss, normalize)


def test_screen_with_a_template_past_k3_cap(cuda):
    """A 7,300-residue template (past K3's vector-form cap of 7,200) among
    ordinary ones: the screen does not raise, scores that bucket on K7 and
    the rest in one K3 launch, and every score equals ``dp_ref`` on the
    host costs."""
    from alignment_algos_tpu_torch.ops import dp_engine
    from alignment_algos_tpu_torch.scoring.hmap_eval import HMAPaliEval
    from alignment_algos_tpu_torch.utils.params import HMAPaliParams
    cap = dp_scores.vec_max_t2(cuda)
    assert 7200 <= cap < 7302, cap
    rng = np.random.default_rng(23)
    query, *templates = _profiles(rng, [30, 41, 55, 41, 7300])
    params = HMAPaliParams()
    ev = HMAPaliEval(params)
    n3 = dp_scores.dp_general_ragged.launches
    n7 = dp_engine.dp_forward_tb.launches
    scores, order = hmap_device.screen_hmap_device(
        query, templates, params, k=4, ev=ev, device=cuda)
    assert dp_scores.dp_general_ragged.launches == n3 + 1
    assert dp_engine.dp_forward_tb.launches == n7 + 1
    want = np.asarray([dp_pallas.forward_h_reference(
        [ev.build_costs(query, t)])[0, -1, -1] for t in templates],
        np.float32)
    np.testing.assert_array_equal(scores.view(np.uint32),
                                  want.view(np.uint32))
    assert list(order) == list(np.lexsort((np.arange(4), -want)))


def test_host_build_route_past_k3_cap_takes_k7(cuda):
    """ROADMAP C6: an ``HMAPaliEval`` subclass takes the host-build route; the
    7,300-residue template's bucket (past the vector form's cap) is scored
    on K7, every other bucket on K3, and every score equals ``dp_ref``."""
    from alignment_algos_tpu_torch.ops import dp_engine
    from alignment_algos_tpu_torch.parallel import screen
    from alignment_algos_tpu_torch.scoring.hmap_eval import HMAPaliEval
    from alignment_algos_tpu_torch.utils.params import HMAPaliParams

    class Subclass(HMAPaliEval):
        pass

    rng = np.random.default_rng(24)
    query, *templates = _profiles(rng, [30, 41, 55, 41, 7300])
    params = HMAPaliParams()
    n3 = dp_scores.dp_general_ragged.launches
    n7 = dp_engine.dp_forward_tb.launches
    scores, order = screen.screen_profiles(
        query, templates, lambda a, b: Subclass(params), k=4, device=cuda)
    assert dp_scores.dp_general_ragged.launches == n3 + 2
    assert dp_engine.dp_forward_tb.launches == n7 + 1
    ev = HMAPaliEval(params)
    want = np.asarray([dp_pallas.forward_h_reference(
        [ev.build_costs(query, t)])[0, -1, -1] for t in templates],
        np.float32)
    np.testing.assert_array_equal(scores.view(np.uint32),
                                  want.view(np.uint32))


@pytest.mark.parametrize("gi,ge", GAPS)
def test_sharded_screen_on_four_entries_of_one_card(cuda, gi, ge):
    """screen_library over a 4-entry mesh naming the card four times
    (K1 once per shard) equals the one-launch screen and the plain
    version's ranking."""
    from alignment_algos_tpu_torch.parallel import screen
    qc, tc, table = _inputs(300, 280, 1027, 41, True)
    mesh = screen.Mesh([torch.device("cuda", 0)] * 4, ("dp",))
    n1 = swaffine.sw_affine_scores.launches
    s, i = screen.screen_library(qc, tc, table, gi, ge, k=40, mesh=mesh)
    assert swaffine.sw_affine_scores.launches == n1 + 4
    s1, i1 = screen.screen_library(qc, tc, table, gi, ge, k=40, device=cuda)
    hs, hi = screen.screen_library_host(qc, tc, table, gi, ge, k=40,
                                        device=cuda)
    for ws, wi in ((s1, i1), (hs, hi)):
        np.testing.assert_array_equal(i, wi)
        np.testing.assert_array_equal(s.view(np.int32),
                                      np.asarray(ws, np.float32).view(
                                          np.int32))


def test_grid_on_one_card(cuda):
    """screen_grid on (1, 1) and on a (2, 2) mesh of the card: the same
    three arrays; every row's scores equal the plain version's, its top k
    the plain version's ranking."""
    from alignment_algos_tpu_torch.parallel import screen
    rng = np.random.default_rng(42)
    qs = rng.integers(0, 20, (13, 70))
    lib = rng.integers(0, 20, (37, 90))
    lib[3, 40:] = PAD
    table = np.full((21, 21), -1.0e4, np.float32)
    table[:20, :20] = rng.integers(-4, 12, (20, 20))
    one = screen.screen_grid(qs, lib, table, 4.73, 0.34, k=6,
                             mesh=screen.grid_mesh((1, 1), device=cuda))
    dev0 = torch.device("cuda", 0)
    four = screen.screen_grid(
        qs, lib, table, 4.73, 0.34, k=6,
        mesh=screen.Mesh(np.full((2, 2), dev0, dtype=object),
                         ("qb", "lib")))
    for a, b in zip(one, four):
        assert a.dtype == b.dtype
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(a, b)
    for r in range(len(qs)):
        q, t, tab, gap = swaffine.to_device(qs[r], lib, table, 4.73, 0.34,
                                            cuda)
        plain = swaffine.sw_affine_scores_plain(
            swaffine.skewed_similarity(q, t, tab), gap, q=70,
            t=90).cpu().numpy()
        np.testing.assert_array_equal(one[0][r].view(np.int32),
                                      plain.view(np.int32))
        hs, hi = screen.screen_library_host(qs[r], lib, table, 4.73, 0.34,
                                            k=6, device=cuda)
        np.testing.assert_array_equal(one[2][r], hi)


def test_k5_expf_replica_exhaustive(cuda):
    """Every float32 x with |x| < 87 through K5's glibc expf replica,
    against host libm bit for bit; the domain rule beyond.  With ka = ks =
    1, unit profiles and confidences and alpha = 1, the similarity of query
    row i is 1 * expf(((1 * (x_i * 1) / 1) * 1) * 1) = expf(x_i) exactly."""
    assert expf.host_libm_loaded(), "host libm expf not loaded"
    top = int(np.float32(87.0).view(np.int32))        # bits of 87.0
    chunk = 1 << 26
    t_one = torch.ones((1, 3, 1), device=cuda)
    t_conf = torch.ones((1, 3), device=cuda)
    checked = 0
    for sign in (0, 1 << 31):
        for lo in range(0, top, chunk):
            m = min(chunk, top - lo)
            bits = torch.arange(lo, lo + m, dtype=torch.int64,
                                device=cuda) | sign
            x = bits.to(torch.int32).view(torch.float32)
            q_z = torch.ones((m + 2, 1), device=cuda)
            q_z[1:-1, 0] = x
            ones = torch.ones((m + 2, 1), device=cuda)
            S = hmap_device.hmap_sim(ones, q_z, ones[:, 0].contiguous(),
                                     t_one, t_one, t_conf, 1.0)
            got = S[0, 1:-1, 1].cpu().numpy()
            want = native.expf(x.cpu().numpy())
            bad = np.flatnonzero(got.view(np.uint32) != want.view(np.uint32))
            assert bad.size == 0, (sign, lo + int(bad[0]), got[bad[0]],
                                   want[bad[0]])
            checked += m
    assert checked == 2 * top
    # the domain rule: 0 for x <= -87 where libm is still positive; +inf
    # and NaN similarities are zeroed by nan_to_num
    edge = torch.tensor([-86.99, 87.0, 88.0, np.inf, -87.0, -104.0,
                         -np.inf, np.nan], device=cuda)
    ones = torch.ones((edge.numel() + 2, 1), device=cuda)
    q_z = ones.clone()
    q_z[1:-1, 0] = edge
    args = (ones, q_z, ones[:, 0].contiguous(), t_one, t_one, t_conf, 1.0)
    got = hmap_device.hmap_sim(*args)
    assert _same(got, hmap_device.hmap_sim_plain(*args))
    got = got[0, 1:-1, 1].cpu()
    assert got[0] > 0 and got[1:].tolist() == [0.0] * 7


# ------------------------------------------------ K7 (DP builds with tracebacks)

def _k7_costs(rng, q2, t2, kind):
    """A cost model from random data: ``affine`` (gap-vector D, SEMI_LOCAL
    zero flags), ``gn2`` (full random D, a C term, distance offset 1),
    ``ties`` (integer S and costs) or ``big`` (S near 1e8, where an ulp
    exceeds the cost differences)."""
    c = random_costs(rng, q2, t2, AlignT.SEMI_LOCAL, kind == "affine")
    if kind == "gn2":
        D = rng.uniform(0.0, 9.0, (t2, t2)).astype(np.float32)
        D[np.subtract.outer(np.arange(t2), np.arange(t2)) > -2] = 0.0
        return DPCosts(S=c.S, D=D, A=c.A, B=c.B, ins_zero_head_q=False,
                       ins_zero_tail_q=False, ins_dist_offset=1,
                       C=rng.normal(0.0, 1.0, t2).astype(np.float32))
    if kind == "ties":
        c.S[1:-1, 1:-1] = rng.integers(-2, 3, (q2 - 2, t2 - 2))
        c.D[:] = np.round(c.D)
        c.A[:] = np.round(c.A)
        c.B[:] = 0.0
    if kind == "big":
        c.S[1:-1, 1:-1] = np.float32(1.0e8) + c.S[1:-1, 1:-1] * np.float32(3)
    return c


# the largest t2 that dp_engine.k7_plan keeps resident at q2 = 40 on a
# 16-block cluster with 232,448 bytes (test_k7_resident_edge checks it)
K7_RESIDENT_EDGE = 838

# (n, q2, t2, (q0, q1, t0, t1) or None for the whole matrix): odd shapes,
# sub-rectangles, 16 x 4 interior columns and one either side, a t2 with
# fewer interior columns than blocks, three pairs (three clusters), the
# resident edge and one column past it, and streamed shapes (slices wider
# than a block's threads, and a bounded one)
K7_SHAPES = [(1, 9, 7, None), (3, 13, 21, None), (2, 41, 33, None),
             (1, 16, 15, (2, 10, 3, 12)), (1, 16, 15, (1, 14, 1, 13)),
             (1, 16, 15, (4, 7, 2, 9)), (2, 130, 97, (7, 120, 11, 90)),
             (1, 386, 404, None), (1, 40, 65, None), (1, 40, 66, None),
             (1, 40, 67, None), (2, 20, 12, None), (3, 60, 67, None),
             (1, 40, K7_RESIDENT_EDGE, None),
             (1, 40, K7_RESIDENT_EDGE + 1, None), (1, 12, 7302, None),
             (2, 40, 3000, (3, 37, 100, 2950))]


def _k7_vs_plain(tabs, b):
    """K7 against its plain version as bits: H as an int32 view (NaN at
    the same places), PQ and PT equal."""
    from alignment_algos_tpu_torch.ops import dp_engine
    got = dp_engine.dp_forward_tb(*tabs, **b)
    torch.cuda.synchronize()
    want = dp_engine.dp_forward_tb_plain(*tabs, **b)
    assert _same_bits(got[0], want[0])
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


@pytest.mark.parametrize("kind", ["affine", "gn2", "ties", "big"])
@pytest.mark.parametrize("local", [False, True])
@pytest.mark.parametrize("n,q2,t2,bounds", K7_SHAPES)
def test_k7_equals_plain(cuda, n, q2, t2, bounds, local, kind):
    from alignment_algos_tpu_torch.ops import dp_engine
    rng = np.random.default_rng(q2 * 1000 + t2 + n)
    costs = [_k7_costs(rng, q2, t2, kind) for _ in range(n)]
    q0, q1, t0, t1 = bounds or (0, q2 - 1, 0, t2 - 1)
    b = dict(q0=q0, q1=q1, t0=t0, t1=t1, local=local)
    tabs = dp_engine.device_tables(costs, q0, q1, t0, t1, device=cuda)
    _k7_vs_plain(tabs, b)


def test_k7_resident_edge(cuda):
    """The card's plan for the resident edge: 16 blocks, resident at
    K7_RESIDENT_EDGE and streamed one column past it; the streamed shapes
    of K7_SHAPES stream."""
    from alignment_algos_tpu_torch.ops import dp_engine
    e = K7_RESIDENT_EDGE
    plans = [dp_engine.launch_plan(cuda, 40, t2, 0, 39, 0, t2 - 1)
             for t2 in (e, e + 1)]
    assert [(p.cluster, p.mode) for p in plans] == [(16, "resident"),
                                                    (16, "streamed")]
    assert dp_engine.launch_plan(cuda, 12, 7302, 0, 11, 0, 7301).mode \
        == "streamed"
    assert dp_engine.launch_plan(cuda, 386, 404, 0, 385, 0, 403).mode \
        == "resident"


def test_k7_negative_zero_model_matches_dp_ref(cuda):
    """S all -0.0 with zero D, A and B (ROADMAP C5), global mode: K7's H
    equals dp_ref's as bits (+0.0 everywhere), and its plain version."""
    from alignment_algos_tpu_torch.ops import dp_engine, dp_ref
    f32 = np.float32
    for q2, t2 in ((9, 8), (60, 67)):
        c = DPCosts(S=np.full((q2, t2), -0.0, f32), D=np.zeros((t2, t2), f32),
                    A=np.zeros(t2, f32), B=np.zeros(t2, f32),
                    ins_zero_head_q=False, ins_zero_tail_q=False)
        bounds = (0, q2 - 1, 0, t2 - 1)
        got = dp_engine.build_forward(c, *bounds, False, device=cuda)
        want = dp_ref.build_forward(c, *bounds, local=False)
        np.testing.assert_array_equal(got.H.view(np.int32),
                                      want.H.view(np.int32))
        np.testing.assert_array_equal(got.PQ, want.PQ)
        np.testing.assert_array_equal(got.PT, want.PT)
        tabs = dp_engine.device_tables([c], *bounds, device=cuda)
        _k7_vs_plain(tabs, dict(q0=0, q1=q2 - 1, t0=0, t1=t2 - 1,
                                local=False))


@pytest.mark.parametrize("local", [False, True])
def test_k7_matches_dp_ref(cuda, local):
    """Two pairs against the numpy/native engine, forward and reverse
    (bug_compat on and off), plus the batched build."""
    from alignment_algos_tpu_torch.ops import dp_engine, dp_ref
    rng = np.random.default_rng(12)
    costs = [_k7_costs(rng, 60, 47, kind) for kind in ("affine", "gn2")]
    costs[1].S[20, 1] += np.float32(200.0)   # a reverse insertion winner
    for c in costs:
        q1, t1 = c.q_size - 1, c.t_size - 1
        got = dp_engine.build_forward(c, 0, q1, 0, t1, local, device=cuda)
        want = dp_ref.build_forward(c, 0, q1, 0, t1, local=local)
        _same_results(got, want)
        for bug_compat in (True, False):
            got = dp_engine.build_reverse(c, 0, q1, 0, t1, local, bug_compat,
                                          device=cuda)
            want = dp_ref.build_reverse(c, 0, q1, 0, t1, local=local,
                                        bug_compat=bug_compat)
            _same_results(got, want)
    pair = [_k7_costs(rng, 60, 47, "affine") for _ in range(3)]
    for got, c in zip(dp_engine.build_forward_batched(pair, local,
                                                      device=cuda), pair):
        _same_results(got, dp_ref.build_forward(c, 0, 59, 0, 46, local=local))


def _same_results(got, want):
    """H as float32 bits (an int32 view), PQ and PT equal."""
    np.testing.assert_array_equal(got.H.view(np.int32), want.H.view(np.int32))
    np.testing.assert_array_equal(got.PQ, want.PQ)
    np.testing.assert_array_equal(got.PT, want.PT)


def test_k7_counts_launches_and_rejects_bad_input(cuda):
    from alignment_algos_tpu_torch.ops import dp_engine
    rng = np.random.default_rng(4)
    tabs = dp_engine.device_tables([_k7_costs(rng, 9, 8, "affine")], 0, 8,
                                   0, 7, device=cuda)
    b = dict(q0=0, q1=8, t0=0, t1=7)
    n = dp_engine.dp_forward_tb.launches
    dp_engine.dp_forward_tb(*tabs, **b)
    dp_engine.dp_forward_tb(*tabs, **b, local=True)
    assert dp_engine.dp_forward_tb.launches == n + 2
    with pytest.raises(ValueError):
        dp_engine.dp_forward_tb(tabs[0].cpu(), *tabs[1:], **b)
    with pytest.raises(TypeError):
        dp_engine.dp_forward_tb(tabs[0].double(), *tabs[1:], **b)
    with pytest.raises(ValueError):
        dp_engine.dp_forward_tb(*tabs, **dict(b, t1=8))


# ---------------------------------------------------- K8 (traceback decode)

def _k8_inputs(q, t, b, seed):
    """(B, Q) x (B, T) codes whose lanes cycle through eight kinds: the
    lane's query (a walk to i = 0 and j = 0), all wall, code 19 (its table
    row and column are negative: best score 0 without a wall), the query
    from row 4 (to j = 0), three codes then the query (to i = 0), the query
    less three rows (a gap in F), with three codes inserted (a gap in E),
    random; a table with a strong diagonal and the pad wall."""
    rng = np.random.default_rng(seed)
    qc = rng.integers(0, 19, (b, q))
    k = min(q, t) // 3

    def fit(x):
        x = list(x)[:t]
        return x + list(rng.integers(0, 19, t - len(x)))

    kinds = [lambda r: fit(r), lambda r: [PAD] * t, lambda r: [19] * t,
             lambda r: fit(r[4:]),
             lambda r: fit([*rng.integers(0, 19, 3), *r]),
             lambda r: fit([*r[:k], *r[k + 3:]]),
             lambda r: fit([*r[:k], *rng.integers(0, 19, 3), *r[k:]]),
             lambda r: fit(rng.integers(0, 19, t))]
    tc = np.asarray([kinds[n % 8](qc[n]) for n in range(b)])
    table = np.full((21, 21), -1.0e4, np.float32)
    table[:20, :20] = rng.integers(-4, 4, (20, 20))
    table[np.arange(19), np.arange(19)] = 11
    table[19, :20] = table[:20, 19] = -2
    return qc, tc, table


def _k8_vs_plain_and_numpy(tb, m, dat, q, t, b, mode=None, numpy=True):
    plan = swaffine.k8_plan(q, t, b, *tb.shape, mode=mode)
    n = swaffine.sw_decode.launches
    got = swaffine.sw_decode(tb, m, dat, q=q, t=t, b=b, plan=plan)
    torch.cuda.synchronize()
    assert swaffine.sw_decode.launches == n + 1
    want = swaffine.decode_tb_plain(tb, m, dat, q=q, t=t, b=b)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.equal(torch.nan_to_num(g), torch.nan_to_num(w))
    # the score is the value at the first maximum's row, bits and all
    mq = m[:q, :b].cpu().numpy()
    first = mq[np.argmax(mq, axis=0), np.arange(b)]
    np.testing.assert_array_equal(got[0].cpu().numpy().view(np.int32),
                                  first.view(np.int32))
    if not numpy:
        return got
    scores, paths = swaffine.decode_local_tracebacks(
        tb.cpu().numpy(), m.cpu().numpy(), dat.cpu().numpy(), q, t, nb=b)
    np.testing.assert_array_equal(got[0].cpu().numpy(), scores)
    assert swaffine._paths(got[1].cpu().numpy(), got[2].cpu().numpy(),
                           b) == paths
    return got


# Q = 1, 511, 513 (K2's query chunks) and 1031, odd T, B = 1, 10, 33, 5120;
# the FASTA screen's 512 x 512 x 10 and its --top_k 1024
K8_SHAPES = [(1, 1, 1), (1, 9, 10), (64, 515, 1), (33, 47, 10),
             (512, 512, 10), (511, 45, 33), (513, 39, 33), (1031, 77, 33),
             (40, 37, 5120), (512, 512, 1024)]
K8_MODES = ["windowed", "lane"]


@pytest.mark.parametrize("mode", K8_MODES)
@pytest.mark.parametrize("gi,ge", GAPS)
@pytest.mark.parametrize("q,t,b", K8_SHAPES)
def test_k8_equals_plain_and_numpy(cuda, q, t, b, gi, ge, mode):
    qc, tc, table = _k8_inputs(q, t, b, q * 3 + t * 5 + b)
    tb, m, dat = swaffine.sw_affine_tb(
        *swaffine.to_device(qc, tc, table, gi, ge, cuda))
    scores, rec_i, _ = _k8_vs_plain_and_numpy(tb, m, dat, q, t, b, mode)
    if b >= 3:                      # the wall and score-0 lanes stay dead
        assert scores[1].item() == scores[2].item() == 0.0
        assert (rec_i[:, 1:3] == -1).all()
    if b > 1:                       # m wider than the lanes decoded
        _k8_vs_plain_and_numpy(tb, m, dat, q, t, b - 1, mode)


def _k8_synthetic(q, t, b, kind, seed, dev):
    """Codes that steer every walk: ``diag`` all matches (d falls 2 a step,
    i 1: a 64 x 32 window is left through both edges at once), ``e`` an E
    gap never closed (d falls 1, i stays: the d-edge), ``f`` an F gap (d
    and i fall 1: the i-edge), ``mixed`` random codes with 0.2% stops,
    ``clamp`` those with every start past tb's last anti-diagonal (its
    reads clamp until the walk comes inside), ``pad`` those with tb, m and
    dat 5 rows and 3 lanes wider than q and b.  m's first maximum is
    planted at a random row and dat puts the walk's start anywhere in the
    row; lane 0 ties -0.0 and +0.0 (score -0.0, a dead lane), lane 1 has a
    NaN (it wins, the lane is dead), lane 2 ties its maximum at two rows
    (the lower starts the walk)."""
    rng = np.random.default_rng(seed)
    nd = q + t - 1
    rows, lanes_all = (q + 5, b + 3) if kind == "pad" else (q, b)
    shape = (nd, rows, lanes_all)
    if kind == "diag":
        tb = np.full(shape, 1, np.int8)
    elif kind == "e":
        tb = np.full(shape, 2 | 4, np.int8)
    elif kind == "f":
        tb = np.full(shape, 3 | 8, np.int8)
    else:
        tb = (rng.choice(np.array([1, 1, 1, 2, 3], np.int8), shape)
              | (rng.random(shape) < 0.6).astype(np.int8) * 4
              | (rng.random(shape) < 0.6).astype(np.int8) * 8)
        tb[rng.random(shape) < 0.002] = 0
    lanes = np.arange(b)
    m = rng.uniform(0.5, 9.0, (rows, lanes_all)).astype(np.float32)
    bi = rng.integers(0, q, b)
    m[bi, lanes] = 20.0
    dat = rng.integers(-5, nd + 5, (rows, lanes_all)).astype(np.int32)
    dat[bi, lanes] = bi + rng.integers(0, t, b)
    if kind == "clamp":
        dat[bi, lanes] = bi + nd + rng.integers(0, 40, b)
    if b >= 3:
        m[:, 0] = 0.0
        m[: q // 2 + 1, 0] = -0.0
        m[q // 2, 1] = np.nan
        if q >= 2:
            m[[0, q - 1], 2] = 30.0
            dat[0, 2] = rng.integers(0, t)
    return (torch.from_numpy(tb).to(dev), torch.from_numpy(m).to(dev),
            torch.from_numpy(dat).to(dev))


@pytest.mark.parametrize("mode", K8_MODES)
@pytest.mark.parametrize("kind", ["diag", "e", "f", "mixed", "clamp",
                                  "pad"])
@pytest.mark.parametrize("q,t,b", [(512, 512, 10), (200, 300, 40),
                                   (7, 90, 3), (90, 7, 3)])
def test_k8_window_edges_equal_plain_and_numpy(cuda, q, t, b, kind, mode):
    tb, m, dat = _k8_synthetic(q, t, b, kind, q + t + b, cuda)
    # the numpy decode indexes tb unclamped: a clamped start is the plain
    # version's (and the JAX loop's) alone
    scores, rec_i, rec_j = _k8_vs_plain_and_numpy(
        tb, m, dat, q, t, b, mode, numpy=kind != "clamp")
    assert np.signbit(scores[0].item()) and scores[0].item() == 0.0
    assert torch.isnan(scores[1])
    assert (rec_i[:, :2] == -1).all()
    if kind == "diag":              # one match a step from the start
        assert (rec_i[0, 3:] >= 0).all()


@pytest.mark.parametrize("mode", K8_MODES)
def test_k8_offsets_past_2_31(cuda, mode):
    """512 x 512 x 4200: tb holds 2.2e9 bytes, and the walks that start
    near its last anti-diagonal read offsets past 2^31."""
    q, t, b = 512, 512, 4200
    qc, tc, table = _k8_inputs(q, t, b, 31)
    tb, m, dat = swaffine.sw_affine_tb(
        *swaffine.to_device(qc, tc, table, 4.73, 0.34, cuda))
    assert tb.numel() > 2 ** 31
    _, rec_i, rec_j = _k8_vs_plain_and_numpy(tb, m, dat, q, t, b, mode)
    lanes = torch.arange(b, device=cuda, dtype=torch.int64)
    off = (((rec_i + rec_j).long() * q + rec_i.long()) * b + lanes)
    assert off[rec_i >= 0].max().item() >= 2 ** 31


def test_k8_counts_launches_and_rejects_bad_input(cuda):
    from alignment_algos_tpu_torch.ops import _build
    qc, tc, table = _k8_inputs(9, 11, 8, 0)
    tb, m, dat = swaffine.sw_affine_tb(
        *swaffine.to_device(qc, tc, table, 11.0, 1.0, cuda))
    kw = dict(q=9, t=11, b=8)
    n = swaffine.sw_decode.launches
    swaffine.sw_decode(tb, m, dat, **kw)
    swaffine.sw_decode(tb, m, dat, **dict(kw, b=3))
    assert swaffine.sw_decode.launches == n + 2
    with pytest.raises(ValueError):
        swaffine.sw_decode(tb, m.cpu(), dat, **kw)
    with pytest.raises(TypeError):
        swaffine.sw_decode(tb, m, dat.long(), **kw)
    with pytest.raises(ValueError):
        swaffine.sw_decode(tb[:, :, :4].contiguous(), m, dat, **kw)
    with pytest.raises(ValueError):
        swaffine.sw_decode(tb, m, dat, **dict(kw, q=10))
    with pytest.raises(ValueError):                  # another shape's plan
        swaffine.sw_decode(tb, m, dat, **kw, plan=swaffine.K8Plan(
            "windowed", *swaffine.K8_WINDOW))
    assert swaffine.sw_decode.launches == n + 2
    # the launcher itself refuses a plan that does not match the shapes
    out = torch.empty((3, 8 + 9 * 11 * 2), dtype=torch.int32, device=cuda)
    lib = _build.load().lib
    stream = torch.cuda.current_stream().cuda_stream
    for mode, dw, iw in ((1, 64, 9), (1, tb.shape[0], 8), (0, 1, 0),
                         (2, 0, 0)):
        err = lib.sw_decode_launch(
            tb.data_ptr(), m.data_ptr(), dat.data_ptr(), out[0].data_ptr(),
            out[1].data_ptr(), out[2].data_ptr(), 9, 11, 8, *tb.shape,
            m.shape[1], mode, dw, iw, stream)
        assert err != 0, (mode, dw, iw)
