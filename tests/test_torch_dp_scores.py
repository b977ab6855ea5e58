"""The port's exact general-gap DP (K3's plain version, through
``ops/dp_scores`` and ``ops/dp_pallas``) against the JAX package: the
Pallas kernels in interpret mode (``dp_scores`` scores, ``dp_pallas`` full
H) and the numpy ``dp_ref`` engine, on the same cost models.  Tolerance 0
everywhere: scores and H matrices are compared with
``np.testing.assert_array_equal``.  The port gets each cost model as its
own ``DPCosts`` over the same arrays (:func:`port_costs`)."""

import dataclasses

import numpy as np
import pytest
import torch

from alignment_algos_tpu.ops import dp_pallas as jdp
from alignment_algos_tpu.ops import dp_ref
from alignment_algos_tpu.ops import dp_scores as jds
from alignment_algos_tpu.scoring.base import DPCosts, affine_deletion_table
from alignment_algos_tpu.utils.params import AlignT
from alignment_algos_tpu_torch.ops import dp_pallas, dp_scores
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


def vec_costs(rng, q2, t2, align_type, zero_flags):
    """A cost model whose D is the affine table of two gap vectors, with
    the vectors attached (the HMAP form: the port rebuilds D from them)."""
    c = random_costs(rng, q2, t2, align_type, zero_flags)
    gi = rng.uniform(0.5, 5.0, t2).astype(np.float32)
    ge = rng.uniform(0.05, 1.0, t2).astype(np.float32)
    D = affine_deletion_table(np.minimum(gi[:, None], gi[None, :]),
                              np.minimum(ge[:, None], ge[None, :]),
                              align_type)
    return DPCosts(S=c.S, D=D, A=c.A, B=c.B, ins_zero_head_q=zero_flags,
                   ins_zero_tail_q=zero_flags, del_gi_vec=gi, del_ge_vec=ge,
                   del_align=align_type)


def ref_h(costs, local=False):
    return np.stack([dp_ref.build_forward(
        c, 0, c.q_size - 1, 0, c.t_size - 1, local=local).H for c in costs])


def check_all(costs, local=False):
    """Port scores and H against dp_ref, JAX dp_scores and dp_pallas
    (interpret mode)."""
    want = ref_h(costs, local)
    mine = [port_costs(c) for c in costs]
    H = dp_pallas.forward_h_batched(mine, local=local, device=CPU)
    np.testing.assert_array_equal(H, want)
    sc = dp_scores.forward_scores_batch(mine, local=local, device=CPU)
    assert sc.dtype == np.float32 and sc.shape == (len(costs),)
    np.testing.assert_array_equal(sc, want[:, -1, -1])
    np.testing.assert_array_equal(
        sc, jds.forward_scores_batch(costs, local=local, interpret=True))
    np.testing.assert_array_equal(
        H, jdp.forward_h_batched(costs, local=local, interpret=True))


# every align mode: the ins_zero_* flags and _DEL_FREE_OVERHANG_MODES
CASES = [
    (8, 9, AlignT.GLOBAL, False, False, False),
    (9, 7, AlignT.SEMI_LOCAL, True, False, True),
    (10, 10, AlignT.GLOBAL, False, True, True),
    (14, 11, AlignT.GLOBAL_LOCAL, True, False, True),
    (7, 13, AlignT.LOCAL, True, True, True),
    (12, 15, AlignT.LOCAL_GLOBAL, False, False, True),
    (11, 6, AlignT.LOCAL_GLOBAL, True, True, False),
    (33, 18, AlignT.GLOBAL, False, False, False),
]


@pytest.mark.parametrize("q2,t2,atype,zf,local,vec_d", CASES)
def test_plain_matches_jax_and_dp_ref(q2, t2, atype, zf, local, vec_d):
    rng = np.random.default_rng(q2 * 1000 + t2)
    make = vec_costs if vec_d else random_costs
    check_all([make(rng, q2, t2, atype, zf)], local)


@pytest.mark.parametrize("vec_d", [False, True])
def test_batch_not_a_multiple_of_8(vec_d):
    """Ten pairs: one TPU group of 8 and a padded one; the port has no
    groups."""
    rng = np.random.default_rng(42)
    make = vec_costs if vec_d else random_costs
    check_all([make(rng, 12, 15, AlignT.SEMI_LOCAL, True)
               for _ in range(10)])


@pytest.mark.parametrize("local", [False, True])
def test_with_c_column_and_offset(local):
    """gn2-style generalized insertion: extra C[j] term and dist offset."""
    rng = np.random.default_rng(7)
    costs = []
    for _ in range(3):
        c = random_costs(rng, 13, 12, AlignT.GLOBAL, False)
        costs.append(DPCosts(S=c.S, D=c.D, A=c.A, B=c.B,
                             ins_zero_head_q=False, ins_zero_tail_q=False,
                             C=rng.normal(0, 1, 12).astype(np.float32),
                             ins_dist_offset=1))
    check_all(costs, local)


@pytest.mark.parametrize("q2,t2", [(2, 5), (5, 2), (2, 2)])
def test_tiny_shapes_route_to_dp_ref(q2, t2):
    rng = np.random.default_rng(3)
    c = random_costs(rng, q2, t2, AlignT.GLOBAL, False)
    want = ref_h([c])
    mine = [port_costs(c)]
    np.testing.assert_array_equal(
        dp_pallas.forward_h_batched(mine, device=CPU), want)
    np.testing.assert_array_equal(
        dp_scores.forward_scores_batch(mine, device=CPU), want[:, -1, -1])
    np.testing.assert_array_equal(
        dp_scores.forward_scores_batch(mine, device=CPU),
        jds.forward_scores_batch([c], interpret=True))


def test_hmap_cost_model_and_forward_result():
    """HMAP profile-profile costs (the port's evaluator on the port's
    profiles) through the port's full-H path: H equal to the reference
    DPMatrix build on the same files, traceback pointers left NULL."""
    import os

    from alignment_algos_tpu.core.dp import DPMatrix
    from alignment_algos_tpu.scoring.hmap_eval import HMAPaliEval
    from alignment_algos_tpu.seq.hmap import HMAPSequence
    from alignment_algos_tpu.utils.params import HMAPaliParams
    from alignment_algos_tpu_torch.scoring import hmap_eval as thmap_eval
    from alignment_algos_tpu_torch.seq import hmap as thmap

    data = os.path.join(os.path.dirname(__file__), "golden", "inputs")
    files = [os.path.join(data, f) for f in ("qA.prof", "tA.prof")]
    query, templ = (HMAPSequence.from_file(f) for f in files)
    params = HMAPaliParams()
    dpm = DPMatrix(query, templ, HMAPaliEval(params), "fwd",
                   params.align_type)
    c = thmap_eval.HMAPaliEval(tparams.HMAPaliParams()).build_costs(
        *(thmap.HMAPSequence.from_file(f) for f in files))
    res = dp_pallas.forward_result(c, device=CPU)
    np.testing.assert_array_equal(res.H, dpm.res.H)
    assert (res.PQ == dp_ref.NULL).all() and (res.PT == dp_ref.NULL).all()
    np.testing.assert_array_equal(
        dp_scores.forward_scores_batch([c], device=CPU), res.H[-1:, -1])


def test_wrapper_routes_cpu_tensors_to_the_plain_version():
    """On CPU tensors K3's wrapper is its plain version (no launch), and
    it rejects what the kernel does not take."""
    rng = np.random.default_rng(5)
    ref = vec_costs(rng, 9, 11, AlignT.SEMI_LOCAL, True)
    c = port_costs(ref)
    Cm, ins0, insc, dclose = jdp._host_tables(ref, 0, 8, 0, 10)
    for a, b in zip(dp_pallas._host_tables(c, 0, 8, 0, 10),
                    (Cm, ins0, insc, dclose)):
        np.testing.assert_array_equal(a, b)
    tabs = [torch.from_numpy(np.ascontiguousarray(x, np.float32)[None])
            for x in (c.S, c.D, Cm, ins0, insc, dclose)]
    n = dp_scores.dp_general.launches
    for full_h in (False, True):
        got = dp_scores.dp_general(*tabs, full_h=full_h)
        want = dp_scores.dp_general_plain(*tabs, full_h=full_h)
        assert torch.equal(got, want)
    assert dp_scores.dp_general.launches == n
    with pytest.raises(TypeError):
        dp_scores.dp_general(tabs[0].double(), *tabs[1:])
    with pytest.raises(ValueError):
        dp_scores.dp_general(tabs[0][:, :, :3].contiguous(), *tabs[1:])
    with pytest.raises(ValueError):
        dp_scores.dp_general(*tabs[:5], tabs[5].t())
    other = port_costs(vec_costs(rng, 9, 12, AlignT.SEMI_LOCAL, True))
    for bad in ([], [c, other]):
        with pytest.raises(ValueError):
            dp_scores.forward_scores_batch(bad, device=CPU)
        with pytest.raises(ValueError):
            dp_pallas.forward_h_batched(bad, device=CPU)


# ------------------------------------------- the ragged wrapper (vector form)

def _assert_bits(got, want):
    """Tolerance 0 as float32 bits: NaN at the same places, every other
    value equal as int32 (so -0.0 != +0.0)."""
    got, want = (np.asarray(x, np.float32) for x in (got, want))
    assert got.shape == want.shape
    nan = np.isnan(got)
    np.testing.assert_array_equal(nan, np.isnan(want))
    np.testing.assert_array_equal(got[~nan].view(np.int32),
                                  want[~nan].view(np.int32))


def _ragged_bucket(costs):
    """One bucket of ``dp_general_ragged``'s input from same-shape vec_d
    cost models (the port's tensors over the same arrays)."""
    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32))
    return (t(np.stack([c.S for c in costs])),
            t(np.stack([np.stack([c.del_gi_vec, c.del_ge_vec])
                        for c in costs])),
            t(np.stack([c.A for c in costs])),
            t(np.stack([c.B for c in costs])), None)


def _ragged_flags(c):
    return dict(zero_head=bool(c.ins_zero_head_q),
                zero_tail=bool(c.ins_zero_tail_q), off=2,
                del_free=c.del_align in tbase._DEL_FREE_OVERHANG_MODES)


RAGGED_SHAPES = [(9, 7), (12, 15), (20, 11), (9, 16), (3, 3)]


@pytest.mark.parametrize("local", [False, True])
@pytest.mark.parametrize("atype", list(AlignT))
def test_ragged_cpu_route_matches_jax(atype, local):
    """Five shapes (two pairs each) in one call, every alignment type
    (``del_free`` and the ins_zero flags among them): the CPU route equals
    the JAX kernel in interpret mode and dp_ref, bit for bit."""
    rng = np.random.default_rng(int(atype) * 10 + local)
    zf = atype in tbase._INS_FREE_OVERHANG_MODES
    buckets = [[vec_costs(rng, q2, t2, atype, zf) for _ in range(2)]
               for q2, t2 in RAGGED_SHAPES]
    n = dp_scores.dp_general_ragged.launches
    got = dp_scores.dp_general_ragged(
        [_ragged_bucket(b) for b in buckets], local=local,
        **_ragged_flags(buckets[0][0]))
    assert dp_scores.dp_general_ragged.launches == n
    want = np.concatenate([jds.forward_scores_batch(b, local=local,
                                                    interpret=True)
                           for b in buckets])
    _assert_bits(got.numpy(), want)
    _assert_bits(got.numpy(), np.concatenate(
        [ref_h(b, local)[:, -1, -1] for b in buckets]))


def _special_costs(rng, kind, q2, t2, atype):
    """A vec_d cost model whose S or gap vectors hold -0.0 or NaN.

    ``zero_s``: S[1:, 1:] is -0.0 on the diagonal (q2 == t2) and negative
    elsewhere, so the diagonal of H holds -0.0 and the closing cell is a
    tie of the -0.0 match with a +0.0 deletion (``dclose[t1 - 1]`` is 0):
    the ordered maximum gives +0.0, global and local.  ``zero_gaps``: some
    gap and insertion
    vector entries are -0.0 and some S entries too.  ``nan_s``: one NaN
    similarity.  ``nan_gaps``: one NaN gap-init entry."""
    zf = atype in tbase._INS_FREE_OVERHANG_MODES
    c = vec_costs(rng, q2, t2, atype, zf)
    S, gi, ge = c.S.copy(), c.del_gi_vec.copy(), c.del_ge_vec.copy()
    A, B = c.A.copy(), c.B.copy()
    if kind == "zero_s":
        S[1:, 1:] = -np.abs(S[1:, 1:]) - np.float32(0.5)
        idx = np.arange(1, q2)
        S[idx, idx] = -0.0
    elif kind == "zero_gaps":
        gi[::3] = -0.0
        ge[1::2] = -0.0
        A[::2] = -0.0
        B[1::3] = -0.0
        S[rng.random(S.shape) < 0.3] = -0.0
        S[-1, -1] = -0.0
    elif kind == "nan_s":
        S[q2 // 2, t2 // 2] = np.nan
    else:
        gi[t2 // 2] = np.nan
    D = affine_deletion_table(np.minimum.outer(gi, gi).astype(np.float32),
                              np.minimum.outer(ge, ge).astype(np.float32),
                              atype)
    return DPCosts(S=S, D=D, A=A, B=B, ins_zero_head_q=zf,
                   ins_zero_tail_q=zf, del_gi_vec=gi, del_ge_vec=ge,
                   del_align=atype)


@pytest.mark.parametrize("local", [False, True])
@pytest.mark.parametrize("atype", [AlignT.GLOBAL, AlignT.SEMI_LOCAL])
@pytest.mark.parametrize("kind", ["zero_s", "zero_gaps", "nan_s",
                                  "nan_gaps"])
def test_ragged_signed_zero_and_nan_match_jax(kind, atype, local):
    """-0.0 and NaN in S and in the gap vectors: the CPU route equals the
    JAX kernel in interpret mode as float32 bits (the sign of a zero score
    and NaN at the same places)."""
    rng = np.random.default_rng(len(kind) * 7 + int(atype) + local)
    buckets = [[_special_costs(rng, kind, q2, q2, atype) for _ in range(2)]
               for q2 in (11, 17)]
    got = dp_scores.dp_general_ragged(
        [_ragged_bucket(b) for b in buckets], local=local,
        **_ragged_flags(buckets[0][0])).numpy()
    want = np.concatenate([jds.forward_scores_batch(b, local=local,
                                                    interpret=True)
                           for b in buckets])
    _assert_bits(got, want)
    if kind == "zero_s":
        # the case pins the tie of a -0.0 match and a +0.0 deletion
        assert (got == 0).all() and not np.signbit(got).any()
    if kind.startswith("nan"):
        assert np.isnan(got).all()


def test_ragged_descriptors_address_each_pair():
    """The launch's pair descriptors (``struct Pair`` of dp_general.cu) on
    three buckets, one with a C term: each address is the pair's row of
    its tensor, H slices follow the buckets, slots the bucket order."""
    rng = np.random.default_rng(13)
    buckets = []
    for n, q2, t2, with_c in ((2, 9, 7, False), (3, 5, 12, True),
                              (1, 6, 4, False)):
        b = _ragged_bucket([vec_costs(rng, q2, t2, AlignT.GLOBAL, False)
                            for _ in range(n)])
        buckets.append(b[:4] + ((b[2] + 1.0,) if with_c else (None,)))
    H = torch.empty(sum(b[0].numel() for b in buckets))
    pairs = dp_scores._ragged_descriptors(buckets, H)
    assert pairs.dtype.itemsize == 72 and len(pairs) == 6
    k, h = 0, H.data_ptr()
    for S, G, A, B, C in buckets:
        n, q2, t2 = S.shape
        for p in range(n):
            d = pairs[k]
            assert (d["q2"], d["t2"], d["slot"]) == (q2, t2, k)
            assert d["S"] == S[p].data_ptr() and d["H"] == h
            assert (d["c0"], d["c1"]) == (G[p, 0].data_ptr(),
                                          G[p, 1].data_ptr())
            assert (d["c2"], d["c3"]) == (A[p].data_ptr(), B[p].data_ptr())
            assert d["c4"] == (0 if C is None else C[p].data_ptr())
            k, h = k + 1, h + 4 * q2 * t2


def test_ragged_wrapper_rejects_bad_input():
    rng = np.random.default_rng(12)
    b = _ragged_bucket([vec_costs(rng, 9, 8, AlignT.GLOBAL, False)])
    S, G, A, B, _ = b
    for bad, err in (([], ValueError),
                     ([(S.double(), G, A, B, None)], TypeError),
                     ([(S, G[:, :1].contiguous(), A, B, None)], ValueError),
                     ([(S, G, A, B, A[:, :3].contiguous())], ValueError),
                     ([(S[:, :2].contiguous(), G, A, B, None)], ValueError),
                     ([(S.transpose(1, 2), G, A, B, None)], ValueError)):
        with pytest.raises(err):
            dp_scores.dp_general_ragged(bad)
