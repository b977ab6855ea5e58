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
