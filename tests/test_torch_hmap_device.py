"""The port's HMAP similarity producer (K5 + K6 plain versions) and profile
screens against the JAX package and the host path, on the CPU.

Tolerance 0: similarity matrices are compared bit for bit (as uint32),
scores bit for bit and orders exactly, on the inputs of
tests/test_hmap_device.py.  Each side parses the same profile text with its
own package's classes."""

from __future__ import annotations

import io
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alignment_algos_tpu import native
from alignment_algos_tpu.ops import hmap_device as jhd
from alignment_algos_tpu.parallel.screen import screen_profiles as jscreen
from alignment_algos_tpu.scoring.hmap_eval import HMAPaliEval
from alignment_algos_tpu.seq.hmap import HMAPSequence
from alignment_algos_tpu.utils.hmath import seq_sum_f32
from alignment_algos_tpu.utils.params import HMAPaliParams
from alignment_algos_tpu_torch.ops import expf, hmap_device
from alignment_algos_tpu_torch.parallel.screen import screen_profiles
from alignment_algos_tpu_torch.scoring import hmap_eval as thmap_eval
from alignment_algos_tpu_torch.seq import hmap as thmap
from alignment_algos_tpu_torch.utils import params as tparams

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
if os.path.join(ROOT, "tools") not in sys.path:
    sys.path.insert(0, os.path.join(ROOT, "tools"))


def _texts(rng, n, length):
    from make_profiles import make_profile
    return [make_profile(rng, f"s{i}", length) for i in range(n)]


def _parse(texts, cls=HMAPSequence):
    return [cls.from_stream(io.StringIO(t)) for t in texts]


def _profiles(rng, n, length):
    """n profiles of one length, parsed by the JAX package and by the port
    (same text)."""
    texts = _texts(rng, n, length)
    return _parse(texts), _parse(texts, thmap.HMAPSequence)


def _port_params(params):
    """The port's HMAPaliParams with the same settings as ``params``."""
    out = tparams.HMAPaliParams()
    out.__dict__.update(params.__dict__)
    return out


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


def _port_similarity(query, templates, params):
    ev = thmap_eval.HMAPaliEval(params)
    lib = hmap_device.DeviceLibrary(templates, ev, device=CPU)
    (t2, b), = lib.buckets.items()
    qp = {k: torch.from_numpy(v)
          for k, v in hmap_device.pack_sequence(query).items()}
    return hmap_device.build_similarity_device(
        qp["aa"], qp["zsse"], qp["conf"], b["aa"], b["zsse"], b["conf"],
        float(np.float32(params.alpha)),
        float(-np.float32(params.zero_shift)),
        normalize=bool(params.normalize_mtx)).numpy()


def _jax_similarity(query, templates, params):
    lib = jhd.DeviceLibrary(templates, HMAPaliEval(params))
    (t2, b), = lib.buckets.items()
    qp = jhd.pack_sequence(query)
    return np.asarray(jhd.build_similarity_device(
        jnp.asarray(qp["aa"]), jnp.asarray(qp["zsse"]),
        jnp.asarray(qp["conf"]), b["aa"], b["zsse"], b["conf"],
        jnp.float32(np.float32(params.alpha)),
        jnp.float32(np.float32(-np.float32(params.zero_shift))),
        jnp.uint32(0), q2=query.size(), t2=t2,
        normalize=bool(params.normalize_mtx)))


@pytest.mark.parametrize("length,n,normalize", [(30, 5, True), (61, 3, True),
                                                (24, 2, False)])
def test_similarity_bit_equal_to_jax_and_host(length, n, normalize):
    rng = np.random.default_rng(7 if normalize else 8)
    params = HMAPaliParams()
    params.normalize_mtx = normalize
    seqs, mine = _profiles(rng, n + 1, length)
    query, templates = seqs[0], seqs[1:]
    got = _port_similarity(mine[0], mine[1:], _port_params(params))
    np.testing.assert_array_equal(
        _bits(got), _bits(_jax_similarity(query, templates, params)))
    ev = HMAPaliEval(params)
    for i, t in enumerate(templates):
        np.testing.assert_array_equal(_bits(got[i]),
                                      _bits(ev.build_costs(query, t).S))


def test_device_library_from_jax():
    """The port's library built from the JAX library holds the same state
    as one built from the templates."""
    rng = np.random.default_rng(10)
    texts = _texts(rng, 2, 28) + _texts(rng, 2, 44)
    ts = _parse(texts)
    mine = hmap_device.DeviceLibrary(
        _parse(texts, thmap.HMAPSequence),
        thmap_eval.HMAPaliEval(tparams.HMAPaliParams()), device=CPU)
    theirs = hmap_device.DeviceLibrary.from_jax(
        jhd.DeviceLibrary(ts, HMAPaliEval(HMAPaliParams())), device=CPU)
    assert list(mine.buckets) == list(theirs.buckets) == [30, 46]
    assert theirs.templates is ts
    for t2, b in mine.buckets.items():
        o = theirs.buckets[t2]
        assert b["idx"] == o["idx"]
        for key in ("aa", "zsse", "conf", "D", "A", "B"):
            assert o[key].dtype == torch.float32 and o[key].device == CPU
            # bit for bit: the sentinel rows of zsse are NaN
            np.testing.assert_array_equal(_bits(b[key]), _bits(o[key]),
                                          err_msg=f"{t2} {key}")


def test_screen_hmap_device_equals_jax():
    rng = np.random.default_rng(9)
    params = HMAPaliParams()
    seqs, mine = _profiles(rng, 7, 30)
    query, templates = seqs[0], seqs[1:]
    ev = HMAPaliEval(params)
    lib = hmap_device.DeviceLibrary.from_jax(jhd.DeviceLibrary(templates, ev),
                                             device=CPU)
    scores, order = hmap_device.screen_hmap_device(
        mine[0], mine[1:], _port_params(params), k=4, library=lib,
        device=CPU)
    j_scores, j_order = jhd.screen_hmap_device(query, templates, params, k=4,
                                               engine="xla")
    np.testing.assert_array_equal(_bits(scores), _bits(j_scores))
    np.testing.assert_array_equal(order, j_order)


@pytest.mark.parametrize("align_type", ["SEMI_LOCAL", "GLOBAL",
                                        "LOCAL_GLOBAL"])
def test_screen_hmap_device_ragged_library_equals_jax(align_type):
    """Seven templates over four lengths (one ragged K3 call on the port's
    side): scores bit for bit and the order equal to the JAX package's
    ``screen_hmap_device`` and to its Pallas scores kernel in interpret
    mode on the host costs, in the flag sets of three alignment types."""
    from alignment_algos_tpu.ops import dp_scores as jds
    from alignment_algos_tpu.utils.params import AlignT

    rng = np.random.default_rng(11)
    params = HMAPaliParams()
    params.align_type = AlignT[align_type]
    texts = (_texts(rng, 1, 30) + _texts(rng, 2, 21) + _texts(rng, 2, 38)
             + _texts(rng, 1, 13) + _texts(rng, 1, 27))
    texts.append(texts[3])                           # a tie
    query, *templates = _parse(texts)
    mq, *_ = _parse(texts, thmap.HMAPSequence)
    ev = HMAPaliEval(params)
    jlib = jhd.DeviceLibrary(templates, ev)
    assert len(jlib.buckets) == 4 and len(templates) == 7
    lib = hmap_device.DeviceLibrary.from_jax(jlib, device=CPU)
    mparams = _port_params(params)
    mparams.align_type = tparams.AlignT[align_type]
    n =hmap_device.dp_scores.dp_general_ragged.launches
    scores, order = hmap_device.screen_hmap_device(
        mq, None, mparams, k=7, library=lib, device=CPU)
    assert hmap_device.dp_scores.dp_general_ragged.launches == n
    j_scores, j_order = jhd.screen_hmap_device(query, templates, params, k=7,
                                               engine="xla", library=jlib)
    np.testing.assert_array_equal(_bits(scores), _bits(j_scores))
    np.testing.assert_array_equal(order, j_order)
    want = np.zeros(len(templates), np.float32)
    for b in jlib.buckets.values():
        want[b["idx"]] = jds.forward_scores_batch(
            [ev.build_costs(query, templates[i]) for i in b["idx"]],
            interpret=True)
    np.testing.assert_array_equal(_bits(scores), _bits(want))


def test_screen_profiles_mixed_lengths_equals_jax():
    """Several length buckets, ties broken by index."""
    rng = np.random.default_rng(10)
    params = HMAPaliParams()
    texts = (_texts(rng, 1, 40) + _texts(rng, 2, 28) + _texts(rng, 2, 44)
             + _texts(rng, 1, 28))
    texts.append(texts[2])                           # a tie
    q, *ts = _parse(texts)
    mq, *mts = _parse(texts, thmap.HMAPSequence)
    mparams = _port_params(params)
    scores, order = screen_profiles(
        mq, mts, lambda a, b: thmap_eval.HMAPaliEval(mparams), k=6,
        device=CPU)
    j_scores, j_order = jscreen(q, ts, lambda a, b: HMAPaliEval(params), k=6,
                                engine="xla")
    np.testing.assert_array_equal(_bits(scores), _bits(j_scores))
    np.testing.assert_array_equal(order, j_order)
    assert list(order).index(1) < list(order).index(5)


@pytest.mark.parametrize("evaluator", ["Hmap2Eval", "Gn2Eval"])
def test_screen_profiles_smap_templates_equal_jax(evaluator):
    """SMAP structure templates: Hmap2Eval routes to the device producer,
    Gn2Eval (its own similarity, full D, a C term) to host costs + K3."""
    from alignment_algos_tpu.scoring import gn2_eval, hmap2_eval
    from alignment_algos_tpu.structure import smap
    from alignment_algos_tpu_torch.scoring import gn2_eval as tgn2_eval
    from alignment_algos_tpu_torch.scoring import hmap2_eval as thmap2_eval
    from alignment_algos_tpu_torch.structure import smap as tsmap

    files = [os.path.join(DATA, fn) for fn in
             ("templ_smap.prof", "templ_big.prof", "templ_smap.prof")]
    qfile = os.path.join(DATA, "query30.prof")
    scores = {}
    for tag, g, h, sm, hm in (
            ("jax", gn2_eval, hmap2_eval, smap, HMAPSequence),
            ("port", tgn2_eval, thmap2_eval, tsmap, thmap.HMAPSequence)):
        ts = [sm.SMAPSequence.from_file(fn, gn2=True) for fn in files]
        cls = {"Hmap2Eval": h.Hmap2Eval, "Gn2Eval": g.Gn2Eval}[evaluator]
        params = g.Gn2Params()
        factory = lambda q, t: cls(params)           # noqa: E731
        if tag == "jax":
            scores[tag] = jscreen(hm.from_file(qfile), ts, factory, k=3,
                                  engine="xla")
        else:
            scores[tag] = screen_profiles(hm.from_file(qfile), ts, factory,
                                          k=3, device=CPU)
    (scores, order), (j_scores, j_order) = scores["port"], scores["jax"]
    np.testing.assert_array_equal(_bits(scores), _bits(j_scores))
    np.testing.assert_array_equal(order, j_order)


def test_serial_sums_equal_seq_sum_f32_on_a_large_region():
    """66,000 elements per row (about a 258 x 258 region): the serial chain
    equals hmath.seq_sum_f32; torch.sum and torch.cumsum round otherwise
    on these rows, which is why the plain z-norm loops."""
    rng = np.random.default_rng(2024)
    v = (rng.standard_normal((4, 66000)) * 3.0 + 0.7).astype(np.float32)
    acc, acc2 = hmap_device.serial_sums(torch.from_numpy(v))
    np.testing.assert_array_equal(_bits(acc), _bits(seq_sum_f32(v, axis=1)))
    np.testing.assert_array_equal(_bits(acc2),
                                  _bits(seq_sum_f32(v * v, axis=1)))
    t = torch.from_numpy(v)
    assert not torch.equal(t.sum(dim=1), acc)
    assert not torch.equal(torch.cumsum(t, dim=1)[:, -1], acc)


def test_sqrt_rn_is_correctly_rounded():
    """The z-norm's standard deviation: float32 torch.sqrt on the CPU
    misrounds some inputs (0x1.07ee0ep-7, the variance of the SMAP fixture's
    similarity, is one), so the plain version rounds a float64 sqrt."""
    rng = np.random.default_rng(0)
    x = np.concatenate([[float.fromhex("0x1.07ee0ep-7")],
                        rng.uniform(1e-6, 100.0, 200000)]).astype(np.float32)
    want = np.sqrt(x.astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(
        _bits(hmap_device.sqrt_rn(torch.from_numpy(x))), _bits(want))
    special = torch.tensor([-1.0, 0.0, np.inf, np.nan])
    got = hmap_device.sqrt_rn(special)
    assert torch.isnan(got[0]) and got[1] == 0 and torch.isinf(got[2])
    assert torch.isnan(got[3]) and got.dtype == torch.float32


def test_expf_plain_is_host_libm_with_the_domain_rule():
    assert expf.host_libm_loaded()
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.uniform(-86.9, 86.9, 5000),
                        rng.normal(0.0, 2.0, 5000)]).astype(np.float32)
    got = expf.expf_plain(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(native.expf(x)))
    edge = np.array([87.0, 87.5, 100.0, np.inf, -87.0, -87.5, -np.inf,
                     np.nan], np.float32)
    got = expf.expf_plain(torch.from_numpy(edge)).numpy()
    assert list(got[:4]) == [np.inf] * 4
    assert list(got[4:7]) == [0.0] * 3 and not np.signbit(got[4:7]).any()
    assert np.isnan(got[7])


def test_k5_k6_wrappers_route_cpu_tensors_to_the_plain_versions():
    rng = np.random.default_rng(4)
    _, seqs = _profiles(rng, 3, 20)
    ev = thmap_eval.HMAPaliEval(tparams.HMAPaliParams())
    lib = hmap_device.DeviceLibrary(seqs[1:], ev, device=CPU)
    (t2, b), = lib.buckets.items()
    qp = {k: torch.from_numpy(v)
          for k, v in hmap_device.pack_sequence(seqs[0]).items()}
    args = (qp["aa"], qp["zsse"], qp["conf"], b["aa"], b["zsse"], b["conf"],
            0.5)
    n5, n6 = hmap_device.hmap_sim.launches, hmap_device.hmap_znorm.launches
    raw = hmap_device.hmap_sim(*args)
    assert torch.equal(raw, hmap_device.hmap_sim_plain(*args))
    for normalize in (True, False):
        assert torch.equal(
            hmap_device.hmap_znorm(raw, -0.12, normalize=normalize),
            hmap_device.hmap_znorm_plain(raw, -0.12, normalize=normalize))
    assert (hmap_device.hmap_sim.launches,
            hmap_device.hmap_znorm.launches) == (n5, n6)
    with pytest.raises(TypeError):
        hmap_device.hmap_znorm(raw.double(), -0.12)
    with pytest.raises(ValueError):
        hmap_device.hmap_sim(*args[:3], b["aa"][:, :, :5].contiguous(),
                             *args[4:])
