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
    n5 = hmap_device.hmap_sim_ragged.launches
    n6 = hmap_device.hmap_znorm_ragged.launches
    raw = hmap_device.hmap_sim(*args)
    assert torch.equal(raw, hmap_device.hmap_sim_plain(*args))
    for normalize in (True, False):
        assert torch.equal(
            hmap_device.hmap_znorm(raw, -0.12, normalize=normalize),
            hmap_device.hmap_znorm_plain(raw, -0.12, normalize=normalize))
    assert (hmap_device.hmap_sim_ragged.launches,
            hmap_device.hmap_znorm_ragged.launches) == (n5, n6)
    with pytest.raises(TypeError):
        hmap_device.hmap_znorm(raw.double(), -0.12)
    with pytest.raises(ValueError):
        hmap_device.hmap_sim(*args[:3], b["aa"][:, :, :5].contiguous(),
                             *args[4:])


# ------------------------------------------------- K5 over a whole screen

def _sim_stacks(rng, shapes, ka=20, ks=3):
    """Random template stacks (t_aa, t_zsse, t_conf) of the given (n, t2)."""
    return [tuple(torch.from_numpy(rng.standard_normal(sh).astype(
                      np.float32))
                  for sh in ((n, t2, ka), (n, t2, ks), (n, t2)))
            for n, t2 in shapes]


def _sim_query(rng, q2, ka=20, ks=3):
    return tuple(torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
                 for sh in ((q2, ka), (q2, ks), (q2,)))


@pytest.mark.parametrize("q2", [3, 37])
def test_k5_ragged_equals_plain_per_bucket(q2):
    """K5 over mixed buckets (t2 = 3, around a tile's 64 columns, one
    template and several, NaN and inf profile entries, zero confidences)
    equals ``hmap_sim_plain`` of each bucket as float32 bits, on the CPU
    route, which launches nothing."""
    rng = np.random.default_rng(17 + q2)
    q = _sim_query(rng, q2)
    stacks = _sim_stacks(rng, [(2, 3), (1, 63), (3, 65), (1, 64), (2, 9)])
    q[0][1, 2] = np.nan
    q[2][q2 // 2] = 0.0
    stacks[1][0][0, 2, 5] = np.inf
    stacks[2][2][1, 4] = 0.0
    stacks[4][1][0, 3, 1] = -np.inf
    n5 = hmap_device.hmap_sim_ragged.launches
    got = hmap_device.hmap_sim_ragged(*q, stacks, 0.75)
    assert hmap_device.hmap_sim_ragged.launches == n5
    assert len(got) == len(stacks)
    for g, st in zip(got, stacks):
        want = hmap_device.hmap_sim_plain(*q, *st, 0.75)
        assert g.shape == (st[0].shape[0], q2, st[0].shape[1])
        assert torch.equal(g.view(torch.int32), want.view(torch.int32))
        assert torch.isfinite(g).all()
    assert torch.equal(hmap_device.hmap_sim(*q, *stacks[2], 0.75).view(
        torch.int32), got[2].view(torch.int32))


def _tiles_of(pairs, q2):
    """Each descriptor's tiles as the kernel maps a block to its cells:
    {(pair, row0, col0)} from the block index and the pair's first tile,
    each block every row in passes of K5_TILE[0]."""
    tq, tt = hmap_device.K5_TILE
    cells = []
    total = 0
    for p, (t2, t0) in enumerate(zip(pairs["t2"].astype(np.int64),
                                     pairs["tile0"].astype(np.int64))):
        n = -(-t2 // tt)
        assert t0 == total
        total += n
        for blk in range(t0, t0 + n):
            for i0 in range(0, q2, tq):
                cells.append((p, i0, (blk - t0) * tt))
    return cells, total


def test_k5_descriptors_cover_every_cell_once_in_k6_order():
    """K5's descriptors (built on the CPU, as the card's wrapper builds
    them): every pair once with its template rows' and its S's addresses,
    in the order of K6's descriptors for the same outputs, first tiles
    ascending from 0, and tiles that cover each pair's q2 x t2 cells
    once."""
    rng = np.random.default_rng(18)
    q2 = 37
    shapes = [(2, 3), (1, 63), (3, 65), (1, 64), (2, 130), (1, 9)]
    stacks = _sim_stacks(rng, shapes)
    outs = [torch.empty((n, q2, t2)) for n, t2 in shapes]
    addrs = [(a.data_ptr(), z.data_ptr(), c.data_ptr(), S.data_ptr())
             for (a, z, c), S in zip(stacks, outs)]
    pairs, tiles = hmap_device._sim_descriptors(q2, 20, 3, shapes, addrs)
    assert pairs.dtype == hmap_device.SIM_PAIR_DTYPE
    assert hmap_device.SIM_PAIR_DTYPE.itemsize == 40
    want = {(a.data_ptr() + 80 * p * t2, z.data_ptr() + 12 * p * t2,
             c.data_ptr() + 4 * p * t2, S.data_ptr() + 4 * p * q2 * t2, t2)
            for (a, z, c), S, (n, t2) in zip(stacks, outs, shapes)
            for p in range(n)}
    got = {tuple(int(x) for x in row)[:5] for row in pairs}
    assert got == want and len(pairs) == sum(n for n, _ in shapes)
    k6, _ = hmap_device._znorm_descriptors(outs, outs, 4096)
    assert list(pairs["S"]) == list(k6["S"])
    cells, total = _tiles_of(pairs, q2)
    assert total == tiles
    tq, tt = hmap_device.K5_TILE
    for p, t2 in enumerate(pairs["t2"]):
        seen = np.zeros((q2, int(t2)), np.int32)
        for pp, r0, c0 in cells:
            if pp == p:
                seen[r0:r0 + tq, c0:c0 + tt] += 1
        assert (seen == 1).all(), p


def test_k5_descriptor_offsets_are_64_bit():
    """Per-pair offsets past 2^31 bytes (70,000 templates of 400 rows of 20
    floats; 5,000 similarity matrices of 300 x 400) and base addresses past
    2^32: each field is its base plus p times its pair's bytes, exactly."""
    q2 = 300
    shapes = [(70000, 400), (5000, 400)]
    base = [(2 ** 40, 2 ** 41, 2 ** 42, 2 ** 43),
            (2 ** 44, 2 ** 45, 2 ** 46, 2 ** 47)]
    pairs, _ = hmap_device._sim_descriptors(q2, 20, 3, shapes, base)
    for field, col, width in (("t_aa", 0, 20), ("t_zsse", 1, 3),
                              ("t_conf", 2, 1), ("S", 3, q2)):
        got = sorted(int(x) for x in pairs[field])
        want = sorted(b[col] + p * 4 * width * 400
                      for (n, _), b in zip(shapes, base) for p in range(n))
        assert got == want, field
    assert int(pairs["t_aa"].max()) - 2 ** 40 > 2 ** 31
    assert int(pairs["S"].max()) - 2 ** 47 > 2 ** 31


def test_k5_rejects_bad_input():
    rng = np.random.default_rng(19)
    q = _sim_query(rng, 9)
    st = _sim_stacks(rng, [(2, 8)])[0]
    with pytest.raises(ValueError):
        hmap_device.hmap_sim_ragged(*q, [], 0.5)
    with pytest.raises(TypeError):
        hmap_device.hmap_sim_ragged(*q, [(st[0].double(), *st[1:])], 0.5)
    with pytest.raises(ValueError):
        hmap_device.hmap_sim_ragged(*q, [(st[0][:, :, :19].contiguous(),
                                          *st[1:])], 0.5)
    with pytest.raises(ValueError):
        hmap_device.hmap_sim_ragged(*q, [(st[0].transpose(0, 1), *st[1:])],
                                    0.5)
    with pytest.raises(ValueError):                       # t2 < 3
        hmap_device.hmap_sim_ragged(*q, [tuple(
            x[:, :2].contiguous() for x in st)], 0.5)
    with pytest.raises(ValueError):                       # q2 x t2 >= 2^31
        meta = torch.device("meta")
        hmap_device.hmap_sim_ragged(
            torch.empty((50000, 20), device=meta),
            torch.empty((50000, 3), device=meta),
            torch.empty((50000,), device=meta),
            [(torch.empty((1, 50000, 20), device=meta),
              torch.empty((1, 50000, 3), device=meta),
              torch.empty((1, 50000), device=meta))], 0.5)
    with pytest.raises(ValueError):                       # no kernel there
        hmap_device.hmap_sim(*(x.to("meta") for x in (*q, *st)), 0.5)


# ------------------------------------------------- K6 over a whole screen

def _library_texts(rng, normalize: bool):
    """A query and templates over four lengths.  Their shapes repeat those
    of the tests above (the ragged library with normalizing, the 24-residue
    pair without), so that the JAX functions' compiled shapes are reused."""
    if normalize:
        texts = (_texts(rng, 1, 30) + _texts(rng, 2, 21) + _texts(rng, 2, 38)
                 + _texts(rng, 1, 13) + _texts(rng, 1, 27))
        return texts + [texts[3]]
    return (_texts(rng, 1, 24) + _texts(rng, 2, 24) + _texts(rng, 1, 13)
            + _texts(rng, 1, 27))


@pytest.mark.parametrize("normalize", [True, False])
def test_znorm_ragged_equals_jax_bucket_by_bucket(normalize):
    """One K5 call and then one K6 call over the length buckets of a
    library (their plain versions here) equal the JAX package's
    ``build_similarity_device`` of each bucket bit for bit, and the launch
    counts stay where they were."""
    rng = np.random.default_rng(12 if normalize else 13)
    params = HMAPaliParams()
    params.normalize_mtx = normalize
    texts = _library_texts(rng, normalize)
    query, *templates = _parse(texts)
    mq, *mts = _parse(texts, thmap.HMAPSequence)
    mparams = _port_params(params)
    lib = hmap_device.DeviceLibrary(mts, thmap_eval.HMAPaliEval(mparams),
                                    device=CPU)
    assert len(lib.buckets) >= 3
    qt = hmap_device.query_tensors(mq, CPU)
    n5 = hmap_device.hmap_sim_ragged.launches
    n6 = hmap_device.hmap_znorm_ragged.launches
    raw = hmap_device._raw_similarity(qt, list(lib.buckets.values()),
                                      mparams)
    got = hmap_device.hmap_znorm_ragged(
        raw, float(-np.float32(params.zero_shift)), normalize=normalize)
    assert hmap_device.hmap_sim_ragged.launches == n5
    assert hmap_device.hmap_znorm_ragged.launches == n6
    for S, b in zip(got, lib.buckets.values()):
        want = _jax_similarity(query, [templates[i] for i in b["idx"]],
                               params)
        np.testing.assert_array_equal(_bits(S), _bits(want))


def _edge_stacks():
    """K6's edge inputs: a 1 x 1 region, a 1 x 698 one, a pair past 2^17
    region elements, a bucket whose first region element is -0.0, a
    constant region (std 0) and a stack with NaN and inf."""
    rng = np.random.default_rng(14)

    def stack(n, q2, t2):
        S = (rng.standard_normal((n, q2, t2)) * 1.5 + 0.3).astype(np.float32)
        S[:, [0, -1], :] = 0.0
        S[:, :, [0, -1]] = 0.0
        return S

    tiny, row, big = stack(2, 3, 3), stack(1, 3, 700), stack(1, 300, 450)
    negz = stack(3, 5, 6)
    negz[:, 1, 1] = -0.0
    negz[1, 1:-1, 1:-1] = -0.0
    const = stack(2, 6, 9)
    const[:, 1:-1, 1:-1] = np.float32(1.7)
    odd = stack(2, 7, 5)
    odd[0, 2, 2], odd[1, 3, 1] = np.nan, np.inf
    return [torch.from_numpy(x) for x in (tiny, row, big, negz, const, odd)]


@pytest.mark.parametrize("normalize", [True, False])
def test_znorm_ragged_equals_per_bucket_plain_on_edge_inputs(normalize):
    """The ragged plain version (every pair's chain in one loop over
    regions padded with +0.0) equals ``hmap_znorm_plain`` of each stack
    bit for bit: the padding changes no chain."""
    Ss = _edge_stacks()
    assert (Ss[2].shape[1] - 2) * (Ss[2].shape[2] - 2) > 2 ** 17
    n6 = hmap_device.hmap_znorm_ragged.launches
    got = hmap_device.hmap_znorm_ragged(Ss, -0.12, normalize=normalize)
    assert hmap_device.hmap_znorm_ragged.launches == n6
    assert len(got) == len(Ss)
    for S, g in zip(Ss, got):
        want = hmap_device.hmap_znorm_plain(S, -0.12, normalize=normalize)
        assert g.shape == S.shape and g.data_ptr() != S.data_ptr()
        np.testing.assert_array_equal(_bits(g), _bits(want))
    if normalize:
        assert torch.isnan(got[4][:, 1:-1, 1:-1]).all()    # 0 / 0
        assert torch.isnan(got[5][:, 1:-1, 1:-1]).all()    # NaN, inf mean
        # a region of -0.0: its mean is +0.0 (the chain starts at +0.0)
        avg, _ = hmap_device._znorm_stats_plain([Ss[3][1:2]])
        assert avg.item() == 0.0 and not np.signbit(avg.item())


def test_znorm_plain_stats_walk_blocks_of_the_live_pairs(monkeypatch):
    """A long stack among many short ones: the plain stats walk
    ``STATS_BLOCK`` chain steps at a time of the pairs whose regions reach
    the block, so that their scratch is bounded by the block, not by the
    longest region x every pair; the stats equal hmath.seq_sum_f32 of each
    region and the output equals each stack's ``hmap_znorm_plain``."""
    rng = np.random.default_rng(16)

    def stack(n, q2, t2):
        S = (rng.standard_normal((n, q2, t2)) * 1.5 + 0.3).astype(np.float32)
        S[:, [0, -1], :] = 0.0
        S[:, :, [0, -1]] = 0.0
        return torch.from_numpy(S)

    Ss = [stack(40, 5, 6), stack(1, 3, 2602), stack(30, 4, 9),
          stack(2, 20, 70), stack(25, 3, 3)]
    monkeypatch.setattr(hmap_device, "STATS_BLOCK", 700)
    walked = []
    sums = hmap_device.serial_sums

    def spy(v, *a):
        walked.append(tuple(v.shape))
        return sums(v, *a)

    monkeypatch.setattr(hmap_device, "serial_sums", spy)
    avg, std = hmap_device._znorm_stats_plain(Ss)
    # 2,600 steps in blocks of 700: the 2 x 18 x 68 pairs (1,224 each) leave
    # after the second, every short one after the first
    assert walked == [(98, 700), (3, 700), (1, 700), (1, 500)]
    p = 0
    for S in Ss:
        v = S[:, 1:-1, 1:-1].reshape(S.shape[0], -1).numpy()
        m = np.float32(v.shape[1])
        want_avg = seq_sum_f32(v, axis=1) / m
        var = seq_sum_f32(v * v, axis=1) / m - want_avg * want_avg
        want_std = np.sqrt(var.astype(np.float64)).astype(np.float32)
        np.testing.assert_array_equal(_bits(avg[p:p + len(v)]),
                                      _bits(want_avg))
        np.testing.assert_array_equal(_bits(std[p:p + len(v)]),
                                      _bits(want_std))
        p += len(v)
    assert p == avg.shape[0] == std.shape[0]
    monkeypatch.setattr(hmap_device, "serial_sums", sums)
    got = hmap_device.hmap_znorm_ragged(Ss, -0.12)
    for S, g in zip(Ss, got):
        np.testing.assert_array_equal(
            _bits(g), _bits(hmap_device.hmap_znorm_plain(S, -0.12)))


def test_znorm_descriptors_cover_every_pair_longest_first():
    """K6's descriptors (built on the CPU here, as the card's wrapper
    builds them): one per pair, its S and output addresses, longest
    region first, and apply blocks that tile every pair once."""
    Ss = _edge_stacks()
    outs = [torch.empty_like(S) for S in Ss]
    per_block = 4096
    pairs, blocks = hmap_device._znorm_descriptors(Ss, outs, per_block)
    assert pairs.dtype == hmap_device.ZPAIR_DTYPE
    assert hmap_device.ZPAIR_DTYPE.itemsize == 32
    region = (pairs["q2"].astype(np.int64) - 2) * (pairs["t2"] - 2)
    assert (np.diff(region) <= 0).all()
    want = {(S.data_ptr() + 4 * p * S.shape[1] * S.shape[2],
             o.data_ptr() + 4 * p * S.shape[1] * S.shape[2],
             S.shape[1], S.shape[2])
            for S, o in zip(Ss, outs) for p in range(S.shape[0])}
    got = {(int(a), int(b), int(q), int(t)) for a, b, q, t in
           zip(pairs["S"], pairs["out"], pairs["q2"], pairs["t2"])}
    assert got == want and len(pairs) == sum(S.shape[0] for S in Ss)
    need = -(-(pairs["q2"].astype(np.int64) * pairs["t2"]) // per_block)
    assert pairs["blk0"][0] == 0
    assert (np.diff(pairs["blk0"]) == need[:-1]).all()
    assert blocks == need.sum()


def test_znorm_rejects_bad_input():
    S = torch.zeros((2, 5, 6))
    with pytest.raises(ValueError):
        hmap_device.hmap_znorm_ragged([], -0.12)
    with pytest.raises(TypeError):
        hmap_device.hmap_znorm_ragged([S, S.double()], -0.12)
    with pytest.raises(ValueError):
        hmap_device.hmap_znorm_ragged([S[:, :2]], -0.12)
    with pytest.raises(ValueError):
        hmap_device.hmap_znorm_ragged([S.transpose(1, 2)], -0.12)


# ------------------------------------- templates past K3's shared-memory cap

def test_screen_past_k3_cap_takes_k7_and_equals_jax(monkeypatch):
    """With K3's vector-form cap patched to t2 = 30, the bucket past it is
    scored on K7 (its plain version here), as the JAX package scores a
    bucket past its VMEM cap on ``dp_engine``: every score bit-equal to the
    JAX ``screen_hmap_device`` and ``screen_profiles`` on the same files,
    and the order equal."""
    rng = np.random.default_rng(15)
    params = HMAPaliParams()
    texts = _library_texts(rng, True)
    query, *templates = _parse(texts)
    mq, *mts = _parse(texts, thmap.HMAPSequence)
    mparams = _port_params(params)
    monkeypatch.setattr(hmap_device.dp_scores, "vec_max_t2",
                        lambda device: 30)
    k7_shapes = []
    build = hmap_device.dp_engine.build_forward_batched

    def spy(costs, *a, **kw):
        k7_shapes.append((len(costs), costs[0].q_size, costs[0].t_size))
        return build(costs, *a, **kw)

    monkeypatch.setattr(hmap_device.dp_engine, "build_forward_batched", spy)
    k3_widths = []
    ragged = hmap_device.dp_scores.dp_general_ragged

    def k3_spy(buckets, **kw):
        k3_widths.append(sorted(S.shape[2] for S, *_ in buckets))
        return ragged(buckets, **kw)

    monkeypatch.setattr(hmap_device.dp_scores, "dp_general_ragged", k3_spy)
    scores, order = screen_profiles(
        mq, mts, lambda a, b: thmap_eval.HMAPaliEval(mparams), k=7,
        device=CPU)
    assert k7_shapes == [(3, 32, 40)]
    assert k3_widths == [[15, 23, 29]]
    j_scores, j_order = jscreen(query, templates,
                                lambda a, b: HMAPaliEval(params), k=7,
                                engine="xla")
    np.testing.assert_array_equal(_bits(scores), _bits(j_scores))
    np.testing.assert_array_equal(order, j_order)
    d_scores, d_order = jhd.screen_hmap_device(query, templates, params,
                                               k=7, engine="xla")
    np.testing.assert_array_equal(_bits(scores), _bits(d_scores))
    np.testing.assert_array_equal(order, d_order)
