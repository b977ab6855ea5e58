"""The port's Gotoh module (alignment_algos_tpu_torch.ops.swaffine) against
the JAX package: producers, K1 and K2 through their plain versions (the
CPU route of the wrappers), and the traceback decode.  Tolerance 0: every
value is built with float32 add, subtract and max in the same op order.
JAX's Pallas kernels run in interpret mode, as the JAX package's own tests
run them."""

import ctypes
import glob
import os
import re

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from alignment_algos_tpu.ops import swaffine as jsw
from alignment_algos_tpu.ops import swstrip as jstrip
from alignment_algos_tpu_torch.ops import _build, swaffine
from alignment_algos_tpu_torch.utils import torchenv

CPU = torch.device("cpu")
PAD = 20
SHAPES = [(12, 30, 5), (30, 12, 5), (13, 29, 4)]    # q<t, q>t, odd
GAPS = [(4.73, 0.34), (11.0, 1.0)]


def _interp():
    from jax.experimental.pallas import tpu as pltpu
    return pltpu.force_tpu_interpret_mode()


def _inputs(q, t, b, seed):
    """(B, Q), (B, T) codes and a 21x21 table with the pad wall; lane 0 is
    all wall (score 0), lane 1 is half wall."""
    rng = np.random.default_rng(seed)
    qc = rng.integers(0, 20, (b, q)).astype(np.int32)
    tc = rng.integers(0, 20, (b, t)).astype(np.int32)
    tc[0] = PAD
    tc[1, t // 2:] = PAD
    table = np.full((21, 21), -1.0e4, np.float32)
    table[:20, :20] = rng.integers(-4, 12, (20, 20))
    return qc, tc, table


def _jax_sd(qc, tc, table):
    return jsw.skewed_similarity_from_codes(
        jnp.asarray(qc), jnp.asarray(tc), jnp.asarray(table))


@pytest.mark.parametrize("q,t,b", SHAPES)
def test_producers_equal_jax(q, t, b):
    qc, tc, table = _inputs(q, t, b, 1)
    args = [torch.from_numpy(x) for x in (qc, tc, table)]
    sim = swaffine.similarity_from_codes(*args).numpy()
    want = np.asarray(jsw.similarity_from_codes(
        jnp.asarray(qc), jnp.asarray(tc), jnp.asarray(table)))
    np.testing.assert_array_equal(sim, want)
    sd = swaffine.skewed_similarity_from_codes(*args).numpy()
    assert sd.shape == (q + t - 1, q, b)
    np.testing.assert_array_equal(sd, np.asarray(_jax_sd(qc, tc, table))
                                  [:q + t - 1, :q, :b])


@pytest.mark.parametrize("gi,ge", GAPS)
@pytest.mark.parametrize("q,t,b", SHAPES)
def test_scores_equal_jax_twin_and_pallas_kernels(q, t, b, gi, ge):
    qc, tc, table = _inputs(q, t, b, q * t)
    qd, td, tab, gap = swaffine.to_device(qc, tc, table, gi, ge, CPU)
    got = swaffine.sw_affine_scores(qd, td, tab, gap).numpy()
    assert got[0] == 0.0 and got[1:].min() > 0.0

    jgap = jnp.array([[gi, ge]], jnp.float32)
    sd = _jax_sd(qc, tc, table)
    np.testing.assert_array_equal(
        got, np.asarray(jsw.sw_affine_scores_xla(sd, jgap, q=q, t=t))[:b])
    sds = jstrip.strip_skewed_similarity_from_codes(
        jnp.asarray(qc), jnp.asarray(tc), jnp.asarray(table), strip=16, kd=8,
        sim_dtype=jnp.float32)
    with _interp():
        mono = jsw.sw_affine_scores_from_skewed(sd, jgap, q=q, t=t)
        strip = jstrip.sw_affine_scores_striped(sds, jgap, q=q, t=t,
                                                strip=16, kd=8, uf=2)
    np.testing.assert_array_equal(got, np.asarray(mono)[:b])
    np.testing.assert_array_equal(got, np.asarray(strip)[:b])


@pytest.mark.parametrize("gi,ge", GAPS)
@pytest.mark.parametrize("q,t,b", SHAPES)
def test_tb_equals_jax_twin_and_pallas_kernel(q, t, b, gi, ge):
    qc, tc, table = _inputs(q, t, b, q + t)
    qd, td, tab, gap = swaffine.to_device(qc, tc, table, gi, ge, CPU)
    tb, m, dat = (x.numpy() for x in swaffine.sw_affine_tb(qd, td, tab, gap))
    nd = q + t - 1
    assert tb.shape == (nd, q, b) and tb.dtype == np.int8
    jgap = jnp.array([[gi, ge]], jnp.float32)
    sd = _jax_sd(qc, tc, table)
    twin = jsw.sw_affine_tb_xla(sd, jgap, q=q, t=t)
    with _interp():
        kern = jsw.sw_affine_tb_from_skewed(sd, jgap, q=q, t=t)
    for jtb, jm, jdat in (twin, kern):
        np.testing.assert_array_equal(tb, np.asarray(jtb)[:nd, :q, :b])
        np.testing.assert_array_equal(m, np.asarray(jm)[:q, :b])
        np.testing.assert_array_equal(dat, np.asarray(jdat)[:q, :b])


@pytest.mark.parametrize("gi,ge", GAPS)
def test_device_decode_equals_jax(gi, ge):
    q, t, b = 40, 33, 9
    qc, tc, table = _inputs(q, t, b, 21)
    jgap = jnp.array([[gi, ge]], jnp.float32)
    jtb, jm, jdat = jsw.sw_affine_tb_xla(_jax_sd(qc, tc, table), jgap, q=q,
                                         t=t)
    s_jax, p_jax = jsw.decode_local_tracebacks_device(jtb, jm, jdat, q, t,
                                                      nb=b)
    qd, td, tab, gap = swaffine.to_device(qc, tc, table, gi, ge, CPU)
    tb, m, dat = swaffine.sw_affine_tb(qd, td, tab, gap)
    s_dev, p_dev = swaffine.decode_local_tracebacks_device(tb, m, dat, q, t,
                                                           nb=b)
    np.testing.assert_array_equal(s_dev, s_jax)
    assert p_dev == p_jax
    assert p_dev[0] == [] and all(p_dev[1:])
    s_host, p_host = swaffine.decode_local_tracebacks(
        tb.numpy(), m.numpy(), dat.numpy(), q, t, nb=b)
    np.testing.assert_array_equal(s_host, s_jax)
    assert p_host == p_jax


@pytest.mark.parametrize("gi,ge", GAPS)
def test_tb_batch_equals_jax(gi, ge):
    q, t, b = 16, 19, 5
    qc, tc, table = _inputs(q, t, b, 7)
    s_jax, p_jax = jsw.sw_affine_tb_batch(qc, tc, table, gi, ge)
    s, p = swaffine.sw_affine_tb_batch(qc, tc, table, gi, ge, device=CPU)
    np.testing.assert_array_equal(s, np.asarray(s_jax))
    assert p == p_jax


def test_scores_equal_numpy_oracle():
    q, t, b = 13, 17, 4
    qc, tc, table = _inputs(q, t, b, 3)
    qd, td, tab, gap = swaffine.to_device(qc, tc, table, 11.0, 1.0, CPU)
    got = swaffine.sw_affine_scores(qd, td, tab, gap).numpy()
    s = table[qc[:, :, None], tc[:, None, :]]
    np.testing.assert_array_equal(
        got, swaffine.sw_affine_reference(s, np.float32(11.0),
                                          np.float32(1.0)))


def test_cpu_route_counts_no_launch_and_checks_inputs():
    qc, tc, table = _inputs(6, 7, 3, 0)
    qd, td, tab, gap = swaffine.to_device(qc[0], tc, table, 11.0, 1.0, CPU)
    n1, n2 = swaffine.sw_affine_scores.launches, swaffine.sw_affine_tb.launches
    swaffine.sw_affine_scores(qd, td, tab, gap)
    swaffine.sw_affine_tb(qd, td, tab, gap)
    assert (swaffine.sw_affine_scores.launches,
            swaffine.sw_affine_tb.launches) == (n1, n2)
    with pytest.raises(TypeError):
        swaffine.sw_affine_scores(qd.long(), td, tab, gap)
    with pytest.raises(ValueError):
        swaffine.sw_affine_scores(qd, td.t(), tab, gap)        # not contiguous
    with pytest.raises(ValueError):
        swaffine.sw_affine_scores(qd, td + 21, tab, gap)       # code >= A
    with pytest.raises(ValueError):
        swaffine.sw_affine_tb(qd, td, tab, gap[:1])


@pytest.mark.parametrize("b,t", [(1, 1), (7, 33), (33, 32), (0, 5), (5, 0)])
@pytest.mark.parametrize("shared_query", [True, False])
def test_cpu_to_device_keeps_the_host_layout_and_dtypes(b, t, shared_query):
    rng = np.random.default_rng(b * 100 + t)
    qc = rng.integers(0, 21, 9 if shared_query else (b, 9))
    tc = rng.integers(0, 21, (b, t)).astype(np.int32)
    table = rng.standard_normal((21, 21))
    n = swaffine.transpose_codes.launches
    got = swaffine.to_device(qc, tc, table, 4.73, 0.34, CPU)
    want = (qc.T.astype(np.int32), tc.T, table.astype(np.float32),
            np.array([4.73, 0.34], np.float32))
    assert swaffine.transpose_codes.launches == n
    for g, w, src in zip(got, want, (qc, tc, table, None), strict=True):
        assert g.device == CPU and g.is_contiguous()
        assert g.dtype == torch.from_numpy(w).dtype and g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), w)
        # the host route copies: no tensor aliases its caller's array
        assert src is None or not np.shares_memory(g.numpy(), src)


@pytest.mark.parametrize("shape", [(1, 1), (7, 33), (33, 32), (0, 4),
                                   (4, 0)])
def test_transpose_codes_plain_version(shape):
    # there is none: the kernel is the only route, and on the CPU to_device
    # transposes on the host (numpy) and never calls it
    x = torch.arange(shape[0] * shape[1], dtype=torch.int32).view(shape)
    n = swaffine.transpose_codes.launches
    for bad in (x, x.long(), x.view(-1)):
        with pytest.raises(ValueError, match="CUDA tensor"):
            swaffine.transpose_codes(bad)
    assert swaffine.transpose_codes.launches == n


def _c_entry_points() -> dict:
    """Every ``extern "C" int name(...)`` of ``csrc/*.cu``: name -> its
    parameters as ctypes (a pointer, the stream included, as c_void_p)."""
    kinds = {"int": ctypes.c_int, "float": ctypes.c_float}
    out = {}
    for path in glob.glob(os.path.join(_build.CSRC, "*.cu")):
        with open(path) as f:
            text = f.read()
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                       text):
            params = [p.strip() for p in params.split(",")]
            out[name] = tuple(
                ctypes.c_void_p if "*" in p else kinds[p.split()[-2]]
                for p in params if p not in ("", "void"))
    return out


def test_every_c_entry_point_has_its_signature():
    assert "transpose_i32_launch" in _build.SIGNATURES
    assert set(_c_entry_points()) == set(_build.SIGNATURES)


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_c_entry_point_matches_its_signature(name):
    assert _c_entry_points()[name] == _build.SIGNATURES[name]


def test_device_from_env(monkeypatch):
    monkeypatch.setenv(torchenv.ENV, "cpu")
    assert torchenv.device_from_env() == CPU
    monkeypatch.setenv(torchenv.ENV, "tpu")
    with pytest.raises(RuntimeError):
        torchenv.device_from_env()
    monkeypatch.delenv(torchenv.ENV)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):      # cuda by default, never the CPU
        torchenv.device_from_env()


# ------------------------------------------------ K8's plain version (decode)

def _decode_inputs(q, t, seed):
    """8 lanes for the traceback walk, (B, Q) x (B, T) codes and a table
    with a strong diagonal: 0 all wall; 1 code 19, whose row and column of
    the table are negative (best score 0 without a wall); 2 the query
    (the walk reaches i = 0 and j = 0); 3 the query from row 4 (it reaches
    j = 0); 4 three codes, then the query (it reaches i = 0); 5 the query
    less 3 rows (a gap in F); 6 the query with 3 codes inserted (a gap in
    E); 7 random."""
    rng = np.random.default_rng(seed)
    qc = rng.integers(0, 19, q)

    def fit(x):
        x = list(x)[:t]
        return x + list(rng.integers(0, 19, t - len(x)))

    k = min(q, t) // 3
    lanes = [[PAD] * t, [19] * t, fit(qc), fit(qc[4:]),
             fit([*rng.integers(0, 19, 3), *qc]),
             fit([*qc[:k], *qc[k + 3:]]),
             fit([*qc[:k], *rng.integers(0, 19, 3), *qc[k:]]),
             fit(rng.integers(0, 19, t))]
    table = np.full((21, 21), -1.0e4, np.float32)
    table[:20, :20] = rng.integers(-4, 4, (20, 20))
    table[np.arange(19), np.arange(19)] = 11
    table[19, :20] = table[:20, 19] = -2
    return (np.broadcast_to(qc, (8, q)).astype(np.int32),
            np.asarray(lanes, np.int32), table)


def _jax_decode(tb, m, dat, q, t, b):
    return tuple(np.asarray(x) for x in jsw._decode_tb_device(
        jnp.asarray(np.asarray(tb)), jnp.asarray(np.asarray(m)),
        jnp.asarray(np.asarray(dat)), q=q, t=t, b=b))


@pytest.mark.parametrize("gi,ge", GAPS)
@pytest.mark.parametrize("q,t", [(12, 30), (30, 12), (13, 29)])
def test_decode_plain_equals_jax_arrays(q, t, gi, ge):
    """decode_tb_plain and the wrapper's CPU route return the JAX
    ``_decode_tb_device`` arrays (scores, rec_i, rec_j) on the same codes,
    position for position."""
    qc, tc, table = _decode_inputs(q, t, q * 31 + t)
    b = tc.shape[0]
    tb, m, dat = swaffine.sw_affine_tb(
        *swaffine.to_device(qc, tc, table, gi, ge, CPU))
    want = _jax_decode(tb, m, dat, q, t, b)
    for got in (swaffine.decode_tb_plain(tb, m, dat, q=q, t=t, b=b),
                swaffine.sw_decode(tb, m, dat, q=q, t=t, b=b)):
        assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
        assert got[1].shape == got[2].shape == (q + t + 2, b)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)
    scores, rec_i, rec_j = want
    assert scores[0] == scores[1] == 0.0 and (scores[2:] > 0).all()
    assert (rec_i[:, :2] == -1).all() and (rec_j[:, :2] == -1).all()
    hit = [set(zip(rec_i[:, n].tolist(), rec_j[:, n].tolist())) - {(-1, -1)}
           for n in range(b)]
    assert (0, 0) in hit[2]
    assert any(j == 0 for _, j in hit[3]) and any(i == 0 for i, _ in hit[4])
    # the walks cross gaps: a lane's matches skip a row or a column
    assert any(len(h) < (max(h)[0] - min(h)[0] + 1) for h in hit[5:7])
    assert any(len(h) < (max(h, key=lambda p: p[1])[1]
                         - min(h, key=lambda p: p[1])[1] + 1)
               for h in hit[5:7])


@pytest.mark.parametrize("gi,ge", GAPS)
def test_decode_plain_on_padded_jax_arrays(gi, ge):
    """The JAX twin's padded tb (D, Qp, Bp) and m, dat (Qp, Bp): rows past
    q and lanes past b are read by neither decoder."""
    q, t = 21, 17
    qc, tc, table = _decode_inputs(q, t, 5)
    b = tc.shape[0]
    jtb, jm, jdat = (np.array(x) for x in jsw.sw_affine_tb_xla(
        _jax_sd(qc, tc, table), jnp.array([[gi, ge]], jnp.float32), q=q,
        t=t))
    assert jm.shape[0] > q and jm.shape[1] > b
    want = _jax_decode(jtb, jm, jdat, q, t, b)
    got = swaffine.decode_tb_plain(*(torch.from_numpy(x)
                                     for x in (jtb, jm, jdat)),
                                   q=q, t=t, b=b)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    s_host, p_host = swaffine.decode_local_tracebacks(jtb, jm, jdat, q, t,
                                                      nb=b)
    np.testing.assert_array_equal(s_host, want[0])
    assert p_host == swaffine._paths(want[1], want[2], b)


def test_decode_cpu_route_counts_no_launch_and_checks_inputs():
    qc, tc, table = _decode_inputs(9, 11, 2)
    tb, m, dat = swaffine.sw_affine_tb(
        *swaffine.to_device(qc, tc, table, 11.0, 1.0, CPU))
    kw = dict(q=9, t=11, b=8)
    n = swaffine.sw_decode.launches
    swaffine.sw_decode(tb, m, dat, **kw)
    swaffine.sw_decode(tb, m, dat, **dict(kw, b=5))          # m wider than b
    assert swaffine.sw_decode.launches == n
    with pytest.raises(TypeError):
        swaffine.sw_decode(tb.int(), m, dat, **kw)
    with pytest.raises(TypeError):
        swaffine.sw_decode(tb, m.double(), dat, **kw)
    with pytest.raises(ValueError):
        swaffine.sw_decode(tb, m, dat[:, :7].contiguous(), **kw)
    with pytest.raises(ValueError):
        swaffine.sw_decode(tb, m.t(), dat, **kw)              # not contiguous
    with pytest.raises(ValueError):
        swaffine.sw_decode(tb, m.to("meta"), dat, **kw)       # device
    for bad in (dict(kw, q=10), dict(kw, b=9), dict(kw, t=0)):
        with pytest.raises(ValueError):
            swaffine.sw_decode(tb, m, dat, **bad)


# ------------------------------------------------------- K8's launch plan

@pytest.mark.parametrize("b,mode", [(1, "windowed"), (10, "windowed"),
                                    (512, "windowed"), (513, "lane"),
                                    (1024, "lane"), (5120, "lane")])
def test_k8_plan_mode_by_lanes(b, mode):
    """Windows up to K8_WINDOW_LANES lanes (the screen's top 10 among
    them), one thread a lane beyond (--top_k 1024 among them); a window is
    K8_WINDOW at full size."""
    plan = swaffine.k8_plan(512, 512, b, 1023, 512, b)
    assert plan.mode == mode
    if mode == "windowed":
        assert (plan.dw, plan.iw) == swaffine.K8_WINDOW == (64, 32)
    else:
        assert (plan.dw, plan.iw) == (0, 0)


def test_k8_plan_clips_the_window_to_the_matrix():
    """q or t smaller than a window: the window is the matrix's ND x QP
    where that is smaller (QP past q, padding rows, counts as rows)."""
    assert swaffine.k8_plan(1, 1, 1, 1, 1, 1) == swaffine.K8Plan(
        "windowed", 1, 1)
    assert swaffine.k8_plan(13, 29, 5, 41, 13, 5) == swaffine.K8Plan(
        "windowed", 41, 13)
    assert swaffine.k8_plan(21, 17, 8, 48, 32, 128) == swaffine.K8Plan(
        "windowed", 48, 32)
    assert swaffine.k8_plan(40, 37, 5, 76, 40, 5, mode="lane") == \
        swaffine.K8Plan("lane", 0, 0)
    assert swaffine.k8_plan(40, 37, 5000, 76, 40, 5000,
                            mode="windowed").mode == "windowed"
    with pytest.raises(ValueError):
        swaffine.k8_plan(40, 37, 5, 76, 40, 5, mode="rows")


def test_decode_takes_either_plan_and_refuses_a_mismatching_one():
    """On the CPU route both modes' plans give the plain version's arrays;
    a plan made for another shape, or not made by k8_plan, raises before
    anything runs (the card's launcher refuses it too)."""
    q, t = 12, 30
    qc, tc, table = _decode_inputs(q, t, 3)
    b = tc.shape[0]
    tb, m, dat = swaffine.sw_affine_tb(
        *swaffine.to_device(qc, tc, table, 4.73, 0.34, CPU))
    want = swaffine.decode_tb_plain(tb, m, dat, q=q, t=t, b=b)
    shape = (q, t, b, *tb.shape)
    for mode in ("windowed", "lane"):
        plan = swaffine.k8_plan(*shape, mode=mode)
        got = swaffine.sw_decode(tb, m, dat, q=q, t=t, b=b, plan=plan)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert tb.shape[1] < swaffine.K8_WINDOW[1]
    n = swaffine.sw_decode.launches
    for bad in (swaffine.K8Plan("windowed", *swaffine.K8_WINDOW),
                swaffine.K8Plan("windowed", tb.shape[0], tb.shape[1] - 1),
                swaffine.K8Plan("lane", 1, 0),
                swaffine.K8Plan("rows", 0, 0)):
        with pytest.raises(ValueError):
            swaffine.sw_decode(tb, m, dat, q=q, t=t, b=b, plan=bad)
    assert swaffine.sw_decode.launches == n
