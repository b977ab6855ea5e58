"""The port's Gotoh module (alignment_algos_tpu_torch.ops.swaffine) against
the JAX package: producers, K1 and K2 through their plain versions (the
CPU route of the wrappers), and the traceback decode.  Tolerance 0: every
value is built with float32 add, subtract and max in the same op order.
JAX's Pallas kernels run in interpret mode, as the JAX package's own tests
run them."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from alignment_algos_tpu.ops import swaffine as jsw
from alignment_algos_tpu.ops import swstrip as jstrip
from alignment_algos_tpu_torch.ops import swaffine
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
