"""The port's screen entry points (alignment_algos_tpu_torch.ops.swscan)
against the JAX row-scan kernel (interpret mode, integer gaps, where it is
exact) and against the JAX Gotoh twin at fractional gaps, where the TPU
package gates the row-scan kernel off.  Tolerance 0."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from alignment_algos_tpu.ops import swaffine as jsw
from alignment_algos_tpu.ops import swscan as jscan
from alignment_algos_tpu_torch.ops import swscan

CPU = torch.device("cpu")


def _interp():
    from jax.experimental.pallas import tpu as pltpu
    return pltpu.force_tpu_interpret_mode()


def _inputs(q, t, b, seed, wall: bool):
    rng = np.random.default_rng(seed)
    qc = rng.integers(0, 20, q).astype(np.int32)
    tc = rng.integers(0, 20, (b, t)).astype(np.int32)
    table = rng.integers(-6, 12, (20, 20)).astype(np.float32)
    if wall:        # pad code 20 with the aat_screen wall
        table = np.pad(table, ((0, 1), (0, 1)), constant_values=-1.0e4)
        tc[1, t // 3:] = 20
    return qc, tc, table


@pytest.mark.parametrize("sim_dtype", ["float32", "int8"])
@pytest.mark.parametrize("q,t,b", [(24, 40, 6), (13, 29, 3)])
def test_rowscan_screen_equals_jax_kernel(q, t, b, sim_dtype):
    # int8 similarity cannot hold the -1e4 wall: that case uses no wall
    qc, tc, table = _inputs(q, t, b, q + t, wall=sim_dtype == "float32")
    got = swscan.sw_rowscan_screen(qc, tc, table, 11.0, 1.0,
                                   device=CPU).numpy()
    with _interp():
        want = jscan.sw_rowscan_screen(qc, tc, table, 11.0, 1.0,
                                       sim_dtype=getattr(jnp, sim_dtype))
    np.testing.assert_array_equal(got, np.asarray(want))


def test_rowscan_batch_equals_jax_kernel():
    rng = np.random.default_rng(31)
    q, t, b = 16, 24, 4
    qc = rng.integers(0, 20, (b, q)).astype(np.int32)
    tc = rng.integers(0, 20, (b, t)).astype(np.int32)
    table = rng.integers(-6, 12, (20, 20)).astype(np.float32)
    got = swscan.sw_rowscan_batch(qc, tc, table, 8.0, 2.0, device=CPU)
    with _interp():
        want = jscan.sw_rowscan_batch(qc, tc, table, 8.0, 2.0,
                                      sim_dtype=jnp.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("gi,ge", [(4.73, 0.34), (3.1, 0.77)])
def test_rowscan_screen_fractional_gaps_equal_gotoh_twin(gi, ge):
    q, t, b = 20, 26, 5
    qc, tc, table = _inputs(q, t, b, 11, wall=True)
    # the TPU package routes these gaps away from its row-scan kernel
    assert not jscan.supported(table, gi, ge, q, t, b)
    got = swscan.sw_rowscan_screen(qc, tc, table, gi, ge, device=CPU)
    want = jsw.sw_affine_batch_xla(np.broadcast_to(qc, (b, q)), tc, table,
                                   gi, ge)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
