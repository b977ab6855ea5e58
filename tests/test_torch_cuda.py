"""The port's CUDA kernels on the card: K1 (scores) and K2 (tracebacks) are
bit-equal to their plain PyTorch versions, run on the same card, and K1
agrees with the numpy Gotoh oracle.

Needs an NVIDIA GPU and nvcc; skips elsewhere.  Imports no JAX, so it runs
where JAX is not installed:

    AAT_TORCH_DEVICE=cuda python -m pytest --noconftest -m cuda \
        tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from alignment_algos_tpu_torch.ops import swaffine

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
