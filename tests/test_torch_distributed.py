"""The port's multi-process screen (``parallel/distributed``) as a real
``torch.distributed`` gloo group on the CPU over local TCP, mirroring
tests/test_distributed.py: every rank's result bit-equal to the
one-process screen over a mesh of the same size and to the JAX package's
screen over as many virtual devices."""

import os
import subprocess

import numpy as np
import pytest
import torch

from alignment_algos_tpu.parallel import screen as jscreen
from alignment_algos_tpu_torch.parallel import distributed, screen

Q, T, N, K = 24, 20, 13, 5


def _inputs():
    rng = np.random.default_rng(11)
    q = rng.integers(0, 20, Q).astype(np.int32)
    lib = rng.integers(0, 20, (N, T)).astype(np.int32)
    lib[7] = lib[2]                             # a tie across ranks
    table = rng.integers(-4, 12, (20, 20)).astype(np.float32)
    return q, lib, table


@pytest.mark.parametrize("num_processes,devices_per_process",
                         [(2, 2), (4, 1)])
def test_multiprocess_screen_bit_identical(num_processes,
                                           devices_per_process):
    q, lib, table = _inputs()
    n = num_processes * devices_per_process
    ref_s, ref_i = screen.screen_library(
        q, lib, table, 11.0, 1.0, k=K,
        mesh=screen.default_mesh(n, device="cpu"))
    js, ji = jscreen.screen_library(q, lib, table, 11.0, 1.0, k=K,
                                    mesh=jscreen.default_mesh(n))
    np.testing.assert_array_equal(ref_i, ji)
    np.testing.assert_array_equal(ref_s.view(np.int32),
                                  np.asarray(js, np.float32).view(np.int32))
    results, walls = distributed.launch_local_screen(
        q, lib, table, 11.0, 1.0, K, num_processes=num_processes,
        devices_per_process=devices_per_process, timeout=240.0, reps=2,
        return_walls=True, device="cpu")
    assert len(results) == num_processes and len(walls) == num_processes
    assert all(w > 0 for w in walls)
    for scores, idx in results:
        assert scores.dtype == np.float32 and idx.dtype == np.int32
        np.testing.assert_array_equal(idx, ref_i)
        np.testing.assert_array_equal(scores.view(np.int32),
                                      ref_s.view(np.int32))


def test_maybe_initialize_from_env_without_variables(monkeypatch):
    for var in ("AAT_DIST_COORDINATOR", "AAT_DIST_NUM_PROCESSES",
                "AAT_DIST_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.maybe_initialize_from_env() is False
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("device,cards", [("cpu", 0), ("cuda", 1)])
def test_launcher_refuses_nccl_past_the_cards(device, cards, monkeypatch):
    """NCCL needs a card per rank: with more ranks than visible cards the
    launcher raises before any rank starts, never switching to gloo."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)

    def no_spawn(*a, **k):
        raise AssertionError("a rank was started")

    monkeypatch.setattr(subprocess, "Popen", no_spawn)
    q, lib, table = _inputs()
    with pytest.raises(RuntimeError, match="NCCL needs a card per rank"):
        distributed.launch_local_screen(q, lib, table, 11.0, 1.0, K,
                                        num_processes=2, backend="nccl",
                                        device=device)
    with pytest.raises(ValueError):
        distributed.launch_local_screen(q, lib, table, 11.0, 1.0, K,
                                        backend="mpi", device="cpu")


def test_failed_rank_raises_with_its_output(tmp_path):
    """A rank that fails ends the launch with its last lines (here the
    spec file does not exist)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, AAT_TORCH_DEVICE="cpu", PYTHONPATH=root)
    outs = [str(tmp_path / "out_0.npz"), str(tmp_path / "out_1.npz")]
    with pytest.raises(RuntimeError, match="FileNotFoundError"):
        distributed._run_ranks(str(tmp_path / "missing.json"), outs, env,
                               str(tmp_path), 60.0)
