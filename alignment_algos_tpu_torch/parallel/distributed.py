"""Multi-process library screens on ``torch.distributed`` (counterpart of
``alignment_algos_tpu/parallel/distributed.py``).

A process group of P ranks screens one library over a global mesh of P x D
entries: rank r owns entries [r*D, (r+1)*D), all of them on its one
device, and scores only the shards those entries own
(``screen.shard_bounds`` over the P x D entries).  The ranks' top-k
candidates (scores and global indices) are exchanged with one
``all_gather`` and merged by ``screen.merge_topk`` (score descending, then
index ascending), so every rank holds the one-process result bit for bit.

The backend follows the device: NCCL on ``cuda`` (rank r on card r; more
ranks than visible cards raise, NCCL refuses two ranks on one card), gloo
on ``cpu``.  An explicit gloo group on ``cuda`` lets several ranks score
on one card: only the small top-k tensors cross, through the host.

``launch_local_screen`` spawns such a group on this machine over local TCP
(``python -m alignment_algos_tpu_torch.parallel.distributed`` per rank)
and returns every rank's result.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from ..utils.torchenv import ENV as _ENV_DEVICE
from ..utils.torchenv import device_from_env

_ENV_COORD = "AAT_DIST_COORDINATOR"
_ENV_NPROC = "AAT_DIST_NUM_PROCESSES"
_ENV_PID = "AAT_DIST_PROCESS_ID"
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _backend_for(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def _init(backend: str, coordinator: str, world_size: int, rank: int):
    import torch.distributed as dist
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=world_size, rank=rank)


def maybe_initialize_from_env() -> bool:
    """Join the process group the AAT_DIST_* variables describe
    (coordinator ``host:port``, process count, this process's rank), NCCL
    on ``cuda`` and gloo on ``cpu`` (:func:`device_from_env`); returns
    False when they are unset."""
    coord = os.environ.get(_ENV_COORD)
    if not coord:
        return False
    _init(_backend_for(device_from_env()), coord,
          int(os.environ[_ENV_NPROC]), int(os.environ[_ENV_PID]))
    return True


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def rank_device(rank: int, device: torch.device) -> torch.device:
    """The device rank ``rank`` scores on: card ``rank`` modulo the
    visible cards on ``cuda``, else the CPU."""
    if device.type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device("cpu")


def group_screen(q_codes, t_codes, table, gi: float, ge: float, k: int,
                 devices_per_process: int, device: torch.device):
    """This rank's part of a screen over the group's global mesh, then the
    exchange and merge; every rank returns the same (scores float32 (k,),
    indices int32 (k,))."""
    import torch.distributed as dist

    from .screen import merge_topk, shard_bounds, shard_candidates

    rank, world = dist.get_rank(), dist.get_world_size()
    d = devices_per_process
    t_codes = np.asarray(t_codes, dtype=np.int32)
    n = t_codes.shape[0]
    k = min(k, n)
    bounds = shard_bounds(n, world * d)
    counts = [sum(min(k, hi - lo) for lo, hi in bounds[r * d:(r + 1) * d])
              for r in range(world)]
    mine = bounds[rank * d:(rank + 1) * d]
    width = max(counts)
    s = np.zeros(width, np.float32)
    i = np.zeros(width, np.int64)
    if counts[rank]:
        s[:counts[rank]], i[:counts[rank]] = shard_candidates(
            q_codes, t_codes, table, gi, ge, k, [device] * d, mine)
    # gloo gathers host tensors, NCCL device tensors
    where = device if dist.get_backend() == "nccl" else torch.device("cpu")
    parts = []
    for x in (torch.from_numpy(s), torch.from_numpy(i)):
        x = x.to(where)
        out = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(out, x)
        parts.append(np.concatenate([o.cpu().numpy()[:c]
                                     for o, c in zip(out, counts)]))
    scores, idx = merge_topk(*parts, k)
    return scores.astype(np.float32), idx.astype(np.int32)


def _worker_main(argv: list[str]) -> int:
    """One rank of a :func:`launch_local_screen` group: join the group,
    screen ``reps`` times (the last run's wall is the warm one), save the
    result."""
    import torch.distributed as dist

    with open(argv[0]) as f:
        spec = json.load(f)
    out_path, rank = argv[1], int(argv[2])
    device = rank_device(rank, device_from_env())
    if device.type == "cuda":
        torch.cuda.set_device(device)
    _init(spec["backend"], spec["coordinator"], spec["num_processes"], rank)
    try:
        with np.load(spec["data"]) as data:
            q, t, table = data["q_codes"], data["t_codes"], data["table"]
        for _ in range(int(spec["reps"])):
            t0 = time.perf_counter()
            scores, idx = group_screen(
                q, t, table, float(spec["gi"]), float(spec["ge"]),
                int(spec["k"]), int(spec["devices_per_process"]), device)
            wall = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    np.savez(out_path, scores=scores, idx=idx, pid=np.int32(rank),
             wall=np.float64(wall))
    return 0


def launch_local_screen(q_codes, t_codes, table, gi, ge, k,
                        num_processes: int = 2,
                        devices_per_process: int = 2,
                        timeout: float = 300.0, reps: int = 1,
                        return_walls: bool = False, *,
                        backend: str | None = None,
                        device: torch.device | None = None):
    """Run a library screen as a real multi-process group on this machine
    (local TCP rendezvous) over ``num_processes`` x ``devices_per_process``
    mesh entries.  Returns every rank's (scores, idx), each the
    one-process result; with ``return_walls`` also each rank's warm wall
    (the last of ``reps`` runs).

    device: None = :func:`device_from_env`; every rank gets it as
    ``AAT_TORCH_DEVICE``.  backend: None = NCCL on ``cuda``, gloo on
    ``cpu``; NCCL with more processes than visible cards raises before
    any rank starts.  On ``cuda`` the kernels are built here first, so
    the ranks load them."""
    device = device_from_env() if device is None else torch.device(device)
    backend = backend or _backend_for(device)
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: expected 'nccl' or 'gloo'")
    if backend == "nccl":
        have = torch.cuda.device_count() if device.type == "cuda" else 0
        if num_processes > have:
            raise RuntimeError(f"NCCL needs a card per rank: {num_processes} "
                               f"ranks, {have} visible cards")
    if device.type == "cuda":
        from ..ops import _build
        _build.load()
    with tempfile.TemporaryDirectory(prefix="aat_dist_") as tmp:
        data_path = os.path.join(tmp, "inputs.npz")
        np.savez(data_path, q_codes=np.asarray(q_codes, np.int32),
                 t_codes=np.asarray(t_codes, np.int32),
                 table=np.asarray(table, np.float32))
        spec = {"coordinator": f"127.0.0.1:{free_port()}",
                "backend": backend, "num_processes": int(num_processes),
                "devices_per_process": int(devices_per_process),
                "data": data_path, "gi": float(gi), "ge": float(ge),
                "k": int(k), "reps": int(reps)}
        spec_path = os.path.join(tmp, "spec.json")
        with open(spec_path, "w") as f:
            json.dump(spec, f)
        env = dict(os.environ)
        env[_ENV_DEVICE] = device.type
        env["PYTHONPATH"] = _ROOT + os.pathsep + env.get("PYTHONPATH", "")
        env.pop(_ENV_COORD, None)
        outs = [os.path.join(tmp, f"out_{r}.npz")
                for r in range(num_processes)]
        _run_ranks(spec_path, outs, env, tmp, timeout)
        results, walls = [], []
        for out_path in outs:
            with np.load(out_path) as z:
                results.append((z["scores"].copy(), z["idx"].copy()))
                walls.append(float(z["wall"]))
    return (results, walls) if return_walls else results


def _tail(log) -> str:
    log.seek(0)
    return "\n".join(log.read().splitlines()[-15:])


def _run_ranks(spec_path: str, outs: list, env: dict, tmp: str,
               timeout: float) -> None:
    """Start one worker per rank and wait for all of them within
    ``timeout`` seconds; on the first failure or the timeout kill every
    worker still running and raise (a failure with the rank's last
    lines)."""
    procs, logs = [], []
    try:
        for rank, out_path in enumerate(outs):
            logs.append(open(os.path.join(tmp, f"log_{rank}.txt"), "w+"))
            procs.append(subprocess.Popen(
                [sys.executable, "-m",
                 "alignment_algos_tpu_torch.parallel.distributed",
                 spec_path, out_path, str(rank)],
                env=env, stdout=logs[-1], stderr=subprocess.STDOUT,
                text=True))
        deadline = time.monotonic() + timeout
        while True:
            rcs = [p.poll() for p in procs]
            for rank, rc in enumerate(rcs):
                if rc not in (None, 0):
                    raise RuntimeError(f"distributed worker {rank} failed "
                                       f"(rc={rc}):\n{_tail(logs[rank])}")
            if all(rc == 0 for rc in rcs):
                return
            if time.monotonic() > deadline:
                raise subprocess.TimeoutExpired(procs[0].args, timeout)
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()


if __name__ == "__main__":
    sys.exit(_worker_main(sys.argv[1:]))
