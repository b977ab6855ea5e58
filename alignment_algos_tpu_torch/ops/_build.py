"""Build and load the port's CUDA kernels (the CUDA counterpart of
``native.build_native``, which builds the host C/C++ engines into the same
``build/``).

``ops/csrc/*.cu`` compile at first use with ``nvcc``, one process per
source started together, and link into one shared library with a plain C
interface, loaded with ``ctypes``.  No PyTorch headers are included, so a
build takes seconds, not minutes.  The output
lands in ``build/`` at the root of the checkout under a name hashed from
the source bytes and the flags, so an edit can never pick up a stale
library (the lesson ``build_native`` records).  The build is atomic
(tmp + rename), so concurrent processes may race.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass

_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# argtypes of every C entry point in csrc/ (pointers and the stream as
# c_void_p: a bare Python int would be cut to 32 bits)
SIGNATURES = {
    "sw_rows_per_warp": (),
    "sw_scores_launch": (_P, _I, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _P),
    "sw_tb_launch": (_P, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                     _P),
    "sw_decode_launch": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                         _I, _I, _I, _P),
    "dp_general_launch": (_P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P),
    "dp_general_max_t2": (_I,),
    "dp_tb_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                     _I, _I, _I, _I, _P, _I, _P),
    "dp_tb_max_active_clusters": (_I, _I, _I),
    "dp_tb_smem_optin": (),
    "hmap_sim_launch": (_P, _I, _I, _P, _I, _I, _I, _F, _I, _I, _P),
    "hmap_znorm_launch": (_P, _P, _I, _I, _F, _I, _P),
    "hmap_znorm_apply_elems": (),
    "transpose_i32_launch": (_P, _P, _I, _I, _P),
}


@dataclass
class Built:
    """The loaded library and how it was obtained."""
    lib: ctypes.CDLL
    path: str
    seconds: float      # nvcc wall time; 0.0 when the library was cached
    log: str            # nvcc's stderr (ptxas -v register/smem/spill lines)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME): the CUDA "
                           "kernels build only where the CUDA toolkit is "
                           "installed")
    return path


@functools.lru_cache(maxsize=None)
def load() -> Built:
    """Compile ``csrc/*.cu`` if needed and load it; raises on any failure
    (there is no fallback: a CUDA tensor needs its kernel)."""
    srcs = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    h = hashlib.sha1()
    for s in srcs:
        with open(s, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    so = os.path.join(BUILD_DIR, f"aat_kernels-{h.hexdigest()[:12]}.so")
    seconds, log = 0.0, ""
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.tmp.{os.getpid()}"
        nvcc = _nvcc()
        t0 = time.perf_counter()
        objs = [f"{tmp}.{os.path.basename(s)}.o" for s in srcs]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", o, s],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(srcs, objs)]
        logs = [p.communicate()[0] for p in procs]
        log = "".join(logs)
        bad = [s for s, p in zip(srcs, procs) if p.returncode != 0]
        if not bad:
            link = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o",
                                   tmp, *objs],
                                  capture_output=True, text=True)
            log += link.stdout + link.stderr
            if link.returncode != 0:
                bad = ["link"]
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
        seconds = time.perf_counter() - t0
        if bad:
            raise RuntimeError(f"nvcc failed ({', '.join(bad)}):\n{log}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return Built(lib=lib, path=so, seconds=seconds, log=log)


def check(err: int, what: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
