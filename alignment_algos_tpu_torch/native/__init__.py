"""Native helpers: the shared build_native() loader for the host-runtime
C/C++ engines, plus libm-exact elementwise math (see exactmath.c).

Shared objects are built on first use with the system compiler into
``build/`` at the root of the checkout (where ``ops/_build.py`` builds the
CUDA kernels) under a CONTENT-HASHED name (`_<name>-<sha1[:12]>.so`).
Hashing the sources + flags into the file name makes staleness detection
exact: a leftover .so built from older sources can never be picked up
(mtime comparisons are useless after `git checkout`, which stamps every
file with the same time, and a stale engine once shipped a segfault).
The engines fall back to their exact Python/numpy paths when no compiler
is available; the libm functions below do not, because numpy's ``exp``
and ``log`` round differently from the host libm's: they raise.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

from ..ops._build import BUILD_DIR

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "exactmath.c")


def build_native(name: str, srcs: list[str], flags: tuple = (),
                 libs: tuple = (), compiler: str | None = None):
    """Compile srcs into a content-hash-named .so under ``build/`` and
    dlopen it.

    Returns the ctypes.CDLL, or None when the compiler is missing or the
    build fails.  The build is atomic (tmp + rename) so concurrent test
    processes can race safely, and the hash covers source bytes + flags so
    any edit forces a rebuild."""
    flags = tuple(flags) or ("-O2", "-ffp-contract=off")
    h = hashlib.sha1()
    try:
        for s in srcs:
            with open(s, "rb") as f:
                h.update(f.read())
    except OSError:
        return None
    h.update(" ".join(flags + tuple(libs)).encode())
    cc = compiler or ("cc" if all(s.endswith(".c") for s in srcs) else "c++")
    so = os.path.join(BUILD_DIR, f"_{name}-{h.hexdigest()[:12]}.so")
    if os.path.exists(so):
        st = os.stat(so)
        if st.st_uid != os.getuid() or (st.st_mode & 0o022):
            return None  # not ours / group-or-world writable: refuse
    else:
        tmp = f"{so}.tmp.{os.getpid()}"
        try:
            os.makedirs(BUILD_DIR, exist_ok=True)
            subprocess.run(
                [cc, *flags, "-shared", "-fPIC", "-o", tmp, *srcs, *libs],
                check=True, capture_output=True)
            os.replace(tmp, so)
        except (OSError, subprocess.CalledProcessError):
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return None
    try:
        return ctypes.CDLL(so)
    except OSError:
        return None


_lib = None
_tried = False


def _load():
    """The exactmath library; raises when it does not build."""
    global _lib, _tried
    if _lib is None and not _tried:
        _tried = True
        _lib = build_native("exactmath", [_SRC], flags=("-O2",),
                            libs=("-lm",), compiler="cc")
    if _lib is None:
        raise RuntimeError(
            f"{_SRC} did not build into {BUILD_DIR}: the host libm's "
            "float32 expf, logf and sqrtf are needed, and numpy's "
            "functions round differently")
    return _lib


def _vec_f32(fn_name: str):
    def apply(x: np.ndarray) -> np.ndarray:
        x = np.ascontiguousarray(x, dtype=np.float32)
        lib = _load()
        y = np.empty_like(x)
        getattr(lib, fn_name)(
            x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            y.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.c_long(x.size))
        return y
    return apply


expf = _vec_f32("v_expf")
logf = _vec_f32("v_logf")
sqrtf = _vec_f32("v_sqrtf")
