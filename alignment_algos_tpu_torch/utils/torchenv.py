"""Device selection for the port (counterpart of ``utils/jaxenv.py``).

``AAT_TORCH_DEVICE`` plays the part ``JAX_PLATFORMS`` plays for the JAX
package: ``cuda`` (the default) or ``cpu``.  Asking for ``cuda`` where no
card is visible raises: the port never drops to the CPU on its own.
``AAT_TRACE_DIR`` makes every tool trace its whole process
(:func:`maybe_start_trace`): the card's kernels and copies, and the
program's own ``aat.`` ranges (``utils.profiling.span``).
"""

from __future__ import annotations

import atexit
import os

import torch

ENV = "AAT_TORCH_DEVICE"


def device_from_env() -> torch.device:
    want = os.environ.get(ENV, "cuda").strip().lower() or "cuda"
    if want not in ("cuda", "cpu"):
        raise RuntimeError(f"{ENV}={want!r}: expected 'cuda' or 'cpu'")
    if want == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{ENV}=cuda but torch.cuda.is_available() is "
                           f"False; set {ENV}=cpu to run on the host")
    return torch.device(want)


_trace = []     # the whole-process profiler, once started


def maybe_start_trace() -> None:
    """When ``AAT_TRACE_DIR`` is set, start a whole-process profiler
    (``utils.profiling``) once; while it records, the program's spans
    record too, and at interpreter exit it stops and writes its trace
    there (counterpart of ``jaxenv._maybe_start_trace``).  The stop
    is registered after torch's own exit handlers, so it runs before
    them, while the card is still up."""
    from . import profiling

    logdir = os.environ.get(profiling.ENV)
    if not logdir or _trace:
        return
    prof = profiling.profiler()
    prof.start()
    _trace.append(prof)
    atexit.register(_stop_trace, prof, logdir)


def _stop_trace(prof, logdir: str) -> None:
    from . import profiling

    prof.stop()
    profiling.export(prof, logdir)
