"""The alignment tools' shared entry point.

Each tool (``cli/<tool>.py``) is a copy of the reference tool's module
(``alignment_algos_tpu/cli/<tool>.py``) whose ``main`` runs the tool's
``_run`` through :func:`run_tool`: the port's device check and trace in
place of the JAX platform setup, then the reference's error handling.
"""

from __future__ import annotations

import sys

from ..utils.torchenv import device_from_env, maybe_start_trace


def run_tool(run, argv=None, *args) -> int:
    """A reference tool's ``main``: ``run(argv, *args)`` with its error
    handling (a bad input prints its message and returns -1), after the
    device is checked (``AAT_TORCH_DEVICE=cuda`` without a card is such an
    error) and the whole-process trace started where ``AAT_TRACE_DIR``
    asks for one."""
    argv = argv if argv is not None else sys.argv[1:]
    try:
        device_from_env()
    except RuntimeError as e:
        print(e, file=sys.stderr)
        return -1
    maybe_start_trace()
    try:
        return run(argv, *args)
    except (ValueError, OSError) as e:
        print(e, file=sys.stderr)
        return -1
