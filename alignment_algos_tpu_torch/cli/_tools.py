"""Run the reference CLI tools' code on the port's engines.

Each reference tool (``alignment_algos_tpu/cli/<tool>.py``) keeps its whole
flow, parsing and byte-exact output in one ``_run`` function that names
``DPMatrix`` (and, for the S4 tools, ``SSSS``) as module globals.
:func:`rebound` makes a copy of such a function whose globals are the
reference module's plus the port's classes, so the one copy of the CLI code
runs with the port's engines; the reference module itself is never
touched.
"""

from __future__ import annotations

import sys
import types

from ..utils.torchenv import device_from_env


def rebound(func: types.FunctionType, **names) -> types.FunctionType:
    """``func`` with the globals in ``names`` replaced, in a new globals
    dict (the module ``func`` came from keeps its own)."""
    missing = sorted(set(names) - set(func.__globals__))
    if missing:
        raise NameError(f"{func.__module__}.{func.__qualname__} has no "
                        f"global(s) {missing}")
    out = types.FunctionType(func.__code__, {**func.__globals__, **names},
                             func.__name__, func.__defaults__,
                             func.__closure__)
    out.__kwdefaults__ = func.__kwdefaults__
    out.__qualname__ = func.__qualname__
    return out


def run_tool(run, argv=None, *args) -> int:
    """A reference tool's ``main``: ``run(argv, *args)`` with its error
    handling (a bad input prints its message and returns -1), after the
    device is checked (``AAT_TORCH_DEVICE=cuda`` without a card is such an
    error)."""
    argv = argv if argv is not None else sys.argv[1:]
    try:
        device_from_env()
    except RuntimeError as e:
        print(e, file=sys.stderr)
        return -1
    try:
        return run(argv, *args)
    except (ValueError, OSError) as e:
        print(e, file=sys.stderr)
        return -1
