"""PyTorch + CUDA port of ``alignment_algos_tpu`` (the JAX package stays
beside it as the reference).

Module names mirror the JAX package's, so each counterpart is found under
the same path.  The port imports ``torch`` and never ``jax``, and nothing
of ``alignment_algos_tpu``: the framework-free host layers it needs
(``seq``, ``scoring``, ``io``, ``structure``, ``ssss``, ``analysis``,
``core``, ``utils``, the numpy DP engines and the ``native`` C/C++
sources) are copies of the JAX package's modules, byte-equal to them but
for the differences that ``tests/test_torch_isolation.py`` names.  Their
native libraries build at first use into ``build/``.

Conventions: functions that take host (numpy) data take an explicit
``device``; functions on tensors run where their tensors are.  A kernel
wrapper given CPU tensors runs the kernel's plain PyTorch version; given
CUDA tensors it launches the hand-written kernel or raises.
"""
