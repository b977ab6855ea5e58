"""PyTorch + CUDA port of ``alignment_algos_tpu`` (the JAX package stays
beside it as the reference).

Module names mirror the JAX package's, so each counterpart is found under
the same path.  The port imports ``torch`` and never ``jax``; framework-free
host layers (FASTA encoding, substitution tables, parameters, ali_dist,
UPGMA) are imported from ``alignment_algos_tpu`` rather than copied.

Conventions: functions that take host (numpy) data take an explicit
``device``; functions on tensors run where their tensors are.  A kernel
wrapper given CPU tensors runs the kernel's plain PyTorch version; given
CUDA tensors it launches the hand-written kernel or raises.
"""
