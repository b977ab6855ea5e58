"""The float32 ``expf`` of the HMAP similarity (counterpart of the part of
``alignment_algos_tpu/ops/sf64.py`` that the producer needs).

The host path calls glibc 2.36's ``expf`` (``__expf_fma``) through the
port's ``native.expf``.  On the card, K5
(``csrc/hmap_device.cu`` ``expf_replica``) replicates it in native float64
with ``__fma_rn`` at exactly the sites where glibc fuses (sf64.py:444-457).
The TPU package emulated binary64 on uint32 pairs and corrected division
and square root in integers (``mul64``, ``fma64``, ``div32``, ``sqrt32``);
the H100 has IEEE float64, correctly rounded float32 ``/`` and ``sqrtf``,
and a fused fma, so none of that is ported.

Domain rule, as ``hmap_device._expf_ieee`` (the reference's documented
deviation in the 87-88 band): the replica on finite |x| < 87; beyond, +inf
for x > 0 and +0 otherwise; NaN passes through.

Torch has no fused fma on the CPU, so the plain version, :func:`expf_plain`,
calls the libm function being replicated on a host copy.  That library is
built at first use, and ``native.expf`` raises when the build fails (numpy's
``exp`` rounds differently).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native

__all__ = ["expf_plain", "host_libm_loaded"]

_BAND = 87.0


def host_libm_loaded() -> bool:
    """Builds and loads the port's libm library; True, or raises when it
    does not build."""
    return native._load() is not None


def expf_plain(x: torch.Tensor) -> torch.Tensor:
    """float32 expf with the domain rule above, on ``x``'s device (the
    values go through host libm)."""
    xh = x.detach().cpu().numpy().astype(np.float32)
    small = np.isfinite(xh) & (np.abs(xh) < np.float32(_BAND))
    e = native.expf(np.where(small, xh, np.float32(0.0)))
    big = np.where(xh > 0, np.float32(np.inf), np.float32(0.0))
    out = np.where(small, e, np.where(np.isnan(xh), xh, big))
    return torch.from_numpy(out.astype(np.float32)).to(x.device)
