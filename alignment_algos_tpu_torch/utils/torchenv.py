"""Device selection for the port (counterpart of ``utils/jaxenv.py``).

``AAT_TORCH_DEVICE`` plays the part ``JAX_PLATFORMS`` plays for the JAX
package: ``cuda`` (the default) or ``cpu``.  Asking for ``cuda`` where no
card is visible raises: the port never drops to the CPU on its own.
"""

from __future__ import annotations

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
