"""Library-screen entry points (counterpart of
``alignment_algos_tpu/ops/swscan.py``).

On the TPU the row-scan kernel is exact only for integer tables and gaps
with gi >= ge, so ``swscan.supported()`` gates it and other inputs route
to the strip kernel.  Here both entry points call K1
(:func:`.swaffine.sw_affine_scores`), which is exact for every gap value,
fractional ones included; that gate has no counterpart and no caller needs
one.  The one-hot similarity producers have none either: K1 looks the
similarity up from the table itself.
"""

from __future__ import annotations

import torch

from . import swaffine


def sw_rowscan_screen(q_codes, t_codes, table, gi: float, ge: float, *,
                      device: torch.device) -> torch.Tensor:
    """ONE query (Q,) against B templates (B, T) -> (B,) scores."""
    q, t, tab, gap = swaffine.to_device(q_codes, t_codes, table, gi, ge,
                                        device)
    return swaffine.sw_affine_scores(q, t, tab, gap)


def sw_rowscan_batch(q_codes, t_codes, table, gi: float, ge: float, *,
                     device: torch.device) -> torch.Tensor:
    """Distinct pairs (B, Q) x (B, T) -> (B,) scores."""
    q, t, tab, gap = swaffine.to_device(q_codes, t_codes, table, gi, ge,
                                        device)
    return swaffine.sw_affine_scores(q, t, tab, gap)
