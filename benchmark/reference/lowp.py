"""Lower-precision rounding for the benchmark's controls.

A control is the plain reference computed one precision below the one
that the configuration states. For bf16 compute that is fp8: every
tensor a bf16 program would hold is rounded to float8 e4m3 with one scale
per tensor (the largest magnitude mapped to e4m3's 448). The arithmetic
itself stays float32.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one per-tensor scale, back in x's
    dtype."""
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / E4M3_MAX, torch.ones_like(amax))
    return ((x.float() / scale).to(torch.float8_e4m3fn).float()
            * scale).to(x.dtype)
