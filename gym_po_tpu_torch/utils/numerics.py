"""Float helpers that round as IEEE 754 does on every device.

PyTorch's CPU ``sqrt`` on float32 (its vectorized kernel) is not correctly
rounded: against numpy it differs in the last bit for some inputs.  XLA's
CPU square root and the CUDA kernels' ``sqrtf`` (``-prec-sqrt=true``,
nvcc's default) are correctly rounded, so the port's twins take their
float32 square roots here.
"""

from __future__ import annotations

import math

import torch

__all__ = ["sqrt_rn"]


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root of a float32 tensor, on any device;
    another dtype goes to ``torch.sqrt`` as it is.

    A float64 square root rounded to float32 is within one float32 ulp of
    the answer; one step either way fixes it.  The midpoints between it and
    its neighbours are exact in float64, and so are their squares (at most 50
    significant bits), so comparing them with ``x`` decides exactly; no
    float32 square root lies on a midpoint."""
    if x.dtype != torch.float32:
        return torch.sqrt(x)
    xd = x.double()
    r = torch.sqrt(xd).float()
    up = torch.nextafter(r, torch.full_like(r, math.inf))
    down = torch.nextafter(r, torch.zeros_like(r))
    hi = (r.double() + up.double()) * 0.5
    lo = (r.double() + down.double()) * 0.5
    return torch.where(hi * hi < xd, up, torch.where(lo * lo > xd, down, r))
