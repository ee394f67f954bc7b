"""Batched solves of the ant's small SPD systems, PyTorch port of
:mod:`gym_po_tpu.physics.linalg`.

:func:`chol_solve` solves ``H x = g`` for ``H [..., n, n]`` SPD and
``g [..., n]`` (n = 14: ``M qacc = qfrc`` in smooth dynamics, ``H dq = -g``
in each Newton iteration) with ``torch.linalg.cholesky_ex`` under
``check_errors=False`` and two ``torch.linalg.solve_triangular`` calls,
three launches.  ``cholesky_ex`` leaves its ``info`` on the device (the
checked ``torch.linalg.cholesky`` reads it on the host, a sync per call),
and the triangular solves build their batch pointers on the device, so a
CUDA graph can capture the solve.  (``torch.cholesky_solve`` on a CUDA
batch goes through MAGMA, which fills its pointer arrays on the host.)

The JAX package's column-unrolled form, written in batched torch ops, is
about 16 launches per column: ``chip_smoke.py`` times it against this one
on the card.
"""

from __future__ import annotations

import torch

__all__ = ["chol_solve"]


def chol_solve(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Solve ``H x = g`` for SPD ``H`` ([..., n, n]) and ``g`` ([..., n])."""
    L, _ = torch.linalg.cholesky_ex(H, check_errors=False)
    y = torch.linalg.solve_triangular(L, g.unsqueeze(-1), upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True).squeeze(-1)
