"""Draw contract of the port's kernels: the plain PyTorch twin of
``csrc/kernel_rng.cuh``.

Port of :mod:`gym_po_tpu.ops.kernel_rng` (``KernelRNG``).  A kernel draws
one uint32 per env at each numbered *site* of its loop body, every step,
whatever its masks say.  Sites are numbered in body order and restart at 0
every step.  Two modes:

* **Tape mode** reads the JAX package's int32 tape, with the same shape and
  indexing as ``KernelRNG.draw32``: for env ``e`` with tile
  ``g = e // (R*128)``, draw site ``j`` at step ``t`` sits at row
  ``g*slab + (j*K + t)*R + (e//128) % R``, column ``e % 128``, where
  ``slab = n_sites*K*R``.  The same tape through the JAX kernel (interpreted)
  and through the port gives the same trajectories, bit for bit.
* **Perf mode** is counter-based Philox4x32-10 (Salmon et al., SC'11),
  keyed on the 64-bit ``seed`` and countered on ``(e, t, j // 4, 0)``; site
  ``j`` takes word ``j % 4`` of its block.  A draw is a function of
  ``(seed, e, t, j)`` alone, so it does not depend on the launch geometry,
  and the kernel and this twin agree bit for bit.  ``t`` restarts at 0 every
  call: chained calls pass a new seed each, as the JAX package does.

uint32 arithmetic is done in int64 and masked with ``0xFFFFFFFF``: torch's
CPU coverage of uint32 is partial.  The 32x32->64 Philox product is split
into 16-bit halves so that no int64 product overflows.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch

__all__ = ["KernelRNG", "philox4x32_10", "W", "MAX_SITES"]

W = 128
MAX_SITES = 8  # two Philox blocks per env per step
MASK32 = 0xFFFFFFFF
PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85


def _mulhilo(a: int, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) words of the 64-bit product of constant ``a`` and ``b``."""
    t_lo = a * (b & 0xFFFF)  # < 2^48
    t_hi = a * (b >> 16)  # < 2^48
    lo_part = t_lo + ((t_hi & 0xFFFF) << 16)  # < 2^49
    return ((t_hi >> 16) + (lo_part >> 32)) & MASK32, lo_part & MASK32


def philox4x32_10(ctr, key) -> List[torch.Tensor]:
    """Philox4x32-10 of four int64 counter words (values in [0, 2^32)) and
    two key words (ints); returns the four output words as int64."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for i in range(10):
        if i:
            k0 = (k0 + PHILOX_W0) & MASK32
            k1 = (k1 + PHILOX_W1) & MASK32
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return [c0, c1, c2, c3]


class KernelRNG:
    """Per-env draws for a kernel's plain twin, vectorized over ``[B]``.

    Usage mirrors the JAX package's ``KernelRNG``::

        rng = KernelRNG(seed, B, K, n_sites, R, tape=tape, device=dev)
        for t in range(K):
            rng.begin_step(t)
            a = rng.rbits(5)
            ...
        rng.finalize(n_sites)
    """

    def __init__(self, seed: int, num_envs: int, num_steps: int, n_sites: int,
                 rows_per_tile: int = W, tape: Optional[torch.Tensor] = None,
                 device=None):
        if n_sites > MAX_SITES:
            raise ValueError(f"{n_sites} draw sites; at most {MAX_SITES}")
        self.num_steps = num_steps
        self.n_sites = n_sites
        self.key = (seed & MASK32, (seed >> 32) & MASK32)
        self._site = 0
        self._max_sites = 0
        self._step = 0
        if tape is not None:
            grid = num_envs // (rows_per_tile * W)
            # [tile, site, step, row, lane]: env order is (tile, row, lane)
            self._tape = tape.view(grid, n_sites, num_steps, rows_per_tile, W)
        else:
            self._tape = None
            self._env = torch.arange(num_envs, dtype=torch.int64, device=device)
            self._words: List[torch.Tensor] = []

    @staticmethod
    def tape_rows(n_sites: int, num_steps: int, R: int) -> int:
        """Rows of one tile's tape slab."""
        return n_sites * num_steps * R

    def begin_step(self, step: int) -> None:
        self._step = step
        self._site = 0
        if self._tape is None:
            e = self._env
            t = torch.full_like(e, step)
            z = torch.zeros_like(e)
            self._words = []
            for blk in range(-(-self.n_sites // 4)):
                self._words += philox4x32_10(
                    (e, t, torch.full_like(e, blk), z), self.key
                )

    def finalize(self, expected_sites: int) -> None:
        if self._max_sites != expected_sites:
            raise ValueError(
                f"kernel consumed {self._max_sites} draw sites per step but "
                f"was sized for {expected_sites}"
            )

    # -- draws -------------------------------------------------------------
    def draw32(self) -> torch.Tensor:
        """One ``[B]`` draw of uint32 bits, held in int64."""
        site = self._site
        self._site += 1
        self._max_sites = max(self._max_sites, self._site)
        if self._tape is None:
            return self._words[site]
        return self._tape[:, site, self._step].reshape(-1).to(torch.int64) & MASK32

    def rbits(self, n: int) -> torch.Tensor:
        """Uniform int32 in [0, n): ``u % n`` (bias <= n/2^32)."""
        return (self.draw32() % n).to(torch.int32)

    def r24(self) -> torch.Tensor:
        """Uniform int32 in [0, 2^24)."""
        return (self.draw32() >> 8).to(torch.int32)

    def runiform(self) -> torch.Tensor:
        """Exact f32 in [0, 1) from the top 24 bits."""
        return (self.draw32() >> 8).to(torch.float32) * (2.0**-24)

    def rnormal(self) -> torch.Tensor:
        """Box-Muller standard normal (two draw sites)."""
        u1 = torch.clamp(self.runiform(), min=1e-12)
        u2 = self.runiform()
        two_pi = torch.tensor(2.0 * math.pi, dtype=torch.float32)
        return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(two_pi * u2)
