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
  ``j`` takes word ``j % 4`` of its block, so a step of ``n_sites`` draws
  runs ``philox_blocks(n_sites)`` blocks and sites 0-7 keep their words
  whatever ``n_sites`` is.  A draw is a function of
  ``(seed, e, t, j)`` alone, so it does not depend on the launch geometry,
  and the kernel and this twin agree bit for bit.  ``t`` restarts at 0 every
  call: chained calls pass a new seed each, as the JAX package does.

uint32 arithmetic is done in int64 and masked with ``0xFFFFFFFF``: torch's
CPU coverage of uint32 is partial.  The 32x32->64 Philox product is split
into 16-bit halves so that no int64 product overflows.

Division by a map constant: :class:`UDiv` holds the constants of
``gpt::UDiv`` in ``csrc/kernel_rng.cuh`` (division by an invariant integer
as one multiply-add and a shift, exact for every uint32), computed here once
per ``make_fused_*`` call and passed in the kernel's parameters; :func:`udivmod` is
the device formula written out for the tests.

``rnormal`` calls the module-level ``_log`` and ``_cos`` (``torch.log`` and
``torch.cos``).  On the card they are the same f32 ``logf``/``cosf`` the
kernels call; on the CPU torch's libm and XLA's differ in the last bit for a
few per cent of inputs, so a test that holds a twin to the JAX package's
kernel bit for bit sets these two names to XLA's functions.  Its square
root is :func:`~gym_po_tpu_torch.utils.numerics.sqrt_rn`, correctly rounded
on every device, as XLA's and the kernels' are.
"""

from __future__ import annotations

import ctypes
import math
from typing import List, Optional, Tuple

import torch

from ..utils.numerics import sqrt_rn

__all__ = ["KernelRNG", "philox4x32_10", "philox_blocks", "check_batch", "W",
           "UDiv", "udivmod"]

W = 128
MASK32 = 0xFFFFFFFF
_log = torch.log  # the transcendentals rnormal calls (see the module note)
_cos = torch.cos
PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85


def _mulhilo(a: int, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) words of the 64-bit product of constant ``a`` and ``b``."""
    t_lo = a * (b & 0xFFFF)  # < 2^48
    t_hi = a * (b >> 16)  # < 2^48
    lo_part = t_lo + ((t_hi & 0xFFFF) << 16)  # < 2^49
    return ((t_hi >> 16) + (lo_part >> 32)) & MASK32, lo_part & MASK32


class UDiv(ctypes.Structure):
    """Constants of ``gpt::UDiv``: division by the invariant ``n``, exact for
    every uint32 ``u``, as ``u // n = ((mul * u + add) >> 32) >> sh``.  For
    ``n`` not a power of two, ``sh = floor(log2 n)`` and ``mul`` is the
    round-up multiplier ``ceil(2^(32+sh) / n)`` with ``add = 0`` where its
    error is at most ``2^sh`` (Granlund & Montgomery, PLDI 1994, thm. 4.2),
    else the round-down multiplier ``floor(2^(32+sh) / n)`` with the fix-up
    ``add = mul`` (Robison, ARITH 2005); a power of two ``2^k`` takes
    ``mul = 2^(32-k)``, and ``n = 1`` takes ``mul = add = 2^32 - 1``."""

    _fields_ = [("mul", ctypes.c_uint32), ("sh", ctypes.c_uint32),
                ("add", ctypes.c_uint64), ("n", ctypes.c_uint32),
                ("neg", ctypes.c_uint32)]  # neg = 2^32 - n (mod 2^32)

    @classmethod
    def of(cls, n: int) -> "UDiv":
        n = int(n)
        if not 1 <= n <= MASK32:
            raise ValueError(f"divisor must lie in [1, 2^32), got {n}")
        neg = -n & MASK32
        sh = n.bit_length() - 1  # floor(log2 n)
        if n == 1:
            return cls(MASK32, 0, MASK32, n, neg)
        if n == 1 << sh:
            return cls(1 << (32 - sh), 0, 0, n, neg)
        p = 1 << (32 + sh)
        up = -(-p // n)
        if up * n - p <= 1 << sh:  # round-up is exact
            return cls(up, sh, 0, n, neg)
        down = p // n  # p - down * n <= 2^sh: round-down with the fix-up
        return cls(down, sh, down, n, neg)

    def __repr__(self) -> str:
        return f"UDiv(n={self.n}, mul={self.mul:#x}, sh={self.sh}, add={self.add:#x})"


def udivmod(u: torch.Tensor, mul, sh, add, n) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(u // n, u % n)`` as ``gpt::udiv``/``gpt::umod`` compute them, for
    int64 ``u`` holding uint32 values; the constants are ints or int64
    tensors that broadcast against ``u`` (as :meth:`UDiv.of` makes them)."""
    hi, lo = _mulhilo(mul, u)  # mul * u, split: no int64 overflow
    q = (hi + ((lo + add) >> 32)) >> sh  # hi32(mul * u + add) >> sh
    return q, u - q * n  # the device adds q * (2^32 - n) mod 2^32: the same


def philox_blocks(n_sites: int) -> int:
    """Philox blocks one step of ``n_sites`` draws needs: four words each."""
    return -(-n_sites // 4)


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
            for blk in range(philox_blocks(self.n_sites)):
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
        return sqrt_rn(-2.0 * _log(u1)) * _cos(two_pi * u2)


def check_batch(s: torch.Tensor, rows: int, rng_tape: bool,
                tape_shape: Tuple[int, int],
                tape: Tuple[torch.Tensor, ...]) -> None:
    """Checks a kernel's ``[rows, 128]`` int32 state tile and its optional
    tape."""
    if not isinstance(s, torch.Tensor) or s.dtype != torch.int32:
        raise ValueError("s must be an int32 tensor")
    if tuple(s.shape) != (rows, W) or not s.is_contiguous():
        raise ValueError(f"s must be contiguous with shape {(rows, W)}, got "
                         f"{tuple(s.shape)}")
    if len(tape) != int(rng_tape):
        raise ValueError(f"run takes {int(rng_tape)} tape argument(s), got "
                         f"{len(tape)}")
    if rng_tape:
        tp = tape[0]
        if tuple(tp.shape) != tape_shape:
            raise ValueError(f"rng tape must have shape {tape_shape}, got "
                             f"{tuple(tp.shape)}")
        if (tp.dtype != torch.int32 or tp.device != s.device
                or not tp.is_contiguous()):
            raise ValueError("rng tape must be a contiguous int32 tensor on "
                             "s's device")
