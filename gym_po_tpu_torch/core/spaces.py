"""Space descriptions, PyTorch port of :mod:`gym_po_tpu.core.spaces`.

Sampling takes an explicit ``torch.Generator`` in place of a ``jax.random``
key; samples land on the generator's device.  ``to_gymnasium()`` gives the
equal ``gymnasium.spaces`` value (gymnasium is imported only there).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple, Union

import numpy as np
import torch

__all__ = ["Space", "Discrete", "Box", "batch_space"]


class Space:
    """Base class for observation/action space descriptions."""

    shape: Tuple[int, ...]
    dtype: Any

    def sample(self, generator: torch.Generator) -> torch.Tensor:
        raise NotImplementedError

    def sample_vec(self, generator: torch.Generator, num: int) -> torch.Tensor:
        """Batch of ``num`` samples, leading axis first."""
        return torch.stack([self.sample(generator) for _ in range(num)])

    def contains(self, x) -> bool:
        raise NotImplementedError

    def to_gymnasium(self):
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Discrete(Space):
    """``{0, 1, ..., n-1}``."""

    n: int
    dtype: Any = torch.int32

    @property
    def shape(self) -> Tuple[int, ...]:
        return ()

    def sample(self, generator: torch.Generator) -> torch.Tensor:
        return self._sample_shaped(generator, ())

    def sample_vec(self, generator: torch.Generator, num: int) -> torch.Tensor:
        return self._sample_shaped(generator, (num,))

    def _sample_shaped(self, generator, shape) -> torch.Tensor:
        return torch.randint(0, self.n, shape, generator=generator,
                             device=generator.device, dtype=self.dtype)

    def contains(self, x) -> bool:
        x = np.asarray(x)
        return bool(np.all((x >= 0) & (x < self.n)))

    def to_gymnasium(self):
        import gymnasium

        return gymnasium.spaces.Discrete(int(self.n))


@dataclasses.dataclass(frozen=True)
class Box(Space):
    """Bounded box in R^shape (bounds broadcast to ``shape``)."""

    low: Union[float, np.ndarray]
    high: Union[float, np.ndarray]
    shape: Tuple[int, ...] = ()
    dtype: Any = torch.float32

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(self.shape))

    @property
    def low_arr(self) -> np.ndarray:
        return np.broadcast_to(np.asarray(self.low), self.shape)

    @property
    def high_arr(self) -> np.ndarray:
        return np.broadcast_to(np.asarray(self.high), self.shape)

    def sample(self, generator: torch.Generator) -> torch.Tensor:
        return self._sample_shaped(generator, self.shape)

    def sample_vec(self, generator: torch.Generator, num: int) -> torch.Tensor:
        return self._sample_shaped(generator, (num, *self.shape))

    def _sample_shaped(self, generator, shape) -> torch.Tensor:
        # unbounded dimensions sample from [-1, 1), as the JAX package does
        dev = generator.device
        low = torch.as_tensor(self.low_arr, dtype=torch.float32, device=dev)
        high = torch.as_tensor(self.high_arr, dtype=torch.float32, device=dev)
        finite = torch.isfinite(low) & torch.isfinite(high)
        u = torch.rand(shape, generator=generator, device=dev)
        lo = torch.where(finite, low, -1.0)
        hi = torch.where(finite, high, 1.0)
        return (lo + u * (hi - lo)).to(self.dtype)

    def contains(self, x) -> bool:
        x = np.asarray(x)
        return bool(
            x.shape == self.shape
            and np.all(x >= self.low_arr - 1e-6)
            and np.all(x <= self.high_arr + 1e-6)
        )

    def to_gymnasium(self):
        import gymnasium

        np_dtype = torch.empty((), dtype=self.dtype).numpy().dtype
        return gymnasium.spaces.Box(
            self.low_arr.astype(np_dtype),
            self.high_arr.astype(np_dtype),
            self.shape,
            dtype=np_dtype,
        )


def batch_space(space: Space, num: int) -> Space:
    """Add a leading batch axis of size ``num`` (gymnasium ``batch_space``)."""
    if isinstance(space, Discrete):
        return Box(0, space.n - 1, (num,), dtype=space.dtype)
    if isinstance(space, Box):
        return Box(
            np.broadcast_to(space.low_arr, (num, *space.shape)),
            np.broadcast_to(space.high_arr, (num, *space.shape)),
            (num, *space.shape),
            dtype=space.dtype,
        )
    raise TypeError(f"Cannot batch {type(space)}")
