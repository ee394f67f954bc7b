"""Actor-critic networks, PyTorch port of :mod:`gym_po_tpu.agents.networks`.

The torso is ``Linear`` + ``tanh`` layers; the heads are a logits (or
Gaussian mean) layer and a value layer, with the JAX package's orthogonal
initialisation.  For a ``Discrete`` observation the first layer indexes its
weight columns by the observation in place of one-hot × matmul: a one-hot
row sums a single term, so the two are exactly equal.

:func:`params_from_flax` carries the JAX package's flax parameters into a
``state_dict``, so both packages compute the same function.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..core import Box, Discrete, Space

__all__ = [
    "ActorCritic",
    "obs_features",
    "encode_obs",
    "make_actor_critic",
    "params_from_flax",
    "sample_action",
    "log_prob",
    "entropy",
]


def obs_features(space: Space) -> int:
    """Feature width of the flat encoding of an observation space."""
    if isinstance(space, Discrete):
        return int(space.n)
    if isinstance(space, Box):
        return int(np.prod(space.shape)) if space.shape else 1
    raise TypeError(f"Unsupported observation space {space!r}")


def encode_obs(space: Space, obs: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Flat-encode a raw observation: one-hot for Discrete, flatten for Box."""
    if isinstance(space, Discrete):
        return nn.functional.one_hot(obs.long(), space.n).to(dtype)
    flat = obs.reshape(*obs.shape[: obs.ndim - len(space.shape)], -1)
    return flat.to(dtype)


def _linear(n_in: int, n_out: int, gain: float) -> nn.Linear:
    layer = nn.Linear(n_in, n_out)
    nn.init.orthogonal_(layer.weight, gain)
    nn.init.zeros_(layer.bias)
    return layer


class ActorCritic(nn.Module):
    """MLP torso with categorical (Discrete) or Gaussian (Box) policy head.

    ``forward(obs)`` returns ``(pi, value)``: ``pi`` is
    ``{"kind": "categorical", "logits": ...}`` or
    ``{"kind": "gaussian", "mean": ..., "log_std": ...}``, as in the JAX
    package.
    """

    def __init__(self, obs_space: Space, action_space: Space,
                 hidden: Sequence[int] = (64, 64)):
        super().__init__()
        self.obs_space = obs_space
        self.action_space = action_space
        widths = [obs_features(obs_space), *hidden]
        self.torso = nn.ModuleList(
            _linear(a, b, math.sqrt(2)) for a, b in zip(widths, widths[1:])
        )
        if isinstance(action_space, Discrete):
            self.pi_head = _linear(widths[-1], action_space.n, 0.01)
        else:
            adim = int(np.prod(action_space.shape)) or 1
            self.pi_head = _linear(widths[-1], adim, 0.01)
            self.log_std = nn.Parameter(torch.zeros(adim))
        self.v_head = _linear(widths[-1], 1, 1.0)

    def forward(self, obs: torch.Tensor) -> Tuple[Dict[str, Any], torch.Tensor]:
        if isinstance(self.obs_space, Discrete):
            first = self.torso[0]
            x = torch.tanh(first.weight.t()[obs.long()] + first.bias)
            layers = self.torso[1:]
        else:
            x = encode_obs(self.obs_space, obs)
            layers = self.torso
        for layer in layers:
            x = torch.tanh(layer(x))
        if isinstance(self.action_space, Discrete):
            pi = {"kind": "categorical", "logits": self.pi_head(x)}
        else:
            pi = {"kind": "gaussian", "mean": self.pi_head(x),
                  "log_std": self.log_std}
        return pi, self.v_head(x).squeeze(-1)


def make_actor_critic(env, hidden: Sequence[int] = (64, 64)) -> ActorCritic:
    return ActorCritic(env.observation_space, env.action_space, tuple(hidden))


def params_from_flax(params_np: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Map the JAX package's flax ``ActorCritic`` params to a ``state_dict``.

    Flax names its layers ``Dense_0 .. Dense_{n+1}`` in call order: the ``n``
    torso layers, then the policy head, then the value head.  A flax
    ``kernel`` is ``[in, out]``; a ``Linear.weight`` is ``[out, in]``.
    Accepts the params with or without the top-level ``"params"`` key, as
    numpy arrays (e.g. ``jax.tree.map(np.asarray, params)``).
    """
    p = params_np.get("params", params_np)
    dense = sorted((k for k in p if k.startswith("Dense_")),
                   key=lambda k: int(k.split("_")[1]))
    names = [f"torso.{i}" for i in range(len(dense) - 2)] + ["pi_head", "v_head"]
    out: Dict[str, torch.Tensor] = {}
    for flax_name, name in zip(dense, names):
        kernel = np.asarray(p[flax_name]["kernel"], np.float32)
        out[f"{name}.weight"] = torch.from_numpy(kernel.T.copy())
        out[f"{name}.bias"] = torch.from_numpy(
            np.asarray(p[flax_name]["bias"], np.float32).copy()
        )
    if "log_std" in p:
        out["log_std"] = torch.from_numpy(np.asarray(p["log_std"], np.float32).copy())
    return out


# ---------------------------------------------------------------- policies
def sample_action(pi, generator: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample an action and its log-prob from a policy head output.

    Categorical heads use Gumbel-max, as ``jax.random.categorical`` does;
    the noise comes from ``generator``.
    """
    if pi["kind"] == "categorical":
        logits = pi["logits"]
        u = torch.rand(logits.shape, generator=generator, device=logits.device)
        u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
        action = torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)
        return action, log_prob(pi, action)
    std = torch.exp(pi["log_std"])
    eps = torch.randn(pi["mean"].shape, generator=generator,
                      device=pi["mean"].device)
    action = pi["mean"] + std * eps
    return action, log_prob(pi, action)


def log_prob(pi, action: torch.Tensor) -> torch.Tensor:
    if pi["kind"] == "categorical":
        logp = torch.log_softmax(pi["logits"], dim=-1)
        return torch.gather(logp, -1, action.long()[..., None])[..., 0]
    std = torch.exp(pi["log_std"])
    z = (action - pi["mean"]) / std
    return torch.sum(
        -0.5 * z**2 - pi["log_std"] - 0.5 * math.log(2 * math.pi), dim=-1
    )


def entropy(pi) -> torch.Tensor:
    if pi["kind"] == "categorical":
        logp = torch.log_softmax(pi["logits"], dim=-1)
        return -torch.sum(torch.exp(logp) * logp, dim=-1)
    return torch.sum(
        pi["log_std"] + 0.5 * math.log(2 * math.pi * math.e), dim=-1
    )
