"""Actor-critic networks, PyTorch port of :mod:`gym_po_tpu.agents.networks`.

The torso is ``Linear`` + ``tanh`` layers; the heads are a logits (or
Gaussian mean) layer and a value layer, with the JAX package's orthogonal
initialisation.  For a ``Discrete`` observation the first layer indexes its
weight columns by the observation in place of one-hot × matmul: a one-hot
row sums a single term, so the two are exactly equal.

``compute_dtype`` is the JAX package's: the torso computes in it (input,
weight and bias cast to it, each product and bias add rounded to it, as
flax's ``Dense(dtype=...)``), the heads compute in float32 on the torso's
output promoted to float32, and the parameters stay float32.  The casts
are explicit, at flax's rounding points (no ``torch.autocast``); in
float32 they are no-ops.

:func:`params_from_flax` carries the JAX package's flax parameters into a
``state_dict``, so both packages compute the same function, and
:func:`adam_state_from_optax` carries an optax Adam state into the port's
:class:`AdamState`, so both can start from the same point of a run.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..core import Box, Discrete, Space
from ..ops.embed import embed_grad

__all__ = [
    "ActorCritic",
    "COMPUTE_DTYPES",
    "check_compute_dtype",
    "dense",
    "embed_discrete",
    "obs_features",
    "encode_obs",
    "make_actor_critic",
    "params_from_flax",
    "parameter_list",
    "flatten_parameters",
    "AdamState",
    "adam_state_from_optax",
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


#: the compute dtypes the networks take (the JAX package's two)
COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


def check_compute_dtype(dtype) -> None:
    if dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype {dtype} is not supported: the port's "
                         "networks compute in float32 or bfloat16")


def dense(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
          dtype: torch.dtype) -> torch.Tensor:
    """A linear layer computed as flax's ``Dense(dtype=dtype)``.

    In float32 it is ``F.linear`` (what ``nn.Linear`` computes).  Otherwise
    input, weight and bias are cast to ``dtype`` and the product is rounded
    to it before the bias is added, as XLA computes flax's layer
    (``F.linear``'s fused bias add rounds once, and differs in the last bit
    of ``dtype``).
    """
    if dtype == torch.float32:
        return nn.functional.linear(x, weight, bias)
    y = x.to(dtype) @ weight.to(dtype).t()
    return y if bias is None else y + bias.to(dtype)


class _EmbedDiscrete(torch.autograd.Function):
    """The index and bias add of :func:`embed_discrete`, with the weight's
    and the bias's gradients from :func:`~gym_po_tpu_torch.ops.embed.embed_grad`
    (a fixed-order kernel on the card, the plain twin on the CPU) in place
    of autograd's index backward."""

    @staticmethod
    def forward(ctx, obs, weight, bias, dtype):
        ctx.save_for_backward(obs.to(torch.int32))
        ctx.n = weight.shape[1]
        return weight.to(dtype).t()[obs.long()] + bias.to(dtype)

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        gw, gb = embed_grad(grad, idx, ctx.n)
        return None, gw, gb, None


def embed_discrete(layer: nn.Linear, obs: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
    """A first layer over a one-hot observation, as an index into its weight
    columns: one-hot x matmul sums a single term, so in either dtype the two
    are equal.  Its backward sums the rows of each observation in float32
    (rounded once to ``dtype``), as the one-hot product's would."""
    return _EmbedDiscrete.apply(obs, layer.weight, layer.bias, dtype)


def _linear(n_in: int, n_out: int, gain: float, generator, device) -> nn.Linear:
    # skip_init: nn.Linear's own init would draw from torch's global generator
    layer = nn.utils.skip_init(nn.Linear, n_in, n_out,
                               device="cpu" if device is None else device)
    nn.init.orthogonal_(layer.weight, gain, generator=generator)
    nn.init.zeros_(layer.bias)
    return layer


class ActorCritic(nn.Module):
    """MLP torso with categorical (Discrete) or Gaussian (Box) policy head.

    ``forward(obs)`` returns ``(pi, value)``: ``pi`` is
    ``{"kind": "categorical", "logits": ...}`` or
    ``{"kind": "gaussian", "mean": ..., "log_std": ...}``, as in the JAX
    package.  The weights are made on ``device`` from ``generator`` (torch's
    global generator when it is ``None``).  The torso computes in
    ``compute_dtype`` (float32 or bfloat16), the heads in float32.
    """

    def __init__(self, obs_space: Space, action_space: Space,
                 hidden: Sequence[int] = (64, 64),
                 generator: Optional[torch.Generator] = None, device=None,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        check_compute_dtype(compute_dtype)
        self.obs_space = obs_space
        self.action_space = action_space
        self.compute_dtype = compute_dtype
        widths = [obs_features(obs_space), *hidden]
        self.torso = nn.ModuleList(
            _linear(a, b, math.sqrt(2), generator, device)
            for a, b in zip(widths, widths[1:])
        )
        if isinstance(action_space, Discrete):
            self.pi_head = _linear(widths[-1], action_space.n, 0.01, generator,
                                   device)
        else:
            adim = int(np.prod(action_space.shape)) or 1
            self.pi_head = _linear(widths[-1], adim, 0.01, generator, device)
            self.log_std = nn.Parameter(torch.zeros(adim, device=device))
        self.v_head = _linear(widths[-1], 1, 1.0, generator, device)

    def forward(self, obs: torch.Tensor) -> Tuple[Dict[str, Any], torch.Tensor]:
        dt = self.compute_dtype
        if isinstance(self.obs_space, Discrete):
            x = torch.tanh(embed_discrete(self.torso[0], obs, dt))
            layers = self.torso[1:]
        else:
            x = encode_obs(self.obs_space, obs, dt)
            layers = self.torso
        for layer in layers:
            x = torch.tanh(dense(x, layer.weight, layer.bias, dt))
        x = x.float()
        if isinstance(self.action_space, Discrete):
            pi = {"kind": "categorical", "logits": self.pi_head(x)}
        else:
            pi = {"kind": "gaussian", "mean": self.pi_head(x),
                  "log_std": self.log_std}
        return pi, self.v_head(x).squeeze(-1)


def make_actor_critic(env, hidden: Sequence[int] = (64, 64),
                      generator: Optional[torch.Generator] = None,
                      device=None,
                      compute_dtype: torch.dtype = torch.float32) -> ActorCritic:
    return ActorCritic(env.observation_space, env.action_space, tuple(hidden),
                       generator, device, compute_dtype)


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


def parameter_list(model: ActorCritic) -> List[nn.Parameter]:
    """The model's parameters in :func:`params_from_flax`'s name order: the
    torso layers, the policy head, the value head (weight, then bias), then
    ``log_std``."""
    named = dict(model.named_parameters())
    names = [f"{layer}.{w}" for layer in
             [f"torso.{i}" for i in range(len(model.torso))] + ["pi_head", "v_head"]
             for w in ("weight", "bias")]
    return [named[n] for n in names + (["log_std"] if "log_std" in named else [])]


def flatten_parameters(model: nn.Module,
                       params: Optional[List[nn.Parameter]] = None) -> torch.Tensor:
    """Move the model's parameters into one flat buffer, in the order of
    ``params`` (default :func:`parameter_list`'s), and return it.

    Each parameter becomes a view of the buffer, so an optimizer step over
    the buffer updates the model in place (``load_state_dict`` keeps the
    views: it copies into them).
    """
    if params is None:
        params = parameter_list(model)
    flat = torch.cat([p.detach().reshape(-1) for p in params])
    offset = 0
    for p in params:
        p.data = flat[offset:offset + p.numel()].view_as(p)
        offset += p.numel()
    return flat


@dataclasses.dataclass
class AdamState:
    """Adam's step count and moments over a flat parameter buffer.

    ``count`` is an int32 scalar, incremented before it is used, as optax's;
    ``mu`` and ``nu`` are flat, in :func:`parameter_list`'s order.
    """

    count: torch.Tensor
    mu: torch.Tensor
    nu: torch.Tensor

    @classmethod
    def zeros_like(cls, flat: torch.Tensor) -> "AdamState":
        return cls(torch.zeros((), dtype=torch.int32, device=flat.device),
                   torch.zeros_like(flat), torch.zeros_like(flat))


def adam_state_from_optax(opt_state_np, layout=params_from_flax) -> AdamState:
    """Map optax's ``ScaleByAdamState`` (``count``, ``mu``, ``nu``, as numpy)
    to an :class:`AdamState` on the CPU.

    Accepts the ``ScaleByAdamState`` itself or any tuple holding it, such as
    the state of ``optax.chain(clip_by_global_norm(...), adam(...))``.  The
    moments are flax param trees; they are laid out as ``layout`` lays out
    the params (:func:`params_from_flax` for ``ActorCritic``, kernels
    transposed).
    """

    def find(x):
        if hasattr(x, "mu") and hasattr(x, "nu") and hasattr(x, "count"):
            return x
        if isinstance(x, (tuple, list)):
            for item in x:
                found = find(item)
                if found is not None:
                    return found
        return None

    adam = find(opt_state_np)
    if adam is None:
        raise ValueError("no optax ScaleByAdamState (count, mu, nu) found")

    def flat(tree):
        return torch.cat([t.reshape(-1) for t in layout(tree).values()])

    return AdamState(
        count=torch.tensor(int(adam.count), dtype=torch.int32),
        mu=flat(adam.mu),
        nu=flat(adam.nu),
    )


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
