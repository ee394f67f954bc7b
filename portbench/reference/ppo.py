"""Plain reference of a PPO update's learn half and of its acting.

Written from the published algorithm (Schulman et al. 2017, clipped
surrogate; generalized advantage estimation, Schulman et al. 2016) with
the hyperparameters the traffic file states: an MLP actor-critic (tanh
torso; a categorical or diagonal-Gaussian policy head and a value head;
a discrete observation indexes the first layer's weight columns, the
one-hot product it equals), advantages normalised over each minibatch by
their population deviation (+1e-8), the value loss clipped, the entropy
bonus, then a global-norm clip and Adam (eps as stated) on every
minibatch step.  It imports nothing of the port, and its parameters are
its own, a dict of named leaves.

``tf32`` rounds the operands of every matrix product to TF32's 10-bit
mantissa, as the card's tensor cores do with TF32 on (the control, the
same on any device); the reference itself multiplies in float32 with
TF32 off.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

Leaves = Dict[str, torch.Tensor]


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (8-bit exponent, 10-bit mantissa), to nearest."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def _mm(x, w, tf32: bool):
    """``x @ w.t()``; with ``tf32`` its operands rounded to TF32 in the
    forward pass (the gradients pass through the rounding as they are)."""
    if tf32:
        x = x + (to_tf32(x.detach()) - x.detach())
        w = w + (to_tf32(w.detach()) - w.detach())
    return x @ w.t()


def shapes(n_in: int, hidden: Sequence[int], n_out: int, gaussian: bool):
    """Leaf name -> shape (weights are ``[out, in]``)."""
    widths = [n_in, *hidden]
    out = {}
    for i, (a, b) in enumerate(zip(widths, widths[1:])):
        out[f"torso.{i}.weight"], out[f"torso.{i}.bias"] = (b, a), (b,)
    out["pi_head.weight"], out["pi_head.bias"] = (n_out, widths[-1]), (n_out,)
    out["v_head.weight"], out["v_head.bias"] = (1, widths[-1]), (1,)
    if gaussian:
        out["log_std"] = (n_out,)
    return out


def init_leaves(shape: Dict[str, tuple], generator: torch.Generator,
                device) -> Leaves:
    """Weights drawn in one call from ``generator``: normal, scaled by
    gain / sqrt(fan in) (the torso sqrt(2), the policy head 0.01, the value
    head 1); biases and ``log_std`` zero."""
    n = sum(math.prod(s) for k, s in shape.items() if k.endswith("weight"))
    z = torch.randn(n, generator=generator, device=device)
    leaves, at = {}, 0
    for k, s in shape.items():
        if not k.endswith("weight"):
            leaves[k] = torch.zeros(s, device=device)
            continue
        gain = 0.01 if k.startswith("pi_head") else 1.0 if k.startswith("v_head") \
            else math.sqrt(2.0)
        leaves[k] = (z[at:at + math.prod(s)].view(s) * (gain / math.sqrt(s[1]))).clone()
        at += math.prod(s)
    return leaves


def forward(p: Leaves, obs: torch.Tensor, n_hidden: int, discrete: bool,
            tf32: bool = False):
    """``(policy, value)``: the policy is ``("categorical", logits)`` or
    ``("gaussian", mean, log_std)``."""
    if discrete:
        x = torch.tanh(p["torso.0.weight"].t()[obs.long()] + p["torso.0.bias"])
    else:
        x = torch.tanh(_mm(obs.float(), p["torso.0.weight"], tf32) + p["torso.0.bias"])
    for i in range(1, n_hidden):
        x = torch.tanh(_mm(x, p[f"torso.{i}.weight"], tf32) + p[f"torso.{i}.bias"])
    head = _mm(x, p["pi_head.weight"], tf32) + p["pi_head.bias"]
    value = (_mm(x, p["v_head.weight"], tf32) + p["v_head.bias"])[..., 0]
    if "log_std" in p:
        return ("gaussian", head, p["log_std"]), value
    return ("categorical", head), value


def log_prob(pi, action: torch.Tensor) -> torch.Tensor:
    if pi[0] == "categorical":
        return torch.log_softmax(pi[1], -1).gather(-1, action.long()[..., None])[..., 0]
    _, mean, log_std = pi
    z = (action - mean) / torch.exp(log_std)
    return (-0.5 * z * z - log_std - 0.5 * math.log(2 * math.pi)).sum(-1)


def sampling_z(pi, action: torch.Tensor) -> float:
    """How far the sampled ``action`` rows lie from the policy's law, as the
    largest |z-score| of statistics that are normal under it.  Categorical:
    each action's count against its expected count, and the summed
    log-probability of the actions taken against its mean.  Gaussian: the
    mean of the standardized draws and the mean of their squares."""
    if pi[0] == "categorical":
        lp = torch.log_softmax(pi[1].double(), -1).reshape(-1, pi[1].shape[-1])
        p = lp.exp()
        a = action.long().reshape(-1)
        counts = torch.bincount(a, minlength=p.shape[1]).double()
        z = (counts - p.sum(0)) / (p * (1 - p)).sum(0).clamp(min=1e-30).sqrt()
        mean = (p * lp).sum(-1)
        var = (p * lp * lp).sum(-1) - mean * mean
        taken = lp.gather(-1, a[:, None])[:, 0]
        zl = (taken - mean).sum() / var.sum().clamp(min=1e-30).sqrt()
        z = torch.cat([z, zl[None]])
    else:
        _, mean, log_std = pi
        u = ((action.double() - mean.double()) / torch.exp(log_std.double())).reshape(-1)
        n = u.numel()
        z = torch.stack([u.mean() * math.sqrt(n), (u.square().mean() - 1) / math.sqrt(2 / n)])
    z = float(z.abs().max())
    return z if z == z else float("inf")


def entropy(pi) -> torch.Tensor:
    if pi[0] == "categorical":
        lp = torch.log_softmax(pi[1], -1)
        return -(lp.exp() * lp).sum(-1)
    return (pi[2] + 0.5 * math.log(2 * math.pi * math.e)).sum(-1).expand(pi[1].shape[:-1])


def gae(rew, value, v_next, done, cont, gamma: float, lam: float):
    """Advantages and value targets over ``[T, B]``: termination zeroes
    the bootstrap, any episode end stops the recursion."""
    adv = torch.zeros_like(value)
    run = torch.zeros_like(value[0])
    for t in reversed(range(value.shape[0])):
        delta = rew[t] + gamma * v_next[t] * (1.0 - done[t]) - value[t]
        run = delta + gamma * lam * cont[t] * run
        adv[t] = run
    return adv, adv + value


def loss(p: Leaves, rows: Dict[str, torch.Tensor], hp: Dict, n_hidden: int,
         discrete: bool, tf32: bool = False) -> torch.Tensor:
    pi, value = forward(p, rows["obs"], n_hidden, discrete, tf32)
    ratio = torch.exp(log_prob(pi, rows["action"]) - rows["logp"])
    a = rows["adv"]
    a = (a - a.mean()) / (a.std(correction=0) + 1e-8)
    eps = hp["clip_eps"]
    pg = -torch.minimum(ratio * a, ratio.clamp(1 - eps, 1 + eps) * a).mean()
    v_clip = rows["value"] + (value - rows["value"]).clamp(-eps, eps)
    v_loss = 0.5 * torch.maximum((value - rows["target"]) ** 2,
                                 (v_clip - rows["target"]) ** 2).mean()
    return pg + hp["value_coef"] * v_loss - hp["entropy_coef"] * entropy(pi).mean()


class Adam:
    """Adam (b1 0.9, b2 0.999) after a clip of the global gradient norm."""

    def __init__(self, p: Leaves, hp: Dict):
        self.hp = hp
        self.count = 0
        self.mu = {k: torch.zeros_like(v) for k, v in p.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in p.items()}

    @torch.no_grad()
    def step(self, p: Leaves, grads: Leaves) -> None:
        hp = self.hp
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).float()
        scale = torch.where(norm < hp["max_grad_norm"], 1.0, hp["max_grad_norm"] / norm)
        self.count += 1
        c1, c2 = 1 - 0.9 ** self.count, 1 - 0.999 ** self.count
        for k, g in grads.items():
            g = g * scale
            self.mu[k].mul_(0.9).add_(0.1 * g)
            self.nu[k].mul_(0.999).add_(0.001 * g * g)
            p[k].sub_(hp["learning_rate"] * (self.mu[k] / c1)
                      / (torch.sqrt(self.nu[k] / c2) + hp["adam_eps"]))


def learn(p: Leaves, opt: Adam, ro: Dict[str, torch.Tensor], orders, hp: Dict,
          n_hidden: int, discrete: bool, tf32: bool = False) -> float:
    """One update's learn half from its rollout ``ro`` (``[T, B]`` records)
    over the epochs' row ``orders``: returns the mean minibatch loss."""
    adv, target = gae(ro["reward"], ro["value"], ro["v_term"], ro["done"],
                      ro["cont"], hp["gamma"], hp["gae_lambda"])
    flat = {k: ro[k].reshape(-1, *ro[k].shape[2:])
            for k in ("obs", "action", "logp", "value")}
    flat["adv"], flat["target"] = adv.reshape(-1), target.reshape(-1)
    n = flat["adv"].numel()
    mb = n // hp["minibatches"]
    losses = []
    for order in orders:
        rows = {k: v[order] for k, v in flat.items()}
        for m in range(hp["minibatches"]):
            part = {k: v[m * mb:(m + 1) * mb] for k, v in rows.items()}
            q = {k: v.detach().requires_grad_(True) for k, v in p.items()}
            val = loss(q, part, hp, n_hidden, discrete, tf32)
            grads = torch.autograd.grad(val, list(q.values()))
            opt.step(p, dict(zip(q, grads)))
            losses.append(float(val.detach()))
    return sum(losses) / len(losses)
