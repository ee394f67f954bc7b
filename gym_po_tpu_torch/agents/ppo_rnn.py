"""Recurrent PPO (a GRU actor-critic), PyTorch port of
:mod:`gym_po_tpu.agents.ppo_rnn`.

The POMDP learner of the suite: a dense embedding, a GRU cell and the
feedforward network's heads.  The hidden state is carried through the
rollout and reset to zero where the previous step ended an episode (the
envs reset themselves).  The update is :mod:`~gym_po_tpu_torch.agents.ppo`'s
with backpropagation through time over whole rollout sequences: each epoch
permutes the env axis only, cuts it into M contiguous slices, and each
minibatch step replays its slice's T steps from the stored initial hidden
state.

As in the feedforward learner, the collect half is one CUDA graph on a CUDA
device (:class:`~gym_po_tpu_torch.agents.ppo.CollectGraph` with the hidden
state and the reset flags as further input buffers), the learn half runs
eagerly and updates one flat parameter buffer in place, and every draw
comes from the train state's ``torch.Generator``.

The GRU is written out in flax's own formula (flax 0.12.3 ``GRUCell``),
with ``(1 - z) * n + z * h`` as the update: ``nn.GRUCell`` forms
``n + z * (h - n)``, which rounds differently.  Its gates' kernels are
stacked (r, z, n) into one input and one recurrent product, which round
per element as flax's three do.  The BPTT replay computes the embedding,
the input projections and the heads once over the whole sequence, and only
the recurrent half inside the time loop.  In bfloat16 every product, bias
add and gate op rounds where XLA rounds flax's (its logistic as
``1 / (1 + exp(-x))``, each op rounded), and the hidden state is carried in
bfloat16.

Over a ``mesh`` the update is data parallel as the feedforward one: each
rank holds its rows of the envs, hidden state and reset flags
(:func:`shard_rnn_state`), each minibatch step averages the gradient over
the ranks, and the metrics are averaged at the end.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..core import Discrete, Space
from .networks import (
    AdamState,
    adam_state_from_optax,
    check_compute_dtype,
    dense,
    embed_discrete,
    encode_obs,
    flatten_parameters,
    obs_features,
    sample_action,
)
from .ppo import (
    CollectGraph,
    PPOConfig,
    _clone_state,
    _gae,
    _local_envs,
    _reward_metrics,
    _shard_state,
    mean_metrics,
    minibatch_step,
    ppo_loss,
)

__all__ = ["RecurrentActorCritic", "RNNTrainState", "init_rnn_state",
           "shard_rnn_state", "make_rnn_train_step", "collect_rnn", "learn_rnn",
           "env_orders",
           "rnn_params_from_flax", "rnn_parameter_list",
           "rnn_adam_state_from_optax", "Seq", "RNNRollout"]

GRU_GATES = ("ir", "iz", "in", "hr", "hz", "hn")  # flax's names
_GRU_BIASED = ("ir", "iz", "in", "hn")


def _layer(n_in: int, n_out: int, bias: bool, gain: Optional[float],
           generator, device) -> nn.Linear:
    """A linear layer with a zero bias and an orthogonal weight of ``gain``,
    or, for ``gain=None``, flax's default kernel init ``lecun_normal``: a
    normal truncated at two standard deviations, of variance 1 / fan_in."""
    # skip_init: nn.Linear's own init would draw from torch's global generator
    layer = nn.utils.skip_init(nn.Linear, n_in, n_out, bias=bias,
                               device="cpu" if device is None else device)
    if gain is None:
        std = math.sqrt(1.0 / n_in) / 0.87962566103423978
        nn.init.trunc_normal_(layer.weight, 0.0, std, -2 * std, 2 * std,
                              generator=generator)
    else:
        nn.init.orthogonal_(layer.weight, gain, generator=generator)
    if bias:
        nn.init.zeros_(layer.bias)
    return layer


class _Logistic(torch.autograd.Function):
    """The logistic function as XLA computes ``jax.nn.sigmoid`` in bfloat16:
    ``1 / (1 + exp(-x))``, each op rounded to the dtype (``torch.sigmoid``
    rounds once, and differs in the last bit); its gradient
    ``y * (1 - y)``, JAX's rule for it."""

    @staticmethod
    def forward(ctx, x):
        y = 1.0 / (1.0 + torch.exp(-x))
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        (y,) = ctx.saved_tensors
        return grad * y * (1.0 - y)


class RecurrentActorCritic(nn.Module):
    """Dense embed -> GRU -> categorical/Gaussian + value heads.

    ``forward(h, obs, reset)`` takes the hidden state ``[B, hidden]``, the
    observations and the flags ``[B]`` of envs whose previous step ended an
    episode (their hidden state restarts from zero), and returns
    ``(h', pi, value)`` with ``pi`` as :class:`~.networks.ActorCritic`'s.
    The embed and the GRU compute in ``compute_dtype``, the heads in
    float32.  The weights are drawn from ``generator`` on ``device`` as
    the JAX package's initialisers draw them: ``lecun_normal`` for the
    embed and the GRU's input kernels, orthogonal for its recurrent
    kernels and (gains 0.01 and 1) the heads, zero biases and ``log_std``.
    """

    def __init__(self, obs_space: Space, action_space: Space, hidden: int = 128,
                 compute_dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        check_compute_dtype(compute_dtype)
        self.obs_space = obs_space
        self.action_space = action_space
        self.hidden = hidden
        self.compute_dtype = compute_dtype
        self.embed = _layer(obs_features(obs_space), hidden, True, None,
                            generator, device)
        # flax's GRUCell: lecun_normal input kernels, each with a bias;
        # orthogonal recurrent kernels, of which only hn has a bias
        self.gru = nn.ModuleDict({
            gate: _layer(hidden, hidden, gate in _GRU_BIASED,
                         None if gate.startswith("i") else 1.0, generator, device)
            for gate in GRU_GATES})
        if isinstance(action_space, Discrete):
            n_out = action_space.n
        else:
            n_out = int(np.prod(action_space.shape)) or 1
            self.log_std = nn.Parameter(torch.zeros(n_out, device=device))
        self.pi_head = _layer(hidden, n_out, True, 0.01, generator, device)
        self.v_head = _layer(hidden, 1, True, 1.0, generator, device)

    def gate_weights(self) -> Tuple[torch.Tensor, ...]:
        """The GRU's input kernels and biases, and its recurrent kernels and
        biases, each stacked by gate (r, z, n) and cast to the compute
        dtype: ``(w_i [3H, H], b_i [3H], w_h [3H, H], b_h [3H])``.  ``hr``
        and ``hz`` have no bias: theirs is zero, which adds nothing."""
        dt, g = self.compute_dtype, self.gru
        b_hn = g["hn"].bias
        return (torch.cat([g["ir"].weight, g["iz"].weight, g["in"].weight]).to(dt),
                torch.cat([g["ir"].bias, g["iz"].bias, g["in"].bias]).to(dt),
                torch.cat([g["hr"].weight, g["hz"].weight, g["hn"].weight]).to(dt),
                torch.cat([torch.zeros_like(b_hn).repeat(2), b_hn]).to(dt))

    def inputs(self, obs: torch.Tensor, w_i: torch.Tensor,
               b_i: torch.Tensor) -> torch.Tensor:
        """The embedding of ``obs`` (any leading shape) and its three input
        projections ``[..., 3H]``: all of the cell's work that does not
        depend on the hidden state."""
        dt = self.compute_dtype
        if isinstance(self.obs_space, Discrete):
            x = embed_discrete(self.embed, obs, dt)
        else:
            x = dense(encode_obs(self.obs_space, obs, dt), self.embed.weight,
                      self.embed.bias, dt)
        return dense(torch.tanh(x), w_i, b_i, dt)

    def cell(self, h: torch.Tensor, xi: torch.Tensor, reset: torch.Tensor,
             w_h: torch.Tensor, b_h: torch.Tensor) -> torch.Tensor:
        """One GRU step from the input projections ``xi``, the hidden state
        zeroed where ``reset``: flax's formula, each gate's pre-activation
        the sum of its input and recurrent terms."""
        H = self.hidden
        h = h.masked_fill(reset[:, None], 0)
        hh_rz, hh_n = dense(h, w_h, b_h, self.compute_dtype).split([2 * H, H], -1)
        xi_rz, xi_n = xi.split([2 * H, H], -1)
        sigmoid = torch.sigmoid if self.compute_dtype == torch.float32 \
            else _Logistic.apply
        r, z = sigmoid(xi_rz + hh_rz).chunk(2, -1)
        n = torch.tanh(xi_n + r * hh_n)
        return (1.0 - z) * n + z * h

    def heads(self, h: torch.Tensor):
        """The policy and value heads, in float32, on the hidden state(s)."""
        y = h.float()
        if isinstance(self.action_space, Discrete):
            pi = {"kind": "categorical", "logits": self.pi_head(y)}
        else:
            pi = {"kind": "gaussian", "mean": self.pi_head(y),
                  "log_std": self.log_std}
        return pi, self.v_head(y).squeeze(-1)

    def step(self, h: torch.Tensor, obs: torch.Tensor, reset: torch.Tensor,
             weights: Sequence[torch.Tensor]):
        """:meth:`forward` with the gate weights of :meth:`gate_weights`."""
        w_i, b_i, w_h, b_h = weights
        h = self.cell(h, self.inputs(obs, w_i, b_i), reset, w_h, b_h)
        return (h, *self.heads(h))

    def forward(self, h: torch.Tensor, obs: torch.Tensor, reset: torch.Tensor):
        return self.step(h, obs, reset, self.gate_weights())

    def initial_state(self, batch: int) -> torch.Tensor:
        """Zeros ``[batch, hidden]`` in ``compute_dtype``, on the model's
        device."""
        return torch.zeros(batch, self.hidden, dtype=self.compute_dtype,
                           device=self.v_head.weight.device)


def _rnn_names(keys) -> List[str]:
    names = ["embed.weight", "embed.bias"]
    for gate in GRU_GATES:
        names.append(f"gru.{gate}.weight")
        if gate in _GRU_BIASED:
            names.append(f"gru.{gate}.bias")
    names += ["pi_head.weight", "pi_head.bias", "v_head.weight", "v_head.bias"]
    if "log_std" in keys:
        names.append("log_std")
    return names


def rnn_params_from_flax(params_np: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Map the JAX package's flax ``RecurrentActorCritic`` params to a
    ``state_dict``, in :func:`rnn_parameter_list`'s order.

    Layers are matched by name: ``Dense_0`` the embed, ``GRUCell_0/{ir, iz,
    in, hr, hz, hn}`` the GRU, ``Dense_1`` the policy head, ``Dense_2`` the
    value head, and ``log_std`` (flax's dict sorts ``GRUCell_0`` after
    ``Dense_2``).  Kernels ``[in, out]`` become weights ``[out, in]``.
    Accepts the params with or without the top-level ``"params"`` key, as
    numpy arrays.
    """
    p = params_np.get("params", params_np)
    layers = {"embed": p["Dense_0"], "pi_head": p["Dense_1"],
              "v_head": p["Dense_2"]}
    layers.update({f"gru.{g}": p["GRUCell_0"][g] for g in GRU_GATES})
    flat: Dict[str, torch.Tensor] = {}
    for name, leaf in layers.items():
        flat[f"{name}.weight"] = torch.from_numpy(
            np.asarray(leaf["kernel"], np.float32).T.copy())
        if "bias" in leaf:
            flat[f"{name}.bias"] = torch.from_numpy(
                np.asarray(leaf["bias"], np.float32).copy())
    if "log_std" in p:
        flat["log_std"] = torch.from_numpy(np.asarray(p["log_std"], np.float32).copy())
    return {name: flat[name] for name in _rnn_names(flat)}


def rnn_parameter_list(model: RecurrentActorCritic) -> List[nn.Parameter]:
    """The model's parameters in :func:`rnn_params_from_flax`'s order: the
    embed, the GRU's gates ``ir, iz, in, hr, hz, hn`` (weight, then bias
    where there is one), the policy head, the value head, ``log_std``."""
    named = dict(model.named_parameters())
    return [named[n] for n in _rnn_names(named)]


def rnn_adam_state_from_optax(opt_state_np) -> AdamState:
    """:func:`~.networks.adam_state_from_optax` for the recurrent tree: the
    moments laid out as :func:`rnn_params_from_flax` lays out the params."""
    return adam_state_from_optax(opt_state_np, rnn_params_from_flax)


@dataclasses.dataclass
class RNNTrainState:
    """:class:`~.ppo.TrainState` with the hidden state ``[B, hidden]``
    entering the next step and the flags ``[B]`` of envs whose last step
    ended an episode."""

    model: RecurrentActorCritic
    params: torch.Tensor
    opt_state: AdamState
    env_obs: torch.Tensor
    env_state: Any
    hidden: torch.Tensor
    prev_reset: torch.Tensor
    generator: torch.Generator
    update_idx: int = 0


class Seq(NamedTuple):
    """A rollout's sequences, ``[T, B, ...]``, and the hidden state ``h0``
    ``[B, hidden]`` that entered it."""

    obs: torch.Tensor
    action: torch.Tensor
    logp: torch.Tensor
    value: torch.Tensor
    reset: torch.Tensor  # episode boundary entering each step
    advantage: torch.Tensor
    target: torch.Tensor
    h0: torch.Tensor


class RNNRollout(NamedTuple):
    """A recurrent rollout's per-step records, ``[T, B, ...]``."""

    obs: torch.Tensor
    action: torch.Tensor
    logp: torch.Tensor
    value: torch.Tensor
    v_term: torch.Tensor  # value of the pre-reset successor
    reset: torch.Tensor
    done: torch.Tensor
    reward: torch.Tensor
    cont: torch.Tensor  # 1 - (done | truncated)


def _check(config: PPOConfig, num_devices: int = 1) -> int:
    """Checks ``config`` for ``num_devices`` ranks; returns the envs of one."""
    b_local = _local_envs(config, num_devices)
    if b_local % config.minibatches:
        raise ValueError("num_envs (per device) must be a multiple of "
                         "minibatches")
    return b_local


def init_rnn_state(env, config: PPOConfig, generator: torch.Generator,
                   hidden: int = 128,
                   num_devices: int = 1) -> Tuple[RecurrentActorCritic, RNNTrainState]:
    """Make the model (on the generator's device, its weights drawn from
    ``generator``), its zero Adam state, the first ``reset_vec`` of
    ``num_envs / num_devices`` envs, one device's share (drawn from
    ``generator`` too), a zero hidden state and no reset flags.

    The GRU's width is ``hidden``; ``config.hidden`` is not read, as in the
    JAX package.
    """
    b_local = _check(config, num_devices)
    device = generator.device
    model = RecurrentActorCritic(env.observation_space, env.action_space, hidden,
                                 config.compute_dtype, generator, device)
    params = flatten_parameters(model, rnn_parameter_list(model))
    obs0, state0 = env.reset_vec(generator, b_local)
    return model, RNNTrainState(
        model=model, params=params, opt_state=AdamState.zeros_like(params),
        env_obs=obs0, env_state=state0,
        hidden=model.initial_state(b_local),
        prev_reset=torch.zeros(b_local, dtype=torch.bool, device=device),
        generator=generator)


def shard_rnn_state(ts: RNNTrainState, mesh) -> RNNTrainState:
    """:func:`~gym_po_tpu_torch.agents.ppo.shard_train_state` for the
    recurrent state: the hidden state and the reset flags are sharded with
    the env fields."""
    return _shard_state(ts, mesh, ("env_obs", "env_state", "hidden", "prev_reset"))


@torch.no_grad()
def collect_rnn(env, model: RecurrentActorCritic, config: PPOConfig,
                obs: torch.Tensor, state, generator: torch.Generator,
                hidden: torch.Tensor, prev_reset: torch.Tensor):
    """The T-step recurrent rollout and GAE.

    Per step: the cell on ``(h, obs, prev_reset)``, the sampled action,
    ``env.step_vec``, and the value of the pre-reset successor under the
    post-step hidden state with no reset; ``done | truncated`` becomes the
    next step's reset flag.  Returns ``(seq, rollout, obs_T, state_T,
    hidden_T, reset_T)``.  Runs eagerly; the train step replays it as a
    CUDA graph on a CUDA device.
    """
    steps = []
    h0 = h = hidden
    weights = model.gate_weights()
    for _ in range(config.rollout_steps):
        h2, pi, value = model.step(h, obs, prev_reset, weights)
        action, logp = sample_action(pi, generator)
        nobs, nstate, rew, done, trunc, info = env.step_vec(generator, state, action)
        # bootstraps truncation through the time limit (_gae)
        _, _, v_term = model.step(h2, env.observe_vec(info["terminal_state"]),
                                  torch.zeros_like(done), weights)
        fin = done | trunc
        steps.append((obs, action, logp, value, v_term, prev_reset,
                      done.to(torch.float32), rew.to(torch.float32),
                      1.0 - fin.to(torch.float32)))
        obs, state, h, prev_reset = nobs, nstate, h2, fin
    ro = RNNRollout(*(torch.stack(column) for column in zip(*steps)))
    adv, target = _gae(ro.reward, ro.value, ro.v_term, ro.done, ro.cont,
                       config.gamma, config.gae_lambda)
    seq = Seq(ro.obs, ro.action, ro.logp, ro.value, ro.reset, adv, target, h0)
    return seq, ro, obs, state, h, prev_reset


def _replay(model: RecurrentActorCritic, seq: Seq):
    """Re-run the cell over the ``[T, B]`` sequences from ``seq.h0`` with
    the stored resets; returns ``(pi, value)`` over ``[T, B]``.

    What does not depend on the hidden state runs once over all T·B rows:
    the embedding and the input projections before the loop, the heads
    after it; the loop runs :meth:`RecurrentActorCritic.cell` alone.
    """
    T, B = seq.reset.shape
    w_i, b_i, w_h, b_h = model.gate_weights()
    xi = model.inputs(seq.obs.reshape(T * B, *seq.obs.shape[2:]), w_i, b_i)
    # unbind and split, not indexing: their backward is one stack or cat,
    # where each index's would write a zero tensor of the whole input
    h, hs = seq.h0, []
    for xi_t, reset_t in zip(xi.view(T, B, -1).unbind(0), seq.reset.unbind(0)):
        h = model.cell(h, xi_t, reset_t, w_h, b_h)
        hs.append(h)
    return model.heads(torch.stack(hs))


def _rnn_loss(model: RecurrentActorCritic, seq: Seq, config: PPOConfig):
    """PPO's loss over a replayed ``[T, B]`` block (the advantage normalised
    over all of it, population std)."""
    pi, value = _replay(model, seq)
    return ppo_loss(pi, value, seq, config)


def env_orders(config: PPOConfig, n: int,
               generator: torch.Generator) -> List[torch.Tensor]:
    """Each epoch's permutation of the ``n`` envs (``config.shuffle`` is not
    read, as in the JAX package)."""
    return [torch.randperm(n, generator=generator, device=generator.device)
            for _ in range(config.epochs)]


def _pick_envs(seq: Seq, index) -> Seq:
    return Seq(*(x[:, index] for x in seq[:-1]), seq.h0[index])


def learn_rnn(model: RecurrentActorCritic, params: torch.Tensor,
              opt_state: AdamState, config: PPOConfig, seq: Seq,
              orders: Sequence[torch.Tensor], mesh=None) -> Dict[str, torch.Tensor]:
    """E epochs (one per env permutation in ``orders``) of M minibatch steps
    over contiguous env slices, each a BPTT replay, a clip and an Adam
    step, in place on ``params`` and ``opt_state``; with a ``mesh``, each
    step's gradient averaged over its ranks.

    Returns the mean over all minibatch steps of ``loss``, ``pg_loss``,
    ``v_loss`` and ``entropy``, as 0-d tensors.
    """
    mb = seq.h0.shape[0] // config.minibatches
    plist = rnn_parameter_list(model)
    aux: Dict[str, List[torch.Tensor]] = {}
    for order in orders:
        shuffled = _pick_envs(seq, order)
        for m in range(config.minibatches):
            part = _pick_envs(shuffled, slice(m * mb, (m + 1) * mb))
            minibatch_step(*_rnn_loss(model, part, config), plist, params,
                           opt_state, config, aux, mesh)
    return {k: torch.stack(v).mean() for k, v in aux.items()}


def make_rnn_train_step(env, model: RecurrentActorCritic, config: PPOConfig,
                        mesh=None):
    """One recurrent PPO update ``step(ts) -> (ts, metrics)`` of ``model``.

    ``ts`` comes from :func:`init_rnn_state` for this model.  The update
    changes the model's parameters and ``ts.opt_state`` in place; the
    returned state holds the new env observations and state, hidden state,
    reset flags and the incremented ``update_idx``.  On a CUDA device the
    collect half is a CUDA graph, captured at the first call
    (``step.graph``), and the step records the same three CUDA events as
    PPO's (``step.events``; :func:`~.ppo.halves_ms` reads them).

    With a ``mesh`` each rank steps its own ``ts`` (:func:`shard_rnn_state`),
    as :func:`~gym_po_tpu_torch.agents.ppo.make_train_step` does.
    """
    _check(config, 1 if mesh is None else mesh.size)

    def step(ts: RNNTrainState):
        inputs = (ts.env_obs, ts.env_state, ts.generator, ts.hidden,
                  ts.prev_reset)
        if ts.env_obs.is_cuda:
            if step.graph is None:
                step.graph = CollectGraph(env, model, config, *inputs,
                                          collect_fn=collect_rnn)
            step.events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            step.events[0].record()
            seq, ro, obs_f, state_f, h_f, reset_f = step.graph(*inputs)
            obs_f, state_f = obs_f.clone(), _clone_state(state_f)
            h_f, reset_f = h_f.clone(), reset_f.clone()
            step.events[1].record()
        else:
            seq, ro, obs_f, state_f, h_f, reset_f = collect_rnn(env, model,
                                                                config, *inputs)
        orders = env_orders(config, seq.h0.shape[0], ts.generator)
        metrics = learn_rnn(model, ts.params, ts.opt_state, config, seq, orders,
                            mesh)
        metrics = mean_metrics({**metrics, **_reward_metrics(ro.reward)}, mesh)
        if step.events is not None:
            step.events[2].record()
        return dataclasses.replace(ts, env_obs=obs_f, env_state=state_f,
                                   hidden=h_f, prev_reset=reset_f,
                                   update_idx=ts.update_idx + 1), metrics

    step.graph = None
    step.events = None
    return step
