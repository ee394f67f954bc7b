"""PPO on one device, PyTorch port of :mod:`gym_po_tpu.agents.ppo`.

One update is the JAX package's: a T-step rollout of B envs with the
current policy, generalised advantage estimation over it, then E epochs of
M minibatches of clipped-PPO steps, each a global-norm clip and an Adam
step (eps 1e-5) written in optax's arithmetic order.  It runs in two halves
that the tests hold apart:

* **collect** (:func:`collect`): per step the policy forward, the sampled
  action, ``env.step_vec`` and the value of the pre-reset successor
  (``info["terminal_state"]``), then GAE and the time-major flattening
  (row = t·B + b).  On a CUDA device the train step captures it once as a
  CUDA graph and replays it every update: the rollout issues dozens of
  small launches per env step, and a replay issues them all at once.  On
  the CPU it runs eagerly.
* **learn** (:func:`learn`): E epochs over the row orders of
  :func:`row_orders` ('permute', 'roll' or 'none'), each cut into M
  contiguous minibatches.

The learn half updates the parameters and Adam's moments in place, over
one flat buffer that the model's parameters are views of
(:func:`~gym_po_tpu_torch.agents.networks.flatten_parameters`): the graph
reads the weights from that fixed storage.  Every draw (the network's
init, the first reset, actions, env steps, row orders) comes from the
train state's ``torch.Generator``.

Data parallel over a ``mesh`` (:mod:`gym_po_tpu_torch.parallel`), as the
JAX package's Anakin update: each rank holds its rows of the envs
(:func:`shard_train_state`) and replicated parameters; each minibatch
step averages the flat gradient over the ranks (one ``all_reduce``) before
the clip and the Adam step, and the update's metrics are averaged once at
its end.  The collect half holds no collective, so its CUDA graph is the
same.

Three entry points run updates:

* :func:`make_train_step`: one update, its collect a CUDA graph and its
  learn half eager, with CUDA events between the halves (:func:`halves_ms`).
* :func:`make_multi_train_step`: N updates, the JAX package's one-dispatch
  ``lax.scan``.  On a CUDA device a whole update (collect, row orders,
  learn, metrics) is one CUDA graph (:class:`UpdateGraph`), and N updates
  are N replays that the host enqueues back to back with no sync between
  them; over a gloo mesh and on the CPU the updates run eagerly.
  :func:`train` runs through it.
* :func:`make_chunked_train_step`: the collect as chunks of
  ``dispatch_batch`` envs, then one learn over their batches
  (:mod:`~gym_po_tpu_torch.vector.chunked`).  On the H100 it bounds the
  collect's working set and is no speed remedy: there is no batch cliff.
"""

from __future__ import annotations

import dataclasses
import gc
import math
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..core import map_tensors
from ..ops._build import count_replay, take_captured
from ..utils.numerics import sqrt_rn
from ..utils.profiling import annotate
from ..vector.chunked import _concat_chunks, _split_chunks
from .networks import (
    ActorCritic,
    AdamState,
    check_compute_dtype,
    entropy,
    flatten_parameters,
    log_prob,
    make_actor_critic,
    parameter_list,
    sample_action,
)

__all__ = ["PPOConfig", "TrainState", "init_train_state", "make_train_step",
           "make_multi_train_step", "make_chunked_train_step",
           "shard_train_state", "train", "collect", "batch_from_rollout",
           "row_orders", "learn", "adam_step", "minibatch_step", "mean_metrics",
           "ppo_loss", "eager_update", "halves_ms", "Batch", "Rollout",
           "CollectGraph", "UpdateGraph", "METRIC_NAMES"]

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-5  # optax.adam's, eps as PPO's
#: an update's metrics: :func:`learn`'s, then the collect's rewards'
METRIC_NAMES = ("pg_loss", "v_loss", "entropy", "loss", "mean_reward",
                "pos_reward_rate", "neg_reward_rate")


class PPOConfig(NamedTuple):
    """Hyperparameters (PPO defaults per Schulman et al. 2017)."""

    num_envs: int = 4096
    rollout_steps: int = 128
    epochs: int = 4
    minibatches: int = 4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    entropy_coef: float = 0.01
    value_coef: float = 0.5
    max_grad_norm: float = 0.5
    learning_rate: float = 2.5e-4
    hidden: Tuple[int, ...] = (64, 64)
    #: the torso's dtype, float32 or bfloat16 (the heads compute in float32)
    compute_dtype: Any = torch.float32
    #: epoch row order: 'permute' = a fresh permutation, 'roll' = a random
    #: circular shift, 'none' = the rows in order
    shuffle: str = "permute"


@dataclasses.dataclass
class TrainState:
    """The model, its parameters as one flat buffer (the model's parameters
    are views of it), Adam's state, the envs' observations and state, the
    generator every draw comes from, and the count of updates made."""

    model: ActorCritic
    params: torch.Tensor
    opt_state: AdamState
    env_obs: torch.Tensor
    env_state: Any
    generator: torch.Generator
    update_idx: int = 0


class Batch(NamedTuple):
    """Flat time-major rollout rows (row = t·B + b)."""

    obs: torch.Tensor
    action: torch.Tensor
    logp: torch.Tensor
    value: torch.Tensor
    advantage: torch.Tensor
    target: torch.Tensor


class Rollout(NamedTuple):
    """A rollout's per-step records, ``[T, B, ...]``."""

    obs: torch.Tensor
    action: torch.Tensor
    logp: torch.Tensor
    value: torch.Tensor
    v_term: torch.Tensor  # value of the pre-reset successor
    done: torch.Tensor
    reward: torch.Tensor
    cont: torch.Tensor  # 1 - (done | truncated)


def _local_envs(config: PPOConfig, num_devices: int) -> int:
    """The envs of one of ``num_devices`` ranks (``num_envs`` is global)."""
    check_compute_dtype(config.compute_dtype)
    if config.num_envs % num_devices:
        raise ValueError(f"num_envs={config.num_envs} not divisible by "
                         f"{num_devices} devices")
    return config.num_envs // num_devices


def _check(config: PPOConfig, num_devices: int = 1) -> int:
    """Checks ``config`` for ``num_devices`` ranks; returns the envs of one."""
    if config.shuffle not in ("permute", "roll", "none"):
        raise ValueError(f"unknown shuffle {config.shuffle!r}")
    b_local = _local_envs(config, num_devices)
    if (b_local * config.rollout_steps) % config.minibatches:
        raise ValueError("num_envs * rollout_steps (per device) must be a "
                         "multiple of minibatches")
    return b_local


def _gae(rewards, values, next_values, dones, continues, gamma, lam):
    """Generalized advantage estimation over the time axis of ``[T, B]``.

    ``next_values[t]`` is the value of the pre-reset successor of step
    ``t``, so truncation bootstraps through the reset while termination
    (``dones``) zeroes the bootstrap; ``continues`` only stops the
    λ-recursion at episode boundaries.  Returns ``(advantages, targets)``.
    """
    gae = torch.zeros_like(values[-1])
    out = []
    for t in reversed(range(values.shape[0])):
        delta = rewards[t] + gamma * next_values[t] * (1.0 - dones[t]) - values[t]
        gae = delta + gamma * lam * continues[t] * gae
        out.append(gae)
    adv = torch.stack(out[::-1])
    return adv, adv + values


def init_train_state(env, config: PPOConfig, generator: torch.Generator,
                     num_devices: int = 1) -> Tuple[ActorCritic, TrainState]:
    """Make the model (on the generator's device, its weights drawn from
    ``generator``), its zero Adam state and the first ``reset_vec`` of
    ``num_envs / num_devices`` envs, one device's share (drawn from
    ``generator`` too)."""
    b_local = _check(config, num_devices)
    device = generator.device
    model = make_actor_critic(env, config.hidden, generator, device,
                              config.compute_dtype)
    params = flatten_parameters(model)
    obs0, state0 = env.reset_vec(generator, b_local)
    return model, TrainState(model=model, params=params,
                             opt_state=AdamState.zeros_like(params),
                             env_obs=obs0, env_state=state0,
                             generator=generator)


@torch.no_grad()
def adam_step(params: torch.Tensor, state: AdamState, grads: torch.Tensor,
              config: PPOConfig) -> None:
    """``optax.chain(clip_by_global_norm(max_grad_norm), adam(lr, eps=1e-5))``
    on flat tensors, in place, in optax's order.

    The clip keeps the gradients where their norm is below the limit and
    else gives ``(g / norm) * max_norm`` (a select, no epsilon).  Adam
    updates the moments, increments the count, divides by the bias
    corrections and steps by ``-lr * m̂ / (sqrt(v̂) + eps)``.  Every
    division is by a tensor, every square root correctly rounded.
    """
    g_norm = sqrt_rn(torch.sum(grads * grads))
    g = torch.where(g_norm < config.max_grad_norm, grads,
                    (grads / g_norm) * config.max_grad_norm)
    state.mu.mul_(ADAM_B1).add_(g * (1 - ADAM_B1))
    state.nu.mul_(ADAM_B2).add_(g * g * (1 - ADAM_B2))
    state.count.add_(1)
    mu_hat = state.mu / (1 - torch.pow(ADAM_B1, state.count))
    nu_hat = state.nu / (1 - torch.pow(ADAM_B2, state.count))
    params.add_(mu_hat / (sqrt_rn(nu_hat) + ADAM_EPS) * -config.learning_rate)


def _loss_fn(model: ActorCritic, batch: Batch, config: PPOConfig):
    pi, value = model(batch.obs)
    return ppo_loss(pi, value, batch, config)


def ppo_loss(pi, value: torch.Tensor, batch, config: PPOConfig):
    """The clipped surrogate, the clipped value loss and the entropy bonus
    of the policy ``pi`` and ``value`` on ``batch`` (its ``action``,
    ``logp``, ``value``, ``advantage`` and ``target``, of any shape), the
    advantage normalised over all of it.  Returns ``(loss, terms)``."""
    logp = log_prob(pi, batch.action)
    ratio = torch.exp(logp - batch.logp)
    adv = (batch.advantage - batch.advantage.mean()) / (
        batch.advantage.std(correction=0) + 1e-8  # jnp.std: population std
    )
    pg = -torch.minimum(
        ratio * adv,
        torch.clamp(ratio, 1 - config.clip_eps, 1 + config.clip_eps) * adv,
    ).mean()
    v_clipped = batch.value + torch.clamp(
        value - batch.value, -config.clip_eps, config.clip_eps
    )
    v_loss = 0.5 * torch.maximum(
        (value - batch.target) ** 2, (v_clipped - batch.target) ** 2
    ).mean()
    ent = entropy(pi).mean()
    loss = pg + config.value_coef * v_loss - config.entropy_coef * ent
    return loss, {"pg_loss": pg, "v_loss": v_loss, "entropy": ent}


@torch.no_grad()
def collect(env, model: ActorCritic, config: PPOConfig, obs: torch.Tensor,
            state, generator: torch.Generator):
    """The T-step rollout, GAE and the time-major flattening.

    Returns ``(batch, rollout, obs_T, state_T)``.  Runs eagerly; the train
    step replays it as a CUDA graph on a CUDA device.
    """
    device = obs.device
    with annotate("ppo.collect", device):
        steps = []
        for _ in range(config.rollout_steps):
            pi, value = model(obs)
            action, logp = sample_action(pi, generator)
            with annotate("env.step", device):
                nobs, nstate, rew, done, trunc, info = env.step_vec(generator, state,
                                                                    action)
            # value of the pre-reset successor: bootstraps truncation (_gae)
            _, v_term = model(env.observe_vec(info["terminal_state"]))
            fin = (done | trunc).to(torch.float32)
            steps.append((obs, action, logp, value, v_term, done.to(torch.float32),
                          rew.to(torch.float32), 1.0 - fin))
            obs, state = nobs, nstate
        ro = Rollout(*(torch.stack(column) for column in zip(*steps)))
        return batch_from_rollout(ro, config), ro, obs, state


def batch_from_rollout(ro: Rollout, config: PPOConfig) -> Batch:
    """GAE over a rollout, then its rows flattened time-major."""
    adv, target = _gae(ro.reward, ro.value, ro.v_term, ro.done, ro.cont,
                       config.gamma, config.gae_lambda)

    def flat(x):
        return x.reshape(-1, *x.shape[2:])

    return Batch(flat(ro.obs), flat(ro.action), flat(ro.logp), flat(ro.value),
                 flat(adv), flat(target))


def row_orders(config: PPOConfig, n: int,
               generator: torch.Generator) -> List[Optional[torch.Tensor]]:
    """Each epoch's order of the ``n`` batch rows: a permutation
    ('permute'), the rows rolled by one shift drawn in ``[0, n)`` as
    ``torch.roll`` / ``jnp.roll`` roll them ('roll'), or ``None``, the rows
    in order ('none')."""
    device = generator.device
    if config.shuffle == "permute":
        return [torch.randperm(n, generator=generator, device=device)
                for _ in range(config.epochs)]
    if config.shuffle == "roll":
        rows = torch.arange(n, device=device)
        return [torch.remainder(rows - torch.randint(0, n, (), generator=generator,
                                                     device=device), n)
                for _ in range(config.epochs)]
    return [None] * config.epochs


def learn(model: ActorCritic, params: torch.Tensor, opt_state: AdamState,
          config: PPOConfig, batch: Batch,
          orders: Sequence[Optional[torch.Tensor]],
          mesh=None) -> Dict[str, torch.Tensor]:
    """E epochs (one per entry of ``orders``) of M minibatch steps, in place
    on ``params`` (the model's flat buffer) and ``opt_state``; with a
    ``mesh``, each step's gradient averaged over its ranks.

    Returns the mean over all minibatch steps of ``loss``, ``pg_loss``,
    ``v_loss`` and ``entropy`` (the rank's own), as 0-d tensors.
    """
    n = batch.obs.shape[0]
    mb = n // config.minibatches
    plist = parameter_list(model)
    aux: Dict[str, List[torch.Tensor]] = {}
    for order in orders:
        rows = batch if order is None else Batch(*(x[order] for x in batch))
        for m in range(config.minibatches):
            part = Batch(*(x[m * mb:(m + 1) * mb] for x in rows))
            minibatch_step(*_loss_fn(model, part, config), plist, params,
                           opt_state, config, aux, mesh)
    return {k: torch.stack(v).mean() for k, v in aux.items()}


def minibatch_step(loss: torch.Tensor, terms: Dict[str, torch.Tensor],
                   plist: Sequence[torch.Tensor], params: torch.Tensor,
                   opt_state: AdamState, config: PPOConfig,
                   aux: Dict[str, List[torch.Tensor]], mesh=None) -> None:
    """One clip-and-Adam step on the gradients of ``loss`` with respect to
    ``plist`` (the views of ``params``, in its order); ``loss`` and its
    ``terms`` are appended to ``aux``.  With a ``mesh`` the flat gradient
    is averaged over its ranks first (JAX's ``pmean(grads)`` before
    ``tx.update``, which clips)."""
    grads = torch.autograd.grad(loss, plist)
    flat = torch.cat([g.reshape(-1) for g in grads])
    if mesh is not None:
        mesh.all_mean_(flat)
    adam_step(params, opt_state, flat, config)
    for k, v in {**terms, "loss": loss}.items():
        aux.setdefault(k, []).append(v.detach())


def mean_metrics(metrics: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """The metrics averaged over the mesh's ranks, as one stacked
    ``all_reduce`` (JAX's ``pmean`` of the metrics); as they are without a
    mesh."""
    if mesh is None:
        return metrics
    vals = mesh.all_mean_(torch.stack(list(metrics.values())))
    return dict(zip(metrics, vals.unbind()))


def _reward_metrics(reward: torch.Tensor) -> Dict[str, torch.Tensor]:
    # terminal-event rates for sparse ±1 tasks; the 0.5 threshold ignores
    # potential-shaping increments (envs/shaping.py)
    return {"mean_reward": reward.mean(),
            "pos_reward_rate": (reward > 0.5).to(torch.float32).mean(),
            "neg_reward_rate": (reward < -0.5).to(torch.float32).mean()}


def _learn_half(model: ActorCritic, config: PPOConfig, ts: TrainState,
                batch: Batch, ro: Rollout, mesh) -> Dict[str, torch.Tensor]:
    """The row orders (drawn after the collect's draws), :func:`learn` and
    the update's metrics, averaged over the mesh's ranks."""
    with annotate("ppo.learn", ts.params.device):
        orders = row_orders(config, batch.obs.shape[0], ts.generator)
        metrics = learn(model, ts.params, ts.opt_state, config, batch, orders, mesh)
        return mean_metrics({**metrics, **_reward_metrics(ro.reward)}, mesh)


def eager_update(env, model: ActorCritic, config: PPOConfig, ts: TrainState,
                 mesh=None):
    """One PPO update run eagerly, ``(ts, metrics)``: what
    :class:`UpdateGraph` replays and :func:`make_train_step` runs with its
    collect graphed."""
    batch, ro, obs_f, state_f = collect(env, model, config, ts.env_obs,
                                        ts.env_state, ts.generator)
    metrics = _learn_half(model, config, ts, batch, ro, mesh)
    return dataclasses.replace(ts, env_obs=obs_f, env_state=state_f,
                               update_idx=ts.update_idx + 1), metrics


def _clone_state(state):
    return dataclasses.replace(state, **{
        f.name: getattr(state, f.name).clone() for f in dataclasses.fields(state)})


def _copy_into(dst, src) -> None:
    """Copy a tensor, or each field of a dataclass of tensors, in place."""
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
        return
    for f in dataclasses.fields(dst):
        getattr(dst, f.name).copy_(getattr(src, f.name))


def _capture(fn, generator: torch.Generator, restore: Sequence[torch.Tensor] = ()):
    """``fn`` captured as a CUDA graph that draws from ``generator``:
    returns ``(graph, fn's outputs, launches)``.

    One eager warm-up on a side stream comes first; then ``generator`` and
    the tensors of ``restore`` (what the warm-up changes in place) are put
    back to their state from before it, so the first replay draws and reads
    what an eager call from that state would.  Kernel launches count where
    they run: the warm-up's at once, the capture's at each replay
    (:func:`~gym_po_tpu_torch.ops._build.take_captured`).
    """
    gen_state = generator.get_state()
    saved = [t.clone() for t in restore]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    for t, v in zip(restore, saved):
        t.copy_(v)
    generator.set_state(gen_state)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(generator)
    # an unreachable graph that the collector freed during the capture
    # would invalidate it: collect first, and not during it
    gc.collect()
    gc_on = gc.isenabled()
    gc.disable()
    take_captured()
    try:
        with torch.cuda.graph(graph):
            out = fn()
    finally:
        if gc_on:
            gc.enable()
    launches = take_captured()
    generator.set_state(gen_state)
    return graph, out, launches


class CollectGraph:
    """A collect captured as one CUDA graph, replayed from fixed input
    buffers.

    ``collect_fn(env, model, config, obs, state, generator, *carry)`` is
    :func:`collect` by default; ``carry`` are further tensors it reads (the
    recurrent collect's hidden state and reset flags), held in input
    buffers as ``obs`` and ``state`` are.  The capture is preceded by one
    eager warm-up (:func:`_capture`), so the first replay draws what an
    eager call from the generator's state would.  The generator is
    registered with the graph: each replay draws fresh numbers from its
    current state and advances it, as an eager call does.  The graph reads
    the model's weights where they lie, so they must be updated in place.
    ``launches`` are the kernel launches of one replay.
    """

    def __init__(self, env, model, config, obs: torch.Tensor, state,
                 generator: torch.Generator, *carry: torch.Tensor,
                 collect_fn=collect):
        self.generator = generator
        self.inputs = [obs.clone(), _clone_state(state),
                       *(c.clone() for c in carry)]
        obs_in, state_in, *carry_in = self.inputs
        self.graph, self.out, self.launches = _capture(
            lambda: collect_fn(env, model, config, obs_in, state_in, generator,
                               *carry_in), generator)

    def __call__(self, obs: torch.Tensor, state, generator: torch.Generator,
                 *carry: torch.Tensor):
        """Replay from ``obs``, ``state`` and ``carry``.  The outputs live in
        the graph's memory until the next replay."""
        if generator is not self.generator:
            raise ValueError("the graph draws from the generator it was "
                             "captured with")
        if len(carry) != len(self.inputs) - 2:
            raise ValueError(f"the graph takes {len(self.inputs) - 2} carry "
                             f"tensors, not {len(carry)}")
        for dst, src in zip(self.inputs, (obs, state, *carry)):
            _copy_into(dst, src)
        self.graph.replay()
        count_replay(self.launches)
        return self.out


class UpdateGraph:
    """One whole PPO update captured as one CUDA graph: :func:`collect`,
    :func:`row_orders`, :func:`learn`, the update's metrics stacked into one
    tensor (``metrics``, in :data:`METRIC_NAMES`' order), and last the final
    observations and env state copied into the graph's own input buffers
    (``obs``, ``state``), from which the next replay goes on with no copy
    by the host.

    The graph updates ``ts``'s parameters (the model's flat buffer) and
    Adam state where they lie, and draws from ``ts``'s generator, which is
    registered with it: a replay draws what :func:`eager_update` draws from
    the generator's state, in the same order (the collect's draws, then the
    row orders), and advances it as much.  The warm-up before the capture
    runs a whole update, so the parameters, Adam's state, the input buffers
    and the generator are put back to their state from before it
    (:func:`_capture`).  With a ``mesh`` the learn half's all-reduces are
    in the graph.  ``launches`` are the kernel launches of one replay.
    """

    def __init__(self, env, model: ActorCritic, config: PPOConfig,
                 ts: TrainState, mesh=None):
        self.generator = ts.generator
        self.params, self.opt_state = ts.params, ts.opt_state
        self.obs, self.state = ts.env_obs.clone(), _clone_state(ts.env_state)

        def run():
            batch, ro, obs_f, state_f = collect(env, model, config, self.obs,
                                                self.state, self.generator)
            metrics = _learn_half(model, config, ts, batch, ro, mesh)
            row = torch.stack([metrics[k] for k in METRIC_NAMES])
            _copy_into(self.obs, obs_f)
            _copy_into(self.state, state_f)
            return row

        opt = self.opt_state
        self.graph, self.metrics, self.launches = _capture(
            run, self.generator, (self.params, opt.count, opt.mu, opt.nu,
                                  self.obs, *(getattr(self.state, f.name) for f
                                              in dataclasses.fields(self.state))))

    def load(self, ts: TrainState) -> None:
        """Put ``ts``'s observations and env state into the input buffers;
        ``ts`` must hold the parameters, Adam state and generator the graph
        was captured with."""
        if (ts.generator is not self.generator or ts.params is not self.params
                or ts.opt_state is not self.opt_state):
            raise ValueError("the graph updates the parameters, Adam state "
                             "and generator it was captured with")
        _copy_into(self.obs, ts.env_obs)
        _copy_into(self.state, ts.env_state)

    def replay(self) -> None:
        """One update from the input buffers, left in them; its metrics in
        ``metrics`` until the next replay."""
        with annotate("ppo.replay"):
            self.graph.replay()
        count_replay(self.launches)


def make_train_step(env, model: ActorCritic, config: PPOConfig, mesh=None):
    """One PPO update ``step(ts) -> (ts, metrics)`` of ``model``.

    ``ts`` comes from :func:`init_train_state` for this model.  The update
    changes the model's parameters and ``ts.opt_state`` in place; the
    returned state holds the new env observations and state and the
    incremented ``update_idx``.  On a CUDA device the collect half is a
    CUDA graph, captured at the first call (``step.graph``), and the step
    records CUDA events before the collect, between the halves and after
    the learn (``step.events``; :func:`halves_ms` reads them).

    With a ``mesh`` (:func:`~gym_po_tpu_torch.parallel.make_mesh`) each rank
    steps its own ``ts`` (:func:`shard_train_state`): ``num_envs`` is the
    global batch, each minibatch step averages the gradient over the ranks
    and the metrics are averaged at the end, so every rank holds the same
    parameters and metrics.
    """
    _check(config, 1 if mesh is None else mesh.size)

    def step(ts: TrainState):
        if not ts.env_obs.is_cuda:
            return eager_update(env, model, config, ts, mesh)
        if step.graph is None:
            step.graph = CollectGraph(env, model, config, ts.env_obs,
                                      ts.env_state, ts.generator)
        step.events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        step.events[0].record()
        batch, ro, obs_f, state_f = step.graph(ts.env_obs, ts.env_state,
                                               ts.generator)
        obs_f, state_f = obs_f.clone(), _clone_state(state_f)
        step.events[1].record()
        metrics = _learn_half(model, config, ts, batch, ro, mesh)
        step.events[2].record()
        return dataclasses.replace(ts, env_obs=obs_f, env_state=state_f,
                                   update_idx=ts.update_idx + 1), metrics

    step.graph = None
    step.events = None
    return step


def _graphed(device: torch.device, mesh) -> bool:
    """Whether an update on ``device`` over ``mesh`` runs as one CUDA graph:
    on a CUDA device with no mesh, a one-rank mesh with no group, or an
    NCCL group.  A gloo group all-reduces through the host, so its updates
    run eagerly, as the CPU's do."""
    if device.type != "cuda":
        return False
    return mesh is None or mesh.group is None or \
        dist.get_backend(mesh.group) == "nccl"


def make_multi_train_step(env, model: ActorCritic, config: PPOConfig,
                          num_updates: int, mesh=None, bounded: bool = False):
    """``num_updates`` PPO updates, the JAX package's one-dispatch scan:
    ``multi(ts) -> (ts, metrics)``, each metric a ``[num_updates]`` tensor
    on the device, ``update_idx`` advanced by ``num_updates``.

    On a CUDA device (with no mesh or an NCCL one) every update is a replay
    of one :class:`UpdateGraph`, captured at the first call
    (``multi.graph``): the host enqueues the replays back to back, each
    followed by one device copy of its metrics into their row, and syncs
    with none.  Otherwise (the CPU, a gloo mesh) the updates run eagerly
    (:func:`eager_update`).  Either way the result equals ``num_updates``
    calls of :func:`make_train_step`'s step.  Parameters and Adam state
    change in place, as there.

    ``bounded=True`` gives ``multi(ts, limit)`` with a host ``int``, the
    total update count to stop at: it runs ``min(num_updates, limit -
    ts.update_idx)`` updates (none if that is not positive), so the state
    is the plain form's at the limit, and fills the metric rows past it
    with NaN.
    """
    _check(config, 1 if mesh is None else mesh.size)
    num_updates = int(num_updates)
    if num_updates < 1:
        raise ValueError(f"num_updates={num_updates} must be positive")

    def run(ts: TrainState, n: int):
        rows = torch.full((num_updates, len(METRIC_NAMES)), math.nan,
                          device=ts.params.device)
        if n > 0 and _graphed(ts.params.device, mesh):
            if multi.graph is None:
                multi.graph = UpdateGraph(env, model, config, ts, mesh)
            graph = multi.graph
            graph.load(ts)
            for i in range(n):
                graph.replay()
                rows[i].copy_(graph.metrics)
            ts = dataclasses.replace(ts, env_obs=graph.obs.clone(),
                                     env_state=_clone_state(graph.state),
                                     update_idx=ts.update_idx + n)
        else:
            for i in range(n):
                ts, m = eager_update(env, model, config, ts, mesh)
                rows[i].copy_(torch.stack([m[k] for k in METRIC_NAMES]))
        return ts, dict(zip(METRIC_NAMES, rows.t().contiguous().unbind()))

    if bounded:
        def multi(ts: TrainState, limit: int):
            return run(ts, max(0, min(num_updates, int(limit) - ts.update_idx)))
    else:
        def multi(ts: TrainState):
            return run(ts, num_updates)

    multi.graph = None
    return multi


def make_chunked_train_step(env, model: ActorCritic, config: PPOConfig,
                            dispatch_batch: int = 4096):
    """One PPO update ``step(ts) -> (ts, metrics)`` for ``num_envs`` above
    ``dispatch_batch``, as the JAX package's: the collect runs as
    ``num_envs / dispatch_batch`` chunks of ``dispatch_batch`` envs in
    turn, every chunk drawing from ``ts.generator`` in chunk order, then
    one :func:`learn` runs over the chunks' batches concatenated
    chunk-major (row ``c·T·B_c + t·B_c + b`` for env ``b`` of chunk ``c``,
    not the single collect's ``t·B + b``).  The reward metrics are the
    means over the chunks.  On a CUDA device every chunk is a replay of one
    :class:`CollectGraph` captured at ``dispatch_batch`` envs
    (``step.graph``) on that chunk's rows.

    At or below ``dispatch_batch`` it returns :func:`make_train_step`'s
    step; otherwise ``dispatch_batch`` must divide ``num_envs``.  On the
    H100 it bounds the collect's working set to a chunk and is no speed
    remedy (:mod:`~gym_po_tpu_torch.vector.chunked`).
    """
    if config.num_envs <= dispatch_batch:
        return make_train_step(env, model, config)
    if config.num_envs % dispatch_batch:
        raise ValueError(f"dispatch_batch={dispatch_batch} must divide "
                         f"num_envs={config.num_envs}")
    _check(config)
    n_chunks = config.num_envs // dispatch_batch
    chunk_config = config._replace(num_envs=dispatch_batch)

    def step(ts: TrainState):
        outs = []
        for obs, state in zip(_split_chunks(ts.env_obs, n_chunks),
                              _split_chunks(ts.env_state, n_chunks)):
            if ts.env_obs.is_cuda:
                if step.graph is None:
                    step.graph = CollectGraph(env, model, chunk_config, obs,
                                              state, ts.generator)
                batch, ro, obs_f, state_f = step.graph(obs, state, ts.generator)
            else:
                batch, ro, obs_f, state_f = collect(env, model, chunk_config,
                                                    obs, state, ts.generator)
            out = (batch, ro.reward, obs_f, state_f)
            # a replay's outputs live in the graph until the next one
            outs.append(map_tensors(torch.clone, out) if ts.env_obs.is_cuda else out)
        batch = _concat_chunks([o[0] for o in outs])
        orders = row_orders(config, batch.obs.shape[0], ts.generator)
        metrics = learn(model, ts.params, ts.opt_state, config, batch, orders)
        chunks = torch.full((), n_chunks, dtype=torch.float32,
                            device=ts.params.device)
        rewards = [_reward_metrics(o[1]) for o in outs]
        for k in rewards[0]:
            metrics[k] = sum(r[k] for r in rewards) / chunks
        return dataclasses.replace(
            ts, env_obs=_concat_chunks([o[2] for o in outs]),
            env_state=_concat_chunks([o[3] for o in outs]),
            update_idx=ts.update_idx + 1), metrics

    step.graph = None
    return step


def shard_train_state(ts: TrainState, mesh) -> TrainState:
    """Lay out a global train state over ``mesh`` as the JAX package's
    Anakin update does: this rank keeps its rows of the env observations
    and state and a generator of its own
    (:func:`~gym_po_tpu_torch.parallel.split_generator` of ``ts``'s, which
    it advances); the parameters and Adam's state are rank 0's on every
    rank (a broadcast, in place on the model's flat buffer).

    ``ts`` is the whole batch, the same on every rank (made from one seed
    by :func:`init_train_state` with ``num_devices=1``), on the mesh's
    device.
    """
    return _shard_state(ts, mesh, ("env_obs", "env_state"))


def _shard_state(ts, mesh, per_env: Sequence[str]):
    """``ts`` with the rank's rows of the ``per_env`` fields, its own
    generator and rank 0's parameters and Adam state."""
    from ..parallel import replicate, shard_batch, split_generator

    # "cuda" names the current card: compare indexed devices
    device = torch.empty(0, device=mesh.device).device
    if ts.params.device != device:
        # the broadcast is in place only on the mesh's device
        raise ValueError(f"the train state lies on {ts.params.device}, the "
                         f"mesh's device is {device}")
    replicate(mesh, (ts.params, ts.opt_state))
    gen = split_generator(ts.generator, mesh.size, mesh.device)[mesh.rank]
    return dataclasses.replace(ts, generator=gen, **{
        name: shard_batch(mesh, getattr(ts, name)) for name in per_env})


def halves_ms(step) -> Tuple[float, float]:
    """The last CUDA update's collect and learn times, in ms, from the
    events its train step recorded (waits for them)."""
    start, mid, end = step.events
    end.synchronize()
    return start.elapsed_time(mid), mid.elapsed_time(end)


def train(env, config: PPOConfig, seed: int = 0, num_updates: int = 100,
          mesh=None, log_every: int = 0):
    """Init from ``seed`` on the env's device, then ``num_updates`` updates,
    as the JAX package's ``train``: in chunks of ``log_every`` updates (the
    whole run when 0) through one :func:`make_multi_train_step`, bounded
    when the total is not a multiple of the chunk.

    With ``log_every`` the history holds the last update's metrics of each
    chunk (a ragged tail gives one row more), as floats; returns ``(model,
    ts, history)``.  With a ``mesh`` every rank makes the global state and
    keeps its share (:func:`shard_train_state`).
    """
    generator = torch.Generator(device=env.device).manual_seed(seed)
    model, ts = init_train_state(env, config, generator)
    if mesh is not None:
        ts = shard_train_state(ts, mesh)
    chunk = max(log_every or num_updates, 1)
    ragged = num_updates % chunk != 0
    multi = make_multi_train_step(env, model, config, chunk, mesh,
                                  bounded=ragged)
    history = []
    done = 0
    while done < num_updates:
        ts, metrics = multi(ts, num_updates) if ragged else multi(ts)
        n = min(chunk, num_updates - done)
        done += n
        if log_every:
            m = {k: float(v[n - 1]) for k, v in metrics.items()}
            history.append(m)
            print(f"update {done}: {m}")
    return model, ts, history
