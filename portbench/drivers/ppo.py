"""Traffic kind ``ppo``: PPO updates through the program's multi-update
step, one update a call (``make_multi_train_step(..., 1)``: on the card
one replay of the CUDA graph of a whole update), calls back to back with
no host read between them.

The window goes on training the object that set-up made: no update is
repeated and nothing is put back, so the window's updates are updates
``CHECKED + 2`` onwards of one training run, from the program's own
reset draws.

Set-up makes the env from the configuration and the train state from the
traffic's hyperparameters and the seed, puts the benchmark's own first
weights (``reference/ppo.py``'s ``init_leaves``, drawn on the device from
``WEIGHTS_SEED``) into the model, and drives the step through its first
``CHECKED + 1`` calls (the first captures the graph).  Those calls are
the window's own call on the same object; for the first ``CHECKED`` the
set-up keeps what the check needs: each env step's input state, action,
pre-reset and next state (the env's ``step_vec`` is wrapped to keep its
results, and the collect and row orders likewise: no device work is
added), the rollout's records, the epochs' row orders, the update's loss,
Adam's moments after the first update and the weights after the last.

The check, after the window, follows the program from those records (its
env draws, sampled actions and row orders are its own): each transition
held to the configuration's reference step, and the rollout's records to
the steps' outputs; the acting (log-probability of the sampled action,
value, value of the pre-reset state) held to the reference network with
the reference's own weights; each update's loss (its gap over the mean
magnitude of the checked updates' losses, since a PPO loss crosses zero),
Adam's first moments after the first update and each leaf's change over
the checked updates held to the reference's learn half from the same first
weights.  Leaves compare by the gap of their norms, over the reference
leaf's norm or the median leaf's, whichever is larger; a leaf whose
reference gradient is under a thousandth of the median leaf's is left out
of the change.
"""

from __future__ import annotations

import dataclasses
import importlib
import statistics

import torch

from portbench.reference import ppo as ref_ppo

CHECKED = 3
#: the first weights are the same for every seed, which draws the episodes
#: and the actions: how fast the policy concentrates the observations sets
#: the learn half's time, and it follows the first weights
WEIGHTS_SEED = 0x5EED
HP_KEYS = ("num_envs", "rollout_steps", "epochs", "minibatches", "gamma",
           "gae_lambda", "clip_eps", "entropy_coef", "value_coef",
           "max_grad_norm", "learning_rate", "shuffle")


class _Stash:
    """References to what the program's collect and learn half made
    during the capture; after each replay they hold that replay's
    values."""

    def __init__(self, ppo, env):
        self.collect_out = self.orders = None
        self.steps = []
        orig_collect, orig_orders, orig_step = ppo.collect, ppo.row_orders, env.step_vec

        def collect(*a, **k):
            self.steps = []
            self.collect_out = orig_collect(*a, **k)
            return self.collect_out

        def row_orders(*a, **k):
            self.orders = orig_orders(*a, **k)
            return self.orders

        def step_vec(generator, state, action):
            out = orig_step(generator, state, action)
            self.steps.append((state, action, out))
            return out

        ppo.collect, ppo.row_orders, env.step_vec = collect, row_orders, step_vec

        def restore():
            ppo.collect, ppo.row_orders = orig_collect, orig_orders
            del env.step_vec  # the class's own again

        self.restore = restore


def _fields(state):
    return {f.name: getattr(state, f.name).clone() for f in dataclasses.fields(state)}


class Cell:
    def __init__(self, spec, seed: int, device: torch.device):
        import gym_po_tpu_torch as gp
        from gym_po_tpu_torch.agents import ppo

        cfg, tr = spec["config"], spec["traffic"]
        self.ref = importlib.import_module(f"portbench.reference.{cfg['reference']}")
        self.hp = dict(tr)
        self.limits = spec["own"]["limits"]
        self.trace_units = int(tr.get("trace_units", 3))
        self.seed = seed
        self.env = gp.make(cfg["env_id"], device=device, **cfg["env_kwargs"])
        if tr["compute_dtype"] != "float32":
            raise ValueError("the reference computes the configuration's float32")
        config = ppo.PPOConfig(**{k: tr[k] for k in HP_KEYS if k != "hidden"},
                               hidden=tuple(tr["hidden"]),
                               compute_dtype=torch.float32)
        self.stash = _Stash(ppo, self.env)
        gen = torch.Generator(device=device).manual_seed(seed)
        self.model, self.ts = ppo.init_train_state(self.env, config, gen)
        self.renv = self.ref.PPOEnv(cfg, device, spec["own"].get("check"))
        shape = ref_ppo.shapes(self.renv.n_in, tr["hidden"], self.renv.n_act,
                               self.renv.gaussian)
        own = dict(self.model.named_parameters())
        if {k: tuple(v.shape) for k, v in own.items()} != shape:
            raise ValueError("the program's network differs from the configuration's")
        self.p0 = ref_ppo.init_leaves(shape, torch.Generator(device=device)
                                      .manual_seed(WEIGHTS_SEED), device)
        with torch.no_grad():
            for k, v in self.p0.items():
                own[k].copy_(v)
        self.multi = ppo.make_multi_train_step(self.env, self.model, config, 1)
        self.unit_work = config.num_envs * config.rollout_steps
        self.snaps = []
        for k in range(CHECKED + 1):
            s0 = _fields(self.ts.env_state)
            self.ts, metrics = self.multi(self.ts)
            if device.type == "cuda":
                torch.cuda.synchronize()
            if k < CHECKED:
                self.snaps.append(self._snapshot(s0, metrics, k == 0))
        self.stash.restore()
        self.stash = None

    def _leaves(self, flat):
        """Per-leaf views of a flat buffer laid out as the parameters are."""
        base = self.ts.params.storage_offset()
        return {k: flat[p.storage_offset() - base:][:p.numel()].view_as(p).clone()
                for k, p in self.model.named_parameters()}

    def _snapshot(self, s0, metrics, first: bool):
        st = self.stash
        _, ro, _, _ = st.collect_out
        states = [s0] + [_fields(out[1]) for _, _, out in st.steps]
        snap = {
            "steps": [{"action": a.clone(), "mid": _fields(out[5]["terminal_state"]),
                       "rew": out[2].clone(), "done": out[3].clone(),
                       "trunc": out[4].clone()} for _, a, out in st.steps],
            "states": states,
            "ro": {k: getattr(ro, k).clone() for k in ro._fields},
            "orders": [o.clone() for o in st.orders],
            "loss": float(metrics["loss"][0]),
            "params": self._leaves(self.ts.params),
        }
        if first:
            snap["mu"] = self._leaves(self.ts.opt_state.mu)
        return snap

    def enqueue(self) -> int:
        self.ts, _ = self.multi(self.ts)
        return self.unit_work

    def close_window(self) -> None:
        pass

    def release(self) -> None:
        self.multi = self.model = self.ts = self.env = None

    # ---------------------------------------------------------------- check
    def _chain(self, tf32: bool):
        """The reference over the checked updates from the first weights:
        per update its acting outputs and mean loss; Adam's first moments
        after the first update, the first step's gradient norms, and the
        weights after the last."""
        hp = self.hp
        nh = len(self.hp["hidden"])
        p = {k: v.clone() for k, v in self.p0.items()}
        opt = ref_ppo.Adam(p, hp)
        out = []
        ref_ppo.no_tf32()
        for k, snap in enumerate(self.snaps):
            ro = snap["ro"]
            with torch.no_grad():
                pi, value = ref_ppo.forward(p, ro["obs"], nh, self.renv.discrete, tf32)
                logp = ref_ppo.log_prob(pi, ro["action"])
                mids = [self.renv.observe(s["mid"]) for s in snap["steps"]]
                _, v_term = ref_ppo.forward(p, torch.stack(mids), nh,
                                            self.renv.discrete, tf32)
            rec = {"logp": logp, "value": value, "v_term": v_term,
                   "sampling_z": ref_ppo.sampling_z(pi, ro["action"])}
            ro_r = dict(ro, logp=logp, value=value, v_term=v_term)
            if k == 0:
                rec["grad0"] = _first_grad_norms(p, ro_r, snap["orders"], hp, nh,
                                                 self.renv.discrete)
            rec["loss"] = ref_ppo.learn(p, opt, ro_r, snap["orders"], hp, nh,
                                        self.renv.discrete, tf32)
            if k == 0:
                rec["mu"] = {n: m.clone() for n, m in opt.mu.items()}
            out.append(rec)
        return out, p

    def check(self, control: bool = False):
        ref, p_ref = self._chain(False)
        if control:
            got, p_got = self._chain(True)
        else:
            got, p_got = [{"logp": s["ro"]["logp"], "value": s["ro"]["value"],
                           "v_term": s["ro"]["v_term"], "loss": s["loss"]}
                          for s in self.snaps], self.snaps[-1]["params"]
            got[0]["mu"] = self.snaps[0]["mu"]
        env_bad, acting, loss_gap = 0, 0.0, 0.0
        for k, snap in enumerate(self.snaps):
            if not control:
                ro = snap["ro"]
                for t, s in enumerate(snap["steps"]):
                    env_bad += self.renv.mismatches(
                        snap["states"][t], s["action"], s["mid"], snap["states"][t + 1],
                        s["rew"], s["done"], s["trunc"], ro["obs"][t])
                    # the rollout's records are the step's own
                    fin = (s["done"] | s["trunc"]).float()
                    env_bad += int(((ro["reward"][t] != s["rew"].float())
                                    | (ro["done"][t] != s["done"].float())
                                    | (ro["cont"][t] != 1.0 - fin)).sum())
                    env_bad += int((ro["action"][t] != s["action"]).reshape(
                        fin.shape[0], -1).any(-1).sum())
            for key in ("logp", "value", "v_term"):
                acting = max(acting, _rel_gap(got[k][key], ref[k][key]))
            loss_gap = max(loss_gap, abs(got[k]["loss"] - ref[k]["loss"]))
        # over the losses' mean magnitude: a PPO loss crosses zero
        loss_gap /= max(sum(abs(r["loss"]) for r in ref) / len(ref), 1e-12)
        mu_gap = _leaf_gap(got[0]["mu"], ref[0]["mu"])
        keep = _moving(ref[0]["grad0"])
        change = _leaf_gap({k: p_got[k] - self.p0[k] for k in keep},
                           {k: p_ref[k] - self.p0[k] for k in keep})
        lim = self.limits
        checks = []
        if hasattr(self.renv, "physics_checks"):
            # the control: the reference with its state in bfloat16
            phys = self.renv.physics_checks(self.snaps, self.seed, control=control)
            checks += [{"name": k, "value": v, "limit": lim[k]} for k, v in phys.items()]
        values = {"env_mismatch": env_bad, "acting_gap": acting,
                  "sampling_z": max(r["sampling_z"] for r in ref), "loss_gap": loss_gap,
                  "adam_mu_gap": mu_gap, "change_gap": change}
        return checks + [{"name": k, "value": v, "limit": lim[k]} for k, v in values.items()]

    def failed_units(self, checks) -> int:
        from portbench import core

        return 0 if all(core.check_ok(c) for c in checks) else len(self.snaps)


def _rel_gap(got, ref) -> float:
    """The largest gap over the reference's magnitude, or over 1 where
    that is smaller (f32 rounds relative to the magnitude)."""
    ref = ref.float()
    g = float(((got.float() - ref).abs() / ref.abs().clamp(min=1.0)).max())
    return g if g == g else float("inf")


def _norms(leaves):
    return {k: float(v.double().norm()) for k, v in leaves.items()}


def _leaf_gap(got, ref) -> float:
    """The worst leaf's gap of norms, over the larger of its reference
    norm and the median leaf's."""
    ng, nr = _norms(got), _norms(ref)
    med = statistics.median(nr.values())
    worst = 0.0
    for k in nr:
        g = abs(ng[k] - nr[k]) / max(nr[k], med, 1e-30)
        worst = max(worst, g if g == g else float("inf"))
    return worst


def _moving(grad_norms):
    """Leaves whose first reference gradient is at least a thousandth of
    the median leaf's (the others move under Adam by round-off alone)."""
    med = statistics.median(grad_norms.values())
    return [k for k, g in grad_norms.items() if g >= 1e-3 * med]


def _first_grad_norms(p, ro, orders, hp, nh, discrete):
    """Per-leaf norms of the first minibatch step's gradient."""
    adv, target = ref_ppo.gae(ro["reward"], ro["value"], ro["v_term"], ro["done"],
                              ro["cont"], hp["gamma"], hp["gae_lambda"])
    flat = {k: ro[k].reshape(-1, *ro[k].shape[2:])
            for k in ("obs", "action", "logp", "value")}
    flat["adv"], flat["target"] = adv.reshape(-1), target.reshape(-1)
    mb = flat["adv"].numel() // hp["minibatches"]
    part = {k: v[orders[0]][:mb] for k, v in flat.items()}
    q = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    grads = torch.autograd.grad(ref_ppo.loss(q, part, hp, nh, discrete), list(q.values()))
    return {k: float(g.double().norm()) for k, g in zip(q, grads)}
