"""Fused multi-step rollouts of the point-mass Tag and HeavenHell tasks:
hand-written CUDA kernels and their twins.

Port of the Pallas kernels
:func:`gym_po_tpu.ops.fused_tag.make_fused_tag_rollout` and
:func:`gym_po_tpu.ops.fused_tag.make_fused_heavenhell_rollout`: K steps of
the uniform-random policy per call.  Tag: the clipped point-mass move, the
target's {away, two orthogonals, stay} flee rule cancelled at the cage edge,
the tag radius, and the respawn of agent and target (8 uniform candidates,
the first at least 5.0 away, else the farthest cage corner); 21 draw sites
per step.  HeavenHell: the move cancelled outside the T-maze's free space,
the ±1 terminals, and the respawn with a fair heaven coin; 5 sites.  Both
take optional per-env episode statistics.  The kernels
(``csrc/fused_tag.cu``) run one thread per env over the flat ``[B]``
layout and keep a whole rollout in registers; the source note says what
bounds them on the card.  Each draws its respawn only where an env resets
(Tag's candidate blocks as its search reaches them, HeavenHell's coin
block); the twins draw every site every step and discard what a step does
not use.  ``run.twin`` is the plain PyTorch version.

``run(seed, a0, a1, t0, t1, *tape)`` (Tag: agent and target xy, f32 tiles)
and ``run(seed, x, y, heaven, *tape)`` (HeavenHell: f32, f32 and an int32
tile, 1 = heaven on the +x side) keep the JAX package's contracts: ``[B //
128, 128]`` tiles in, the same tiles and the f32 reward sums out, plus
``(ep_ret, ep_len, ep_cnt)`` with ``episode_stats=True``.  On CUDA tensors
``run`` launches the kernel (or raises); on CPU tensors it runs the twin.
As in the JAX kernels, ``elapsed`` starts from zero at every call.  Their
arithmetic has no transcendental (Tag's one square root is correctly
rounded, :func:`~gym_po_tpu_torch.utils.numerics.sqrt_rn`), so each twin
equals its JAX kernel bit for bit on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from ..envs.tag import (
    BAR,
    CAGE,
    CORNERS,
    HH_RADIUS,
    HH_SITES,
    MIN_SPAWN_DIST,
    STEM,
    TAG_RADIUS,
    TARGET_STEP,
)
from ..utils.numerics import sqrt_rn
from .state_rollout import Header, make_state_rollout

__all__ = ["make_fused_tag_rollout", "make_fused_heavenhell_rollout"]


class _TagParams(Header):
    """Mirror of ``TagParams`` in ``csrc/fused_tag.cu``."""

    _fields_ = [("speed", ctypes.c_float)]


def make_fused_tag_rollout(env, num_envs: int, num_steps: int,
                           rows_per_tile: int = 128,
                           episode_stats: bool = False,
                           rng_tape: bool = False):
    """Build ``run(seed, a0, a1, t0, t1, *tape) -> (a0', a1', t0', t1',
    reward_sums[, ep_ret, ep_len, ep_cnt])`` for a :class:`TagContinuous`
    env.  ``seed``, ``rows_per_tile`` and ``rng_tape`` as in
    :func:`~gym_po_tpu_torch.ops.make_fused_crooms_rollout`."""
    speed = float(env.agent_speed)
    # draw sites per step, in body order: 2 agent-move uniforms, flee mode,
    # respawn agent xy (2), respawn target candidates (8 x 2)
    n_sites = 21

    def rcage(rng):
        return rng.runiform() * (2 * CAGE) - CAGE

    def spawn_target(a0, a1, rng):
        """The first of 8 candidates at least MIN_SPAWN_DIST away, else the
        farthest corner (a running strict maximum over the 4 corners)."""
        c0, c1 = (float(v) for v in CORNERS[0])
        fc0, fc1 = torch.full_like(a0, c0), torch.full_like(a1, c1)
        best = (fc0 - a0) * (fc0 - a0) + (fc1 - a1) * (fc1 - a1)
        for c0, c1 in CORNERS[1:]:
            c0, c1 = float(c0), float(c1)
            d = (c0 - a0) * (c0 - a0) + (c1 - a1) * (c1 - a1)
            better = d > best
            fc0, fc1 = torch.where(better, c0, fc0), torch.where(better, c1, fc1)
            best = torch.maximum(best, d)
        out0, out1 = fc0, fc1
        found = torch.zeros_like(a0, dtype=torch.bool)
        for _ in range(8):
            c0, c1 = rcage(rng), rcage(rng)
            ok = (c0 - a0) * (c0 - a0) + (c1 - a1) * (c1 - a1) >= MIN_SPAWN_DIST**2
            pick = ok & ~found
            out0, out1 = torch.where(pick, c0, out0), torch.where(pick, c1, out1)
            found = found | ok
        return out0, out1

    def step(tab, rng, state, elapsed):
        a0, a1, t0, t1 = state
        a0 = torch.clamp(a0 + (rng.runiform() * 2.0 - 1.0) * speed, -CAGE, CAGE)
        a1 = torch.clamp(a1 + (rng.runiform() * 2.0 - 1.0) * speed, -CAGE, CAGE)
        # the target's flee rule (reference ant_tag.py:105-123)
        mode = rng.rbits(4)
        w0, w1 = t0 - a0, t1 - a1
        nrm = sqrt_rn(w0 * w0 + w1 * w1)
        # 1 / max(nrm, 1e-9), a true division on either device
        inv = torch.where(nrm > 1e-9,
                          torch.ones_like(nrm) / torch.clamp(nrm, min=1e-9), 0.0)
        u0, u1 = w0 * inv, w1 * inv
        zero = torch.zeros_like(u0)
        s0 = torch.where(mode == 0, u0, torch.where(
            mode == 1, -u1, torch.where(mode == 2, u1, zero)))
        s1 = torch.where(mode == 0, u1, torch.where(
            mode == 1, u0, torch.where(mode == 2, -u0, zero)))
        n0, n1 = t0 + s0 * TARGET_STEP, t1 + s1 * TARGET_STEP
        oc = (n0.abs() > CAGE) | (n1.abs() > CAGE)
        t0, t1 = torch.where(oc, t0, n0), torch.where(oc, t1, n1)
        d2 = (a0 - t0) * (a0 - t0) + (a1 - t1) * (a1 - t1)
        done = d2 <= TAG_RADIUS**2
        rew = done.to(torch.float32)
        elapsed = elapsed + 1
        reset = done | (elapsed >= env.time_limit)
        na0, na1 = rcage(rng), rcage(rng)
        nt0, nt1 = spawn_target(na0, na1, rng)
        new = (torch.where(reset, na0, a0), torch.where(reset, na1, a1),
               torch.where(reset, nt0, t0), torch.where(reset, nt1, t1))
        return new, rew, reset, elapsed, torch.where(reset, 0, elapsed)

    return make_state_rollout(
        "fused_tag", "fused_tag_launch", "fused_tag", (torch.float32,) * 4,
        n_sites, num_envs, num_steps, rows_per_tile, episode_stats, rng_tape,
        _TagParams, dict(time_limit=int(env.time_limit), speed=speed), step)


def make_fused_heavenhell_rollout(env, num_envs: int, num_steps: int,
                                  rows_per_tile: int = 128,
                                  episode_stats: bool = False,
                                  rng_tape: bool = False):
    """Build ``run(seed, x, y, heaven, *tape) -> (x', y', heaven',
    reward_sums[, ep_ret, ep_len, ep_cnt])`` for a
    :class:`HeavenHellContinuous` env (``heaven`` an int32 tile)."""
    speed = float(env.agent_speed)
    hx, hy = float(HH_SITES[0, 0]), float(HH_SITES[0, 1])  # heaven-left site
    r2 = float(HH_RADIUS**2)
    # draw sites per step, in body order: 2 move uniforms, respawn x and y
    # uniforms, heaven coin
    n_sites = 5

    def in_free(x, y):
        stem = (x >= STEM[0]) & (x <= STEM[1]) & (y >= STEM[2]) & (y <= STEM[3])
        bar = (x >= BAR[0]) & (x <= BAR[1]) & (y >= BAR[2]) & (y <= BAR[3])
        return stem | bar

    def step(tab, rng, state, elapsed):
        x, y, h = state
        px = x + (rng.runiform() * 2.0 - 1.0) * speed
        py = y + (rng.runiform() * 2.0 - 1.0) * speed
        ok = in_free(px, py)
        x, y = torch.where(ok, px, x), torch.where(ok, py, y)
        dl = (x - hx) * (x - hx) + (y - hy) * (y - hy)
        dr = (x + hx) * (x + hx) + (y - hy) * (y - hy)  # the mirrored site
        at_left, at_right = dl <= r2, dr <= r2
        done = at_left | at_right
        right = h == 1
        reached = (right & at_right) | (~right & at_left)
        one = torch.ones_like(x)
        rew = torch.where(done, torch.where(reached, one, -one), 0.0)
        elapsed = elapsed + 1
        reset = done | (elapsed >= env.time_limit)
        # spawn: x ~ U(-1, 1), y ~ U(0, 1), a fair heaven coin (bit 0)
        nx = rng.runiform() * 2.0 - 1.0
        ny = rng.runiform()
        nh = (rng.draw32() & 1).to(torch.int32)
        new = (torch.where(reset, nx, x), torch.where(reset, ny, y),
               torch.where(reset, nh, h))
        return new, rew, reset, elapsed, torch.where(reset, 0, elapsed)

    return make_state_rollout(
        "fused_tag", "fused_heavenhell_launch", "fused_heavenhell",
        (torch.float32, torch.float32, torch.int32), n_sites, num_envs,
        num_steps, rows_per_tile, episode_stats, rng_tape, _TagParams,
        dict(time_limit=int(env.time_limit), speed=speed), step)
