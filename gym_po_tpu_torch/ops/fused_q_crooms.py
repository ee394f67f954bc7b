"""Fused tabular Q-learning on continuous-state rooms (CRooms): a
hand-written CUDA kernel and its twin.

Port of the Pallas kernel
:func:`gym_po_tpu.ops.fused_q_crooms.make_fused_q_trainer_crooms`: K steps
of epsilon-greedy acting, the discrete-action CRooms physics (the
failure-matrix resample of the commanded action, per-component Box-Muller
action noise, the position clip, the wall test on the discretized cell, the
in-cell resample on a wall hit), the TD target from the position before the
respawn, and the batched update ``Q[obs, a] += lr * td`` (summed or
averaged over duplicates) every step.  Q is indexed by the observation of
the agent's cell: the port's own continuous observation function at the
cell centers (any discrete obs model), walls read 0.

The kernel (``csrc/fused_q_crooms.cu``) is one persistent cooperative
launch per call, on the other one-step trainers' step protocol
(``csrc/fused_qlearning.cu``: per-block update sums, one grid barrier per
step; ``run.grid[2]`` says whether the sums' slab was in shared memory),
over a state of four floats per env; it shares the step with the rollout
(``csrc/crooms_step.cuh``, :mod:`.crooms_dynamics`) and the lookups,
fixed-point sums and launch geometry with the other trainers
(``csrc/tabular.cuh``; :func:`.fused_qlearning.apply_update`), so the
kernel equals the twin bit for bit.  It draws a wall hit's resample and a
respawn only where they are taken; the twin draws every site every step.
The host hands it, as the rollout's, the inverse of a power-of-two cell
size (``run.inv_cs``) and the invariant divisors of its respawn
(``run.divisors``), and the update sums' row stride as one more
(:func:`table_index`).
``run.twin`` is the plain PyTorch version.

``run(seed, lr, epsilon, py, px, vy, vx, q_banks, *tape) -> (py', px', vy',
vx', q_banks', reward_sums)`` keeps the JAX package's contract: four f32
``[B // 128, 128]`` tiles (zero velocities when ``use_velocity`` is off:
they ride along untouched) and the ``[32, 128]`` banks of the flat table
(entry ``(obs, a)`` at ``a * 512 + obs``).  On a CUDA tensor ``run``
launches the kernel (or raises); on a CPU tensor it runs the twin.  As in
the JAX kernel, ``elapsed`` starts from zero at every call.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ._build import count_launch
from .crooms_dynamics import CRoomsDynamics
from .fused_qlearning import (
    MAX_TERMS,
    NB,
    NSB,
    apply_update,
    bank_geometry,
    f32,
    first_argmax,
)
from .fused_crooms import inverse_cell_size
from .kernel_rng import MASK32, KernelRNG, UDiv, W, udivmod
from .rooms_dynamics import RoomsDynamics
from .state_rollout import _ptrs, tiling

__all__ = ["make_fused_q_trainer_crooms", "table_index"]


class _QCRoomsParams(ctypes.Structure):
    """Mirror of ``QCRoomsParams`` in ``csrc/fused_q_crooms.cu``."""

    _fields_ = [(n, ctypes.c_int32) for n in (
        "num_envs", "num_steps", "rows_per_tile", "n_sites", "W", "nbank",
        "n_valid", "n_act", "use_vel", "rand_agent", "time_limit", "nsp", "nq",
        "average", "pfail24")]
    _fields_ += [("key0", ctypes.c_uint32), ("key1", ctypes.c_uint32)]
    _fields_ += [(n, ctypes.c_float) for n in (
        "cs", "half", "pos_hi_y", "pos_hi_x", "thr2", "r_step", "r_wall",
        "r_goal", "std", "power", "goal_y", "goal_x", "agent_y", "agent_x",
        "gamma", "lr", "eps", "inv_cs")]
    _fields_ += [("valid_div", UDiv), ("col_div", UDiv), ("n_obs", ctypes.c_int32),
                 ("stride_div", UDiv)]


def slab_stride(n_obs: int) -> int:
    """``n_obs`` rounded up to 4: the update sums' words per action
    (``slab_stride`` in ``csrc/tabular.cuh``)."""
    return (n_obs + 3) & ~3


def table_index(c: torch.Tensor, n_obs: int, nsp: int) -> torch.Tensor:
    """The flat-table index ``a * nsp + obs`` of the update sums' compact
    index ``c = a * slab_stride(n_obs) + obs``, as the kernel's apply maps
    it: ``a`` by the invariant divisor ``UDiv.of(slab_stride(n_obs))``, no
    runtime division."""
    no = slab_stride(n_obs)
    d = UDiv.of(no)
    a, _ = udivmod(c, d.mul, d.sh, d.add, d.n)
    return c + a * (nsp - no)


@functools.cache
def _launcher():
    from ._build import load_library

    fn = load_library("fused_q_crooms").fused_q_crooms_launch
    fn.argtypes = [ctypes.c_void_p] * 11
    fn.restype = ctypes.c_int
    return fn


def make_fused_q_trainer_crooms(env, num_envs: int, num_steps: int,
                                gamma: float = 0.99,
                                average_duplicates: bool = True,
                                rng_tape: bool = False):
    """Build ``run(seed, lr, epsilon, py, px, vy, vx, q_banks, *tape) ->
    (py', px', vy', vx', q_banks', reward_sums)`` for a :class:`CRooms` env.

    Requires what the JAX kernel requires: a discrete ``action_type``
    ('cardinal' or 'ordinal'), a Discrete observation space of at most 512
    observations, a fixed goal, and ``num_envs`` a multiple of 1024.
    ``seed`` is an int (the Philox key); ``rng_tape=True`` makes ``run``
    take a trailing int32 tape of shape ``run.tape_shape``.
    """
    from ..core import Discrete

    if env.action_type == "yx":
        raise ValueError("Q trainer needs a discrete action_type "
                         "('cardinal'/'ordinal'), not continuous 'yx'")
    if not isinstance(env.observation_space, Discrete):
        raise ValueError("crooms Q trainer needs a Discrete observation space")
    n_obs = int(env.observation_space.n)
    if n_obs > NSB * W:
        raise ValueError(f"n_obs={n_obs} > {NSB * W}")
    if env.fixed_goal_coord is None:
        raise ValueError("crooms Q trainer requires a fixed goal")
    A = int(env.num_actions)
    if A * NSB > NB:
        raise ValueError(f"{A} actions exceed the {NB}-row Q bank")
    R, _ = tiling(num_envs, num_envs)
    if R % 8:
        raise ValueError("num_envs must be a multiple of 1024")
    if num_envs > MAX_TERMS:
        raise ValueError(f"num_envs = {num_envs} exceeds the fixed-point sum's "
                         f"{MAX_TERMS} terms per step")
    dyn = CRoomsDynamics(env, obs_table=True)
    B, K = num_envs, num_steps
    nsb, nb = bank_geometry(n_obs, A)
    nsp, nq = nsb * W, nb * W
    n_sums = A * slab_stride(n_obs)  # words of one step's update sums
    gy, gx = dyn.fixed_goal
    fa = dyn.fixed_agent
    p_fail = 1.0 - float(env._cum[0][0])
    pfail24 = int(p_fail * (1 << 24))
    # draw sites per step, in body order: explore r24, random action,
    # failure r24, alternative action, the ay and ax normals (two each), the
    # wall-resample normals ry and rx (two each), agent respawn (fixed spawn:
    # no draw).  The kernel draws sites 8-11 only where an env hits a wall
    # and site 12 only where its episode ends
    n_sites = 12 + int(fa is None)
    tape_shape = (KernelRNG.tape_rows(n_sites, K, R), W)

    def check(state, q, tape):
        if len(state) != 4:
            raise ValueError(f"run takes 4 state tiles, got {len(state)}")
        dev = state[0].device if isinstance(state[0], torch.Tensor) else None
        for i, x in enumerate(state):
            if (not isinstance(x, torch.Tensor) or x.dtype != torch.float32
                    or tuple(x.shape) != (R, W) or not x.is_contiguous()
                    or x.device != dev):
                raise ValueError(f"state tile {i} must be a contiguous float32 "
                                 f"tensor of shape {(R, W)} on one device")
        if (not isinstance(q, torch.Tensor) or q.dtype != torch.float32
                or tuple(q.shape) != (nb, W) or not q.is_contiguous()
                or q.device != dev):
            raise ValueError(f"q banks must be a contiguous float32 tensor of "
                             f"shape {(nb, W)} on the state's device")
        if len(tape) != int(rng_tape):
            raise ValueError(f"run takes {int(rng_tape)} tape argument(s), got "
                             f"{len(tape)}")
        if rng_tape and (tuple(tape[0].shape) != tape_shape
                         or tape[0].dtype != torch.int32
                         or tape[0].device != dev
                         or not tape[0].is_contiguous()):
            raise ValueError(f"rng tape must be a contiguous int32 tensor of "
                             f"shape {tape_shape} on the state's device")

    def twin(seed: int, lr: float, epsilon: float, py, px, vy, vx, q, *tape):
        """Plain PyTorch version of the kernel, on the state's device."""
        check((py, px, vy, vx), q, tape)
        dev = py.device
        tab = dyn.tables_on(dev)
        rng = KernelRNG(seed, B, K, n_sites, R,
                        tape=tape[0] if rng_tape else None, device=dev)
        lr_f, g_f = f32(lr).to(dev), f32(gamma).to(dev)
        eps24 = int(np.float32(epsilon) * np.float32(1 << 24))
        std, power = float(dyn.std), float(dyn.power)
        py, px, vy, vx = (x.reshape(-1) for x in (py, px, vy, vx))
        q = q.reshape(-1)
        acts = (torch.arange(A, device=dev) * nsp)[:, None]
        live = torch.ones(B, dtype=torch.bool, device=dev)
        elapsed = torch.zeros(B, dtype=torch.int32, device=dev)
        racc = torch.zeros(B, dtype=torch.float32, device=dev)
        for t in range(K):
            rng.begin_step(t)
            qidx = dyn.lookup(tab["obs"], dyn.cell_of(tab, py, px)).long()
            vals = q[acts + qidx]
            greedy, _ = first_argmax(vals)
            explore = rng.r24() < eps24
            a = torch.where(explore, rng.rbits(A), greedy)
            q_taken = vals.gather(0, a[None].long())[0]
            fail = rng.r24() < pfail24
            alt = rng.rbits(A - 1)
            ex = RoomsDynamics.executed(fail, alt, a).long()
            ay = (tab["dy"][ex] + rng.rnormal() * std) * power
            ax = (tab["dx"][ex] + rng.rnormal() * std) * power
            nry, nrx = rng.rnormal(), rng.rnormal()
            mv = dyn.move(tab, py, px, vy, vx, ay, ax, nry, nrx, gy, gx, elapsed)
            # TD target from the position before the respawn
            qidx2 = dyn.lookup(tab["obs"], dyn.cell_of(tab, mv.py, mv.px)).long()
            _, next_v = first_argmax(q[acts + qidx2])
            target = mv.rew + g_f * next_v * torch.where(mv.done, 0.0, 1.0)
            q = apply_update(q, a.long() * nsp + qidx, lr_f * (target - q_taken),
                             live, average_duplicates)
            nay, nax = dyn.spawn(tab, rng) if fa is None else fa
            py, px = torch.where(mv.reset, nay, mv.py), torch.where(mv.reset, nax, mv.px)
            vy = torch.where(mv.reset, 0.0, mv.vy)
            vx = torch.where(mv.reset, 0.0, mv.vx)
            elapsed = mv.elapsed
            racc = racc + mv.rew
        rng.finalize(n_sites)
        return (*(x.reshape(R, W) for x in (py, px, vy, vx)), q.reshape(nb, W),
                racc.reshape(R, W))

    def run(seed: int, lr: float, epsilon: float, py, px, vy, vx, q, *tape):
        """One K-step training call: the CUDA kernel on CUDA tensors, the twin
        on CPU tensors."""
        state = (py, px, vy, vx)
        check(state, q, tape)
        dev = py.device
        if dev.type == "cpu":
            return twin(seed, lr, epsilon, *state, q, *tape)
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        r_step, r_wall, r_goal = dyn.rewards
        P = _QCRoomsParams(
            num_envs=B, num_steps=K, rows_per_tile=R, n_sites=n_sites, W=dyn.W,
            nbank=dyn.nbank, n_valid=dyn.n_valid, n_act=A,
            use_vel=int(dyn.use_vel), rand_agent=int(fa is None),
            time_limit=dyn.time_limit, nsp=nsp, nq=nq,
            average=int(average_duplicates), pfail24=pfail24,
            key0=seed & MASK32, key1=(seed >> 32) & MASK32, cs=dyn.cs,
            half=dyn.half, pos_hi_y=dyn.pos_hi[0], pos_hi_x=dyn.pos_hi[1],
            thr2=dyn.thr2, r_step=r_step, r_wall=r_wall, r_goal=r_goal,
            std=dyn.std, power=dyn.power, goal_y=gy, goal_x=gx,
            agent_y=fa[0] if fa else 0.0, agent_x=fa[1] if fa else 0.0,
            gamma=gamma, lr=lr, eps=epsilon, inv_cs=run.inv_cs,
            valid_div=UDiv.of(dyn.n_valid), col_div=UDiv.of(dyn.W),
            n_obs=n_obs, stride_div=UDiv.of(slab_stride(n_obs)))
        tab = dyn.tables_on(dev)
        outs = [torch.empty_like(x) for x in state]
        outs.append(torch.empty((R, W), dtype=torch.float32, device=dev))
        q_out = torch.empty_like(q)
        # three rotating accumulators of the update sums, the first two zero
        acc = torch.zeros(3 * n_sums, dtype=torch.int64, device=dev)
        cnt = torch.zeros(3 * n_sums, dtype=torch.int32, device=dev)
        grid = (ctypes.c_int * 3)()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            err = _launcher()(
                ctypes.byref(P), _ptrs(state), _ptrs(outs), q.data_ptr(),
                q_out.data_ptr(), acc.data_ptr(), cnt.data_ptr(),
                _ptrs([tab[n] for n in ("wall", "valid", "obs", "dy", "dx")]),
                tape[0].data_ptr() if rng_tape else None, grid, stream)
        if err:
            raise RuntimeError(f"fused_q_crooms_launch failed: CUDA error {err}")
        count_launch(run, "fused_q_crooms")
        run.grid = tuple(grid)
        return (*outs[:4], q_out, outs[4])

    run.twin = twin
    run.inv_cs = inverse_cell_size(dyn.cs)
    run.divisors = {"n_valid": dyn.n_valid, "W": dyn.W}  # the respawn's UDiv
    run.launches = 0
    # (blocks, envs per thread, update sums' slab on chip) of the last launch
    run.grid = None
    run.tape_shape = tape_shape
    run.n_sites = n_sites
    return run
