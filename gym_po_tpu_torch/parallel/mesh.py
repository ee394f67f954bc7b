"""Process groups as meshes, PyTorch port of :mod:`gym_po_tpu.parallel.mesh`.

The JAX package runs SPMD inside one program: a ``jax.sharding.Mesh`` spans
the devices and ``shard_map`` gives each its shard.  Here SPMD runs across
processes: one process per rank, a ``torch.distributed`` process group
joining them (NCCL between CUDA devices, gloo on the CPU, or for two ranks
that share one card), and every rank runs the same code on its own rows.
The only traffic is the collectives the JAX code names: the learners'
gradient ``pmean`` and the fused trainers' per-chunk table ``pmean``
(:mod:`~gym_po_tpu_torch.parallel.data_parallel`), each an ``all_reduce``
sum divided by the group's size.  Env stepping needs none.

A :class:`Mesh` is the group as this rank sees it.  Without an initialized
group :func:`make_mesh` gives a one-rank mesh whose collectives are the
identity.  :class:`Ranks` starts n ranks in local processes, for tests,
``dryrun_multichip`` and single-machine runs; across machines start one
process per rank with ``torchrun`` and call :func:`distributed_init`.

Not ported: ``put_global``, the JAX layout of a host value over addressable
devices.  Each rank holds its own shard here, cut by :func:`shard_batch`,
:func:`~gym_po_tpu_torch.parallel.data_parallel.replicate` and the
learners' ``shard_train_state``.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from ..core import map_tensors
from ..vector import rollout

__all__ = [
    "DATA_AXIS",
    "Mesh",
    "make_mesh",
    "local_mesh",
    "distributed_init",
    "shard_batch",
    "shard_rows",
    "split_generator",
    "sharded_rollout",
    "Ranks",
]

DATA_AXIS = "data"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A process group as one rank sees it: the group (``None``: one rank,
    no group, every collective the identity), this rank, the group's size,
    this rank's device and the axis names and sizes."""

    group: Optional[Any]
    rank: int
    size: int
    device: torch.device
    axis_names: Tuple[str, ...] = (DATA_AXIS,)
    dims: Tuple[int, ...] = (1,)

    @property
    def shape(self) -> Dict[str, int]:
        """``{axis name: size}``, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.dims))

    def all_mean_(self, x: torch.Tensor) -> torch.Tensor:
        """``pmean`` in place: the sum over the group's ranks (``all_reduce``)
        divided by its size, as JAX's ``psum / n``; returns ``x``."""
        if self.group is not None:
            dist.all_reduce(x, group=self.group)
            # a true division: torch multiplies by the reciprocal of a scalar
            x.div_(torch.full((), self.size, dtype=x.dtype, device=x.device))
        return x


def local_mesh(device) -> Mesh:
    """A one-rank mesh on ``device`` with no group: what the learners run
    on when they are given no mesh."""
    return Mesh(None, 0, 1, torch.device(device))


def _default_device(rank: int) -> torch.device:
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % max(torch.cuda.device_count(), 1))


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = (DATA_AXIS,),
              devices: Optional[Sequence[Any]] = None) -> Mesh:
    """The mesh of the default process group.

    ``shape`` defaults to ``(world size, 1, ...)``; a shape whose product
    is not the world size is refused.  ``devices`` holds one device per rank
    (this rank takes ``devices[rank]``); by default the rank's CUDA device,
    ``LOCAL_RANK`` (as ``torchrun`` sets it, else the rank) modulo the
    local card count.  Without an initialized group the mesh has one rank
    and no group.
    """
    if dist.is_available() and dist.is_initialized():
        group, rank, size = dist.group.WORLD, dist.get_rank(), dist.get_world_size()
    else:
        group, rank, size = None, 0, 1
    if shape is None:
        shape = (size,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(d) for d in shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"shape {shape} does not match axis names {tuple(axis_names)}")
    if math.prod(shape) != size:
        raise ValueError(f"mesh shape {shape} does not span the group's {size} "
                         "rank(s)")
    if devices is None:
        device = _default_device(rank)
    else:
        devices = list(devices)
        if len(devices) != size:
            raise ValueError(f"{len(devices)} devices for {size} rank(s)")
        device = torch.device(devices[rank])
    return Mesh(group, rank, size, device, tuple(axis_names), shape)


def distributed_init(allow_fallback: Optional[bool] = None, **kwargs) -> None:
    """Join the default process group: call once per process before
    :func:`make_mesh`.  A no-op when the group exists already.

    Over ``torch.distributed.init_process_group``.  A bare call reads the
    group from the environment (``torchrun`` sets ``MASTER_ADDR``, ``RANK``,
    ``WORLD_SIZE``).  ``allow_fallback``: when True, a failure to join
    degrades to one process with a ``RuntimeWarning``; when False it
    re-raises.  By default True for a bare call (running alone is the
    expected outcome off a cluster) and False when arguments are given (a
    misconfigured launch must not train on 1/N of the group unnoticed).
    """
    if dist.is_initialized():
        return
    if allow_fallback is None:
        allow_fallback = not kwargs
    try:
        dist.init_process_group(**kwargs)
    except (ValueError, RuntimeError) as e:
        if not allow_fallback:
            raise
        warnings.warn(
            f"torch.distributed.init_process_group failed ({e!r}); continuing "
            "single-process. Pass allow_fallback=False to make this fatal.",
            RuntimeWarning,
        )


def shard_rows(tree, rank: int, size: int, device=None):
    """Rank ``rank``'s block of ``size`` equal blocks of rows (the leading
    axis) of every tensor in ``tree``, contiguous, on ``device`` (default:
    where it lies)."""

    def rows(x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] % size:
            raise ValueError(f"{x.shape[0]} rows do not split into {size} shards")
        n = x.shape[0] // size
        return x[rank * n:(rank + 1) * n].to(device or x.device).contiguous()

    return map_tensors(rows, tree)


def shard_batch(mesh: Mesh, tree):
    """This rank's rows of a global batch ``tree`` (tensors, arrays or an
    env state with a leading batch axis), on the mesh's device: rank r of n
    takes the r-th of n equal blocks, as ``P('data')`` lays them out."""
    return shard_rows(tree, mesh.rank, mesh.size, mesh.device)


def split_generator(seed_or_generator: Union[int, torch.Generator], n: int,
                    device=None) -> List[torch.Generator]:
    """``n`` generators derived from one, as ``jax.random.split`` gives n
    keys: each seeded by one 63-bit draw of ``seed_or_generator`` (an int
    seeds a CPU generator first; a generator is advanced by the draw).  The
    new generators lie on ``device``, by default the source's."""
    if isinstance(seed_or_generator, torch.Generator):
        gen = seed_or_generator
    else:
        gen = torch.Generator().manual_seed(int(seed_or_generator))
    seeds = torch.randint(0, 2**63 - 1, (n,), generator=gen, device=gen.device)
    device = torch.device(device) if device is not None else gen.device
    return [torch.Generator(device=device).manual_seed(s) for s in seeds.tolist()]


def sharded_rollout(env, mesh: Mesh, seed_or_generator, policy: Optional[Callable],
                    num_envs: int, num_steps: int):
    """This rank's shard of a ``num_envs``-env rollout of ``num_steps``.

    Each rank runs the single-device :func:`~gym_po_tpu_torch.vector.rollout`
    on ``num_envs / size`` envs, drawing from its generator of
    :func:`split_generator` (``seed_or_generator``, size ranks); there is no
    traffic between ranks.  Returns ``(traj, (obs, state))`` of the rank's
    envs, time axis first.
    """
    if num_envs % mesh.size:
        raise ValueError(f"num_envs={num_envs} not divisible by the mesh's "
                         f"{mesh.size} ranks")
    gen = split_generator(seed_or_generator, mesh.size, mesh.device)[mesh.rank]
    return rollout(env, gen, policy, num_envs // mesh.size, num_steps)


def _rank_loop(rank: int, size: int, backend: str, init: str, timeout: float,
               tasks, results) -> None:
    """A rank's process: join the group, then run each task (a pickled
    ``(fn, args)``) until a ``None``, putting ``(rank, ok, result or
    traceback)``, the result pickled."""
    try:
        if backend == "nccl":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=init, rank=rank,
                                world_size=size,
                                timeout=datetime.timedelta(seconds=timeout))
    except Exception:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))
        return
    try:
        while True:
            try:
                task = tasks.get()
                if task is None:
                    break
                fn, args = pickle.loads(task)
                out = (rank, True, pickle.dumps(fn(*args)))
            except Exception:  # reported to the parent, which raises it
                out = (rank, False, traceback.format_exc())
            results.put(out)
    finally:
        dist.destroy_process_group()


class Ranks:
    """``n`` ranks in local processes, joined in one process group.

    The processes start by the ``spawn`` method and meet at a ``file://``
    rendezvous in a fresh temporary directory (no port to collide on).
    ``run(fn, *args)`` runs ``fn(*args)`` on every rank and returns the
    results by rank; ``fn`` must be importable (a module-level function)
    and its arguments and result picklable.  A rank that raises, or a run
    that outlasts ``timeout`` seconds, stops every rank and raises in the
    caller.  ``close`` (or the end of a ``with`` block) stops the ranks,
    waits ``timeout`` seconds for them to exit, then kills them and raises.
    The group's own collectives time out after ``timeout`` seconds too.
    """

    def __init__(self, n: int, backend: str = "gloo", timeout: float = 120.0):
        import multiprocessing

        self.n, self.timeout = int(n), float(timeout)
        ctx = multiprocessing.get_context("spawn")
        self._dir = tempfile.mkdtemp(prefix="gym_po_ranks_")
        init = "file://" + os.path.join(self._dir, "rendezvous")
        self._tasks = [ctx.Queue() for _ in range(self.n)]
        self._results = ctx.Queue()
        self._procs = [ctx.Process(target=_rank_loop, daemon=True, args=(
            r, self.n, backend, init, self.timeout, self._tasks[r], self._results))
            for r in range(self.n)]
        for p in self._procs:
            p.start()

    def run(self, fn: Callable, *args) -> list:
        # pickled here: a queue would share tensors' memory between the ranks
        task = pickle.dumps((fn, args))
        for q in self._tasks:
            q.put(task)
        out: list = [None] * self.n
        deadline = time.monotonic() + self.timeout
        for _ in range(self.n):
            while True:
                try:
                    rank, ok, value = self._results.get(timeout=1.0)
                    break
                except queue.Empty:
                    dead = [r for r, p in enumerate(self._procs) if not p.is_alive()]
                    if dead or time.monotonic() > deadline:
                        self._stop(wait=5.0)
                        why = (f"rank(s) {dead} exited" if dead else
                               f"no result within {self.timeout} s")
                        raise TimeoutError(f"{fn.__name__} did not finish on every "
                                           f"rank: {why}") from None
            if not ok:
                self._stop(wait=5.0)  # the others may wait in a collective
                raise RuntimeError(f"rank {rank} of {self.n} failed:\n{value}")
            out[rank] = pickle.loads(value)
        return out

    def _stop(self, wait: float) -> bool:
        """Stop the ranks, killing any still alive after ``wait`` seconds;
        True if each exited in time."""
        for q in self._tasks:
            q.put(None)
        clean = True
        deadline = time.monotonic() + wait
        for p in self._procs:
            p.join(max(deadline - time.monotonic(), 0.0))
            if p.is_alive():
                clean = False
                p.kill()
                p.join(5)
        while True:  # drain what a stopped rank left behind
            try:
                self._results.get_nowait()
            except queue.Empty:
                break
        shutil.rmtree(self._dir, ignore_errors=True)
        return clean

    def close(self) -> None:
        if not self._stop(self.timeout):
            raise TimeoutError(f"a rank did not exit within {self.timeout} s")

    def __enter__(self) -> "Ranks":
        return self

    def __exit__(self, exc_type, *exc) -> bool:
        if exc_type is None:
            self.close()
        else:
            self._stop(wait=5.0)
        return False
