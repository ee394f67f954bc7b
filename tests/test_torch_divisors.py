"""Division by invariant integers (``gpt::UDiv`` in ``csrc/kernel_rng.cuh``):
the host constants of ``ops/kernel_rng.py::UDiv.of`` through the device
formula, emulated in int64 (``udivmod``), against ``u // n`` and ``u % n``.

The Taxi, RockSample, ROOMS and MultistoryFourRooms rollout kernels
reduce their draws, the Taxi rollout decodes its state and the
MultistoryFourRooms step finds a cell's floor by these constants; the kernels against their twins
on the card are in test_torch_cuda.py, and ``chip_smoke.py``'s
``divisors`` phase holds the device helper to the hardware's ``/`` and
``%`` over all 2^32 u.  The parameter structs that carry them are held to
the C sources' declarations, field by field.
"""

import ctypes
import re

import numpy as np
import pytest
import torch

import gym_po_tpu_torch as gpt_torch
from gym_po_tpu_torch.ops import (
    make_fused_msrooms_rollout,
    make_fused_rocksample_rollout,
    make_fused_rooms_rollout,
    make_fused_taxi_rollout,
)
from gym_po_tpu_torch.maps import LAYOUT_NAMES
from gym_po_tpu_torch.ops._build import CSRC
from gym_po_tpu_torch.ops.fused_msrooms import _MSRoomsParams
from gym_po_tpu_torch.ops.fused_q_crooms import _QCRoomsParams
from gym_po_tpu_torch.ops.fused_qlearning import MAX_TRACE, _QParams
from gym_po_tpu_torch.ops.fused_rocksample import _RockSampleParams
from gym_po_tpu_torch.ops.fused_rooms import _RoomsParams
from gym_po_tpu_torch.ops.fused_taxi import TAXI_DIVISORS
from gym_po_tpu_torch.ops.kernel_rng import MASK32, UDiv, udivmod

N_MAX = 1 << 16
CHUNK = 4096  # divisors per test case: [CHUNK, 265] int64 temporaries
N_RANDOM = 256
# a Taxi map of two landmarks (nlocs - 1 = 1), 3 x 6, two blocked cells
TWO_LANDMARKS = ("R  |  ", "      ", "  | G ")


def edge_u(n: torch.Tensor) -> torch.Tensor:
    """[len(n), 9] uint32 values (in int64) around 0, n, 2^31 and 2^32."""
    n = n[:, None]
    return torch.cat([torch.zeros_like(n), torch.ones_like(n), n - 1, n, n + 1,
                      torch.full_like(n, 2**31 - 1), torch.full_like(n, 2**31),
                      2**32 - n, torch.full_like(n, MASK32)], 1) & MASK32


def constants(ns):
    """The int64 [len(ns), 1] columns of UDiv.of(n) for each n."""
    cs = [UDiv.of(int(n)) for n in ns]
    return tuple(torch.tensor([getattr(c, f) for c in cs],
                              dtype=torch.int64)[:, None]
                 for f in ("mul", "sh", "add", "n"))


def mismatches(u: torch.Tensor, ns, formula=udivmod) -> int:
    """Entries of ``u`` ([len(ns), m] int64) where ``formula`` with the
    host constants of row i's divisor differs from ``//`` or ``%``."""
    mul, sh, add, n = constants(ns)
    q, r = formula(u, mul, sh, add, n)
    return int(((q != u // n) | (r != u % n)).sum())


def without_fixup(u, mul, sh, add, n):
    """The formula with its fix-up add dropped: q = mulhi(mul, u) >> sh."""
    return udivmod(u, mul, sh, 0, n)


def draws_of(n: torch.Tensor, seed: int) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    rnd = torch.randint(0, 2**32, (len(n), N_RANDOM), generator=gen,
                        dtype=torch.int64)
    return torch.cat([edge_u(n), rnd], 1)


@pytest.mark.parametrize("start", range(1, N_MAX + 1, CHUNK))
def test_every_divisor_to_2_16_is_exact(start):
    """n in [start, start + CHUNK): at the nine edge values and 256 seeded
    random u each."""
    n = torch.arange(start, start + CHUNK, dtype=torch.int64)
    assert mismatches(draws_of(n, start), n) == 0


def test_dropping_the_fixup_is_caught():
    """The same inputs catch the formula without its add: every divisor to
    2^16 that takes the fix-up (n = 1 and the round-down multipliers, about
    a third of them) then fails somewhere."""
    n = torch.arange(1, N_MAX + 1, dtype=torch.int64)
    mul, sh, add, nn = constants(n)
    fixed = add[:, 0] != 0
    assert 0.2 < fixed.double().mean() < 0.5
    u = draws_of(n, 7)
    q, r = without_fixup(u, mul, sh, add, nn)
    bad_rows = ((q != u // nn) | (r != u % nn)).any(1)
    assert bool(bad_rows[fixed].all()) and not bool(bad_rows[~fixed].any())


def test_powers_of_two_and_one():
    """2^k (k >= 1) multiplies by 2^(32-k), the high word is u >> k; n = 1
    takes mul = add = 2^32 - 1, whose high word is u."""
    assert (UDiv.of(1).mul, UDiv.of(1).add, UDiv.of(1).sh) == (MASK32, MASK32, 0)
    for k in range(1, 32):
        c = UDiv.of(1 << k)
        assert (c.mul, c.sh, c.add) == (1 << (32 - k), 0, 0)
    u = draws_of(torch.tensor([1 << k for k in range(32)]), 3)
    assert mismatches(u, [1 << k for k in range(32)]) == 0


def test_multipliers_fit_and_meet_their_bounds():
    """Every multiplier fits 32 bits, and its error meets the theorem that
    makes it exact for all u: round-up mul * n - 2^(32+sh) <= 2^sh,
    round-down 2^(32+sh) - mul * n <= 2^sh."""
    rng = np.random.default_rng(13)
    ns = [*range(3, 5000), *rng.integers(5000, 2**32, 5000).tolist(), MASK32]
    for n in ns:
        c = UDiv.of(n)
        if n & (n - 1) == 0:
            continue
        assert c.sh == n.bit_length() - 1 and 2**31 <= c.mul <= MASK32
        err = c.mul * n - (1 << (32 + c.sh))
        assert (0 < err <= 1 << c.sh) if c.add == 0 else (
            c.add == c.mul and -(1 << c.sh) <= err < 0)


@pytest.mark.parametrize("n", [0, -1, 1 << 32])
def test_divisor_out_of_range_is_refused(n):
    with pytest.raises(ValueError):
        UDiv.of(n)


def dense_u(n: int) -> torch.Tensor:
    """Every u below 2^16 and above 2^32 - 2^16, each multiple of n's
    neighbours for 4,096 seeded quotients, and 4,096 seeded random u."""
    gen = torch.Generator().manual_seed(n)
    q = torch.randint(0, 2**32 // n, (4096,), generator=gen, dtype=torch.int64)
    around = (q[:, None] * n + torch.tensor([-1, 0, 1])).reshape(-1)
    rnd = torch.randint(0, 2**32, (4096,), generator=gen, dtype=torch.int64)
    low = torch.arange(1 << 16, dtype=torch.int64)
    return torch.cat([low, MASK32 - low, around, rnd]) & MASK32


TAXI_MAPS = [("Taxi-v4", {}), ("HansenTaxi-v4", {}), ("ExtendedTaxi-v4", {}),
             ("ExtendedHansenTaxi-v4", {}), ("Taxi-v4", {"map": TWO_LANDMARKS})]


@pytest.mark.parametrize("env_id,kw", TAXI_MAPS)
def test_taxi_rollout_divisors_are_exact(env_id, kw):
    env = gpt_torch.make(env_id, device="cpu", **kw)
    run = make_fused_taxi_rollout(env, 256, 2)
    t = env.tables
    n_valid = int((t.tgrid != "|").sum())
    assert run.divisors == dict(zip(TAXI_DIVISORS, (
        (t.nlocs + 1) * t.nlocs, t.nlocs, t.nlocs - 1, t.rows, t.cols,
        n_valid)))
    for n in run.divisors.values():
        assert mismatches(dense_u(n)[None, :], [n]) == 0


def test_taxi_rollout_refuses_a_single_landmark():
    env = gpt_torch.make("Taxi-v4", map=("R  ", "   "), device="cpu")
    with pytest.raises(ValueError, match="landmarks"):
        make_fused_taxi_rollout(env, 256, 2)


def test_rocksample_rollout_divisors_are_exact():
    """k = 1 ... 30 (5 + k actions: 16 at k = 11, a power of two)."""
    for k in range(1, 31):
        env = gpt_torch.make("RockSample-v0", map_size=(6, 6), num_rocks=k,
                             device="cpu")
        run = make_fused_rocksample_rollout(env, 256, 2)
        assert run.divisors == {"n_act": 5 + k}
        assert mismatches(dense_u(5 + k)[None, :], [5 + k]) == 0


@pytest.mark.parametrize("grid_z", [1, 2, 3, 4])
@pytest.mark.parametrize("goal", ["fixed", "random"])
@pytest.mark.parametrize("agent", ["fixed", "random"])
def test_msrooms_rollout_divisors_are_exact(grid_z, goal, agent):
    """The MultistoryFourRooms rollout's divisors: the actions, the actions
    less one, the two spawn banks' sizes and the cells per floor, each
    exact over dense u, whichever spawns are drawn."""
    kw = {} if goal == "fixed" else {"goal_xyz": None}
    if agent == "fixed":
        kw["agent_xyz"] = (1, 1, 0)
    env = gpt_torch.make("MultistoryFourRooms-v0", grid_z=grid_z, device="cpu",
                         **kw)
    run = make_fused_msrooms_rollout(env, 256, 2)
    _, H, GW = env.grid_np.shape
    A = int(env.num_actions)
    assert tuple(run.divisors.values()) == (
        A, A - 1, len(env.valid_goal_states), len(env.valid_agent_states),
        H * GW)
    for n in run.divisors.values():
        assert mismatches(dense_u(n)[None, :], [n]) == 0


@pytest.mark.parametrize("layout", LAYOUT_NAMES)
@pytest.mark.parametrize("goal", ["fixed", "random"])
def test_rooms_rollout_divisors_are_exact(layout, goal):
    """The ROOMS rollout's divisors on every layout: the actions, the
    actions less one and the walkable cells (111 on layout '2' to 852 on
    '32'), each exact over dense u, whether the goal is fixed or drawn."""
    kw = {} if goal == "fixed" else {"goal_xy": None}
    env = gpt_torch.make("Rooms-v0", layout=layout, device="cpu", **kw)
    run = make_fused_rooms_rollout(env, 256, 2)
    n_valid = int((env.grid_np >= 0).sum())
    assert run.n_sites == 4 + (goal == "random")
    assert tuple(run.divisors.values()) == (8, 7, n_valid)
    assert n_valid == len(env.valid_states)
    for n in run.divisors.values():
        assert mismatches(dense_u(n)[None, :], [n]) == 0


C_TYPES = {"int32_t": ctypes.c_int32, "uint32_t": ctypes.c_uint32,
           "float": ctypes.c_float, "gpt::UDiv": UDiv}
C_CONSTANTS = {"kMaxTrace": MAX_TRACE}


def c_struct(source: str, name: str) -> type:
    """A ctypes mirror of struct ``name`` built from its declaration in
    ``csrc/<source>`` (one type per line, comma-separated fields, fixed
    arrays), laid out by ctypes' C rules as the compiler lays it out."""
    text = (CSRC / source).read_text()
    body = re.search(r"\nstruct %s \{\n(.*?)\n\};" % name, text, re.S).group(1)
    fields = []
    for line in body.splitlines():
        line = line.split("//")[0].strip()
        if not line:
            continue
        ctype, decls = re.fullmatch(r"(\S+) (.+);", line).groups()
        for decl in decls.split(","):
            arr = re.fullmatch(r"(\w+)\[(\w+)\]", decl.strip())
            fields.append((arr.group(1), C_TYPES[ctype] * C_CONSTANTS[arr.group(2)])
                          if arr else (decl.strip(), C_TYPES[ctype]))
    return type(name, (ctypes.Structure,), {"_fields_": fields})


@pytest.mark.parametrize("mirror,source,name", [
    (_QCRoomsParams, "fused_q_crooms.cu", "QCRoomsParams"),
    (_MSRoomsParams, "fused_msrooms.cu", "MSRoomsParams"),
    (_RoomsParams, "fused_rooms.cu", "RoomsParams"),
    (_QParams, "fused_qlearning.cu", "QParams"),
])
def test_trainer_and_msrooms_params_mirror_the_sources(mirror, source, name):
    """The wrappers' ctypes structs against the C declarations: the same
    fields in the same order, each at the same offset with the same size,
    and the same total size (the invariant divisors 8-byte aligned)."""
    c = c_struct(source, name)

    def layout(cls):
        return [(f, getattr(cls, f).offset, getattr(cls, f).size)
                for f, _ in cls._fields_]

    assert layout(mirror) == layout(c)
    assert ctypes.sizeof(mirror) == ctypes.sizeof(c)
    assert ctypes.alignment(mirror) == 8


def test_parameter_layouts_mirror_the_sources():
    """UDiv is mul, sh (uint32), add (uint64), n, neg (uint32), 8-aligned;
    RockSampleParams ends in one; TaxiDivs holds six, in the order the
    wrapper fills them."""
    assert ctypes.sizeof(UDiv) == 24 and ctypes.alignment(UDiv) == 8
    assert [f for f, _ in UDiv._fields_] == ["mul", "sh", "add", "n", "neg"]
    assert all(UDiv.of(n).neg == (2**32 - n) % 2**32 for n in (1, 7, MASK32))
    assert _RockSampleParams.n_act.offset == 48
    assert ctypes.sizeof(_RockSampleParams) == 72
    cuh = (CSRC / "kernel_rng.cuh").read_text()
    assert "  uint32_t mul, sh;\n  uint64_t add;" in cuh
    assert "  uint32_t n, neg;" in cuh
    step = (CSRC / "taxi_step.cuh").read_text()
    assert f"UDiv {', '.join(TAXI_DIVISORS)};" in step
    assert "gpt::UDiv n_act;" in (CSRC / "fused_rocksample.cu").read_text()


def test_emulation_matches_numpy_uint64():
    """udivmod's 16-bit split against the device formula in uint64."""
    rng = np.random.default_rng(11)
    ns = rng.integers(1, 2**32, 64, dtype=np.uint64)
    u = rng.integers(0, 2**32, (64, 512), dtype=np.uint64)
    for row, n in enumerate(ns):
        c = UDiv.of(int(n))
        q = ((np.uint64(c.mul) * u[row] + np.uint64(c.add)) >> np.uint64(32)
             ) >> np.uint64(c.sh)
        got = udivmod(torch.as_tensor(u[row].astype(np.int64)), c.mul, c.sh,
                      c.add, c.n)
        assert np.array_equal(got[0].numpy(), q.astype(np.int64))
        assert np.array_equal(q, u[row] // n)
