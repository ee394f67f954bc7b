"""The host-side pieces of the CRooms rollout and Q trainer kernels
(``csrc/fused_crooms.cu``, ``csrc/fused_q_crooms.cu``): the power-of-two
rule that lets them multiply by ``1 / cell_size`` where their twins divide,
the params structs they are handed, and the invariant divisors of their
spawns.

The kernels divide ``y`` by the cell size ``cs`` in the cell lookup and in a
wall hit's resample centre.  Where ``cs = 2^k`` the host hands them
``inv_cs = 2^-k`` and they multiply: ``y * 2^-k`` and ``y / 2^k`` are the
correctly rounded values of the same real number, so they are the same f32
for every ``y``, which these tests show in f32 on the CPU over seeded random
values and the edges.  Any other size keeps the division.  The kernels
against their twins on the card, at cell sizes 0.5, 1, 2 and 0.75, are in
test_torch_cuda.py.
"""

import ctypes

import numpy as np
import pytest
import torch

import gym_po_tpu_torch as gpt_torch
from gym_po_tpu_torch.envs.crooms import LAYOUT_NAMES
from gym_po_tpu_torch.ops import make_fused_crooms_rollout, make_fused_q_trainer_crooms
from gym_po_tpu_torch.ops._build import CSRC
from gym_po_tpu_torch.ops.fused_crooms import _CRoomsParams, inverse_cell_size
from gym_po_tpu_torch.ops.fused_q_crooms import _QCRoomsParams
from gym_po_tpu_torch.ops.kernel_rng import MASK32, UDiv, udivmod

F32 = np.float32
TINY = float(np.finfo(F32).smallest_subnormal)
NORMAL = float(np.finfo(F32).tiny)
BIG = float(np.finfo(F32).max)

# cell size -> what the host hands the kernel (0.0: divide)
RULE = [
    (1.0, 1.0), (0.5, 2.0), (2.0, 0.5), (0.25, 4.0), (4.0, 0.25),
    (0.125, 8.0), (2.0**-126, 2.0**126), (2.0**127, 2.0**-127),
    (2.0**-149, 0.0),  # a subnormal size: 2^149 is no f32
    (0.75, 0.0), (1.5, 0.0), (3.0, 0.0), (0.1, 0.0), (1.0 + 2.0**-23, 0.0),
    (0.0, 0.0), (-1.0, 0.0), (-0.5, 0.0), (float("inf"), 0.0),
    (float("nan"), 0.0),
]


@pytest.mark.parametrize("cs,inv", RULE)
def test_power_of_two_rule(cs, inv):
    assert inverse_cell_size(cs) == inv
    if inv:
        assert F32(inv) == inv and F32(cs) * F32(inv) == 1.0


def _f32(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x, F32))


def _values(cs: float) -> torch.Tensor:
    """Seeded random f32 of every magnitude and sign, and the edges: zeros,
    subnormals, the smallest normal, the largest f32, the positions'
    ceiling pos_hi, and just below, at and just above every cell edge of
    the largest layout."""
    rng = np.random.default_rng(int(cs * 1024) + 7)
    bits = rng.integers(0, 2**32, 100_000, dtype=np.uint64).astype(np.uint32)
    rand = bits.view(F32)
    rand = rand[np.isfinite(rand)]
    pos = rng.uniform(0, 64, 100_000).astype(F32)
    with np.errstate(over="ignore"):
        edges = np.arange(0, 65, dtype=F32) * F32(cs)
    edges = edges[np.isfinite(edges)]
    near = np.concatenate([np.nextafter(edges, F32(0)), edges,
                           np.nextafter(edges, F32(np.inf))])
    pos_hi = gpt_torch.make("CRooms-v0", layout="32", cell_size=cs,
                            device="cpu")._pos_hi.astype(F32)
    special = F32([0.0, -0.0, TINY, -TINY, 2 * TINY, NORMAL - TINY, NORMAL,
                   BIG, -BIG, *pos_hi, *np.nextafter(pos_hi, F32(0))])
    return _f32(np.concatenate([rand, pos, near, special]))


@pytest.mark.parametrize("cs", [0.125, 0.25, 0.5, 1.0, 2.0, 4.0, 2.0**-126,
                                2.0**127])
def test_multiply_by_inverse_equals_division(cs):
    """y * inv_cs == y / cs bit for bit in f32 (the twin divides by a f32
    tensor, as here), and floor of it, the cell, alike."""
    y = _values(cs)
    div = y / _f32(cs)
    mul = y * _f32(inverse_cell_size(cs))
    assert torch.equal(div.view(torch.int32), mul.view(torch.int32))
    assert torch.equal(torch.floor(div), torch.floor(mul))


def test_infinities_and_nan_agree():
    y = _f32([np.inf, -np.inf, np.nan])
    for cs in (0.5, 2.0):
        div, mul = y / _f32(cs), y * _f32(inverse_cell_size(cs))
        assert torch.equal(div[:2], mul[:2]) and mul[2].isnan()


def test_a_size_that_is_no_power_of_two_would_differ():
    """Why the rule: at cs = 0.75 or 0.1 a multiply by the rounded 1 / cs
    differs from the division somewhere, so those sizes keep dividing."""
    for cs in (0.75, 0.1, 3.0):
        y = _values(cs)
        div = y / _f32(cs)
        mul = y * _f32(F32(1.0) / F32(cs))
        assert not torch.equal(div, mul)


def test_params_layout_mirrors_the_source():
    """inv_cs follows the 14 floats; the two UDiv, 8-aligned, end it."""
    assert _CRoomsParams.W.offset == 32
    assert _CRoomsParams.cs.offset == 56
    assert _CRoomsParams.agent_x.offset == 108
    assert _CRoomsParams.inv_cs.offset == 112
    assert _CRoomsParams.valid_div.offset == 120
    assert _CRoomsParams.col_div.offset == 144
    assert ctypes.sizeof(_CRoomsParams) == 168
    src = (CSRC / "fused_crooms.cu").read_text()
    assert ("agent_y, agent_x;  // fixed spawns\n  float inv_cs;") in src
    assert "  gpt::UDiv valid_div, col_div;  // n_valid and W, for the spawns\n};" in src


@pytest.mark.parametrize("layout", LAYOUT_NAMES)
def test_spawn_divisors_are_exact(layout):
    """The spawn draws u % n_valid and splits the cell into cell / W and
    cell % W by UDiv constants: exact for every draw's edges and seeded
    draws, and for every cell of the layout."""
    env = gpt_torch.make("CRooms-v0", layout=layout, goal_xy=None, device="cpu")
    run = make_fused_crooms_rollout(env, 256, 2)
    grid = env.grid_np
    n_valid = int((grid != -1).sum())
    assert run.divisors == {"n_valid": n_valid, "W": grid.shape[1]}
    assert run.inv_cs == 1.0
    gen = torch.Generator().manual_seed(n_valid)
    u = torch.cat([torch.randint(0, 2**32, (1 << 16,), generator=gen,
                                 dtype=torch.int64),
                   torch.tensor([0, 1, n_valid - 1, n_valid, n_valid + 1,
                                 2**31 - 1, 2**31, 2**32 - n_valid, MASK32])])
    cells = torch.arange(grid.size, dtype=torch.int64)
    for n, xs in ((n_valid, u), (grid.shape[1], cells)):
        c = UDiv.of(n)
        q, r = udivmod(xs, c.mul, c.sh, c.add, c.n)
        assert torch.equal(q, xs // n) and torch.equal(r, xs % n)


def test_trainer_params_layout_mirrors_the_source():
    """The trainer's struct: inv_cs follows its 17 floats, then the two
    UDiv, 8-aligned, and the observation count with the update sums' stride
    divisor."""
    assert _QCRoomsParams.key0.offset == 60
    assert _QCRoomsParams.cs.offset == 68
    assert _QCRoomsParams.eps.offset == 132
    assert _QCRoomsParams.inv_cs.offset == 136
    assert _QCRoomsParams.valid_div.offset == 144
    assert _QCRoomsParams.col_div.offset == 168
    assert _QCRoomsParams.n_obs.offset == 192
    assert _QCRoomsParams.stride_div.offset == 200
    assert ctypes.sizeof(_QCRoomsParams) == 224
    src = (CSRC / "fused_q_crooms.cu").read_text()
    assert "  float gamma, lr, eps;\n  float inv_cs;" in src
    assert ("  gpt::UDiv valid_div, col_div;  // n_valid and W, for the respawn\n"
            "  int32_t n_obs;") in src
    assert "  gpt::UDiv stride_div;  // slab_stride(n_obs): the update sums' row stride\n};" in src


@pytest.mark.parametrize("cs", [0.5, 1.0, 2.0, 0.75])
@pytest.mark.parametrize("layout", ["4", "16"])
def test_trainer_takes_the_rollouts_inverse_and_divisors(layout, cs):
    """The Q trainer is handed what the rollout is for the same layout and
    cell size: the same inverse cell size (0 where it must divide) and spawn divisors."""
    roll = make_fused_crooms_rollout(gpt_torch.make(
        "CRooms-v0", layout=layout, cell_size=cs, device="cpu"), 256, 2)
    train = make_fused_q_trainer_crooms(gpt_torch.make(
        "CRooms-v0", layout=layout, cell_size=cs, action_type="ordinal",
        device="cpu"), 1024, 2)
    assert train.inv_cs == roll.inv_cs == inverse_cell_size(cs)
    assert (train.inv_cs == 0) == (cs == 0.75)
    assert train.divisors == roll.divisors
