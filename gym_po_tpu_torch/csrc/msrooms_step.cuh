// One MultistoryFourRooms env step (device side), shared by the port's
// MSRooms kernels: fused_msrooms.cu (the rollout) and fused_qlearning.cu
// (the Q trainer).
//
// It is the step of the JAX package's MSRooms kernels
// (gym_po_tpu/ops/fused_msrooms.py:138-161 and the trainer's copy of it):
// the move in flat zyx cells clip(agent + disp[executed], 0, ncells - 1)
// (every floor has a full wall border, so stepping off a row lands on a
// wall), the wall test on the cell codes {0 wall, 1 room, 2 stair down,
// 3 stair up}, the stair transit when the agent moved (up lands at
// (z+1)*HW + SW, down at (z-1)*HW + NE), the goal test after the transit,
// the reward, and elapsed > time_limit truncation.  The floor of a cell is
// its index over the cells per floor, an invariant divisor (gpt::UDiv), so
// the step divides no integer at run time.  Its plain PyTorch twin is
// gym_po_tpu_torch/ops/msrooms_dynamics.py::MSRoomsDynamics.  The ROOMS
// step (rooms_step.cuh) tests the goal before any transit, so it is not
// this one; the executed action and the result type are shared with it.
//
// The step draws nothing itself: each kernel takes its failure coin, its
// alternative action and its respawn draws at its own sites (the rollout
// compares runiform() < f32(p), the trainer r24() < int(p * 2^24), each as
// its JAX kernel does) and hands the results in here.
#pragma once

#include <stdint.h>

#include "kernel_rng.cuh"
#include "rooms_step.cuh"

namespace gpt {

struct MSRoomsMap {
  int ncells;
  UDiv floor_cells;  // cells per floor (H * W)
  int up_to, down_to, time_limit;
  float r_step, r_wall, r_goal;
};

// Moves agent by the executed action.  cell [ncells] (the codes) and disp
// [A] (flat-cell displacement per action) are in shared memory; elapsed is
// carried and zeroed at a reset.
__device__ __forceinline__ RoomsMove msrooms_move(const MSRoomsMap& M,
                                                  const uint8_t* cell,
                                                  const int32_t* disp,
                                                  int agent, int goal,
                                                  int executed, int& elapsed) {
  const int proposed = min(max(agent + disp[executed], 0), M.ncells - 1);
  const bool oob = cell[proposed] == 0;
  int a = oob ? agent : proposed;
  if (!oob) {
    const int code = cell[a];
    const int z = (int)udiv((uint32_t)a, M.floor_cells);  // a >= 0
    const int hw = (int)M.floor_cells.n;
    if (code == 3) a = (z + 1) * hw + M.up_to;
    else if (code == 2) a = (z - 1) * hw + M.down_to;
  }
  RoomsMove out;
  out.agent = a;
  out.done = a == goal;
  out.rew = out.done ? M.r_goal : (oob ? M.r_wall : M.r_step);
  elapsed += 1;
  out.ep_len = elapsed;
  out.reset = out.done || elapsed > M.time_limit;  // strict >
  if (out.reset) elapsed = 0;
  return out;
}

}  // namespace gpt
