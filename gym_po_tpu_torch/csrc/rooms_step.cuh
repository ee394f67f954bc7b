// One ROOMS env step (device side), shared by the port's ROOMS kernels:
// fused_rooms.cu (the rollout), fused_qlearning.cu (one-step Q and Q(lambda))
// and fused_ac.cu (actor-critic).
//
// It is the step of the JAX package's ROOMS kernels
// (gym_po_tpu/ops/fused_rooms.py:142-180 and the trainers' copies of it):
// generative action failure (fail with probability p, then uniform over the
// other A - 1 actions, which is exactly the reference's failure matrix),
// the move in flat cells clip(agent + disp[executed], 0, ncells - 1) with
// the wall test (every layout has a full wall border, so stepping off a row
// lands on a wall cell), the goal reward, elapsed > time_limit truncation,
// and the respawn from the walkable-cell list.  Its plain PyTorch twin is
// gym_po_tpu_torch/ops/rooms_dynamics.py::RoomsDynamics.
//
// The step draws nothing itself: each kernel takes its failure coin, its
// alternative action and its respawn draws at its own sites (the rollout
// compares runiform() < f32(p), the trainers r24() < int(p * 2^24), each as
// its JAX kernel does) and hands the results in here.
#pragma once

#include <stdint.h>

#include "kernel_rng.cuh"

namespace gpt {

struct RoomsMap {
  int ncells, n_valid, time_limit;
  float r_step, r_wall, r_goal;
};

struct RoomsMove {
  int agent;   // after the move, before a respawn
  float rew;
  bool done;   // the goal was reached
  bool reset;  // done or truncated: the episode ended
  int ep_len;  // elapsed at the end of the step, before a reset zeroes it
};

// the executed action: the commanded one, or on failure one of the others
__device__ __forceinline__ int rooms_executed(bool fail, int alt, int a_cmd) {
  return fail ? alt + (alt >= a_cmd ? 1 : 0) : a_cmd;
}

// Moves agent by the executed action.  wall [ncells] (1 on a wall) and
// disp [A] (flat-cell displacement per action) are in shared memory;
// elapsed is carried and zeroed at a reset.
__device__ __forceinline__ RoomsMove rooms_move(const RoomsMap& M,
                                                const uint8_t* wall,
                                                const int32_t* disp, int agent,
                                                int goal, int executed,
                                                int& elapsed) {
  const int proposed = min(max(agent + disp[executed], 0), M.ncells - 1);
  const bool oob = wall[proposed] != 0;
  RoomsMove out;
  out.agent = oob ? agent : proposed;
  out.done = out.agent == goal;
  out.rew = out.done ? M.r_goal : (oob ? M.r_wall : M.r_step);
  elapsed += 1;
  out.ep_len = elapsed;
  out.reset = out.done || elapsed > M.time_limit;  // strict >
  if (out.reset) elapsed = 0;
  return out;
}

// a uniform walkable cell from one draw: u % n_valid by a runtime division
// (the trainers), or by the invariant divisor of n_valid (the rollout)
__device__ __forceinline__ int rooms_spawn(const int32_t* valid, int n_valid,
                                           uint32_t u) {
  return valid[rbits(u, n_valid)];
}
__device__ __forceinline__ int rooms_spawn(const int32_t* valid,
                                           const UDiv& n_valid, uint32_t u) {
  return valid[rbits(u, n_valid)];
}

}  // namespace gpt
