// One CRooms env step (device side), shared by the port's CRooms kernels:
// fused_crooms.cu (the rollout) and fused_q_crooms.cu (the Q trainer).
//
// It is the step of the JAX package's CRooms kernels
// (gym_po_tpu/ops/fused_crooms.py:138-172 and fused_q_crooms.py:199-232):
// the velocity clip to +-5, the position clip to [0, pos_hi] (the env's
// float64 ceiling cast once to f32), the wall test on the discretized cell,
// the in-cell resample of a wall hit (N(0, 0.5) about the current cell's
// center, clipped to [center - cs/2, nextafter(center + cs/2, 0)]), the
// zeroed velocity on a hit, the goal test dy*dy + dx*dx <= f32(thr^2), the
// wall/step/goal reward and elapsed > time_limit truncation.  Its plain
// PyTorch twin is gym_po_tpu_torch/ops/crooms_dynamics.py::CRoomsDynamics.
//
// Rounding: every float operation is one f32 operation rounded to nearest,
// as the twin's eager PyTorch and the JAX package's XLA on the CPU compute
// it.  nvcc contracts a*b + c into an FMA by default, which rounds once where
// they round twice, so each product and sum here is __fmul_rn/__fadd_rn/
// __fsub_rn (never contracted) and each division by the cell size
// __fdiv_rn, or a multiply that rounds the same (over_cs).
//
// The step comes in parts (crooms_try, crooms_cell, crooms_resample,
// crooms_finish), so that the rollout and the trainer compute a resample
// only where an env hits a wall.
//
// The step draws nothing itself: each kernel takes the draws of its
// effective action, the two resample normals and its respawns at its own
// sites and hands the results in.  Lookups read the JAX kernels' 128-lane
// banks: a table padded to a multiple of 128 entries, an index past it
// reading lane idx % 128 of the first row (bank_at).
#pragma once

#include <stdint.h>

#include "kernel_rng.cuh"

namespace gpt {

constexpr float kMaxVelocity = 5.0f;

struct CRoomsMap {
  int W;           // grid columns
  int nbank;       // entries of the padded banks (a multiple of 128)
  int time_limit;
  float cs, half;  // cell size and f32(cs / 2)
  float pos_hi_y, pos_hi_x, thr2;
  float r_step, r_wall, r_goal;
  float inv_cs;    // 2^-k where the host found cs = 2^k, else 0 (over_cs)
};

struct CRoomsMove {
  float py, px, vy, vx;  // after the move, before a respawn
  float rew;
  bool done;   // the goal was reached
  bool reset;  // done or truncated: the episode ended
  int ep_len;  // elapsed at the end of the step, before a reset zeroes it
};

// bank[idx] as the JAX kernels' lane-bank gather reads it
template <class T>
__device__ __forceinline__ T bank_at(const T* bank, int nbank, int idx) {
  return (unsigned)idx < (unsigned)nbank ? bank[idx] : bank[idx & 127];
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// y / cs.  Where the host found cs = 2^k it hands inv_cs = 2^-k, and
// y * 2^-k is y / 2^k for every f32 y (both are the correctly rounded value
// of the same real number), so one multiply does; any other cs (inv_cs = 0)
// takes the IEEE division.
__device__ __forceinline__ float over_cs(const CRoomsMap& M, float y) {
  if (M.inv_cs != 0.0f) return __fmul_rn(y, M.inv_cs);
  return __fdiv_rn(y, M.cs);
}

// flat cell floor(y / cs) * W + floor(x / cs), in int32 as the JAX kernels
__device__ __forceinline__ int crooms_cell(const CRoomsMap& M, float y, float x) {
  const int cy = (int)floorf(over_cs(M, y));
  const int cx = (int)floorf(over_cs(M, x));
  return cy * M.W + cx;
}

// (u * 2 - 1 + n * std) * power: the rollout's effective action component
__device__ __forceinline__ float crooms_yx_action(float u, float n, float std,
                                                  float power) {
  return __fmul_rn(__fadd_rn(__fsub_rn(__fmul_rn(u, 2.0f), 1.0f), __fmul_rn(n, std)),
                   power);
}

// (d + n * std) * power: the trainer's, from the executed displacement d
__device__ __forceinline__ float crooms_disp_action(float d, float n, float std,
                                                    float power) {
  return __fmul_rn(__fadd_rn(d, __fmul_rn(n, std)), power);
}

// The move before the wall test: the velocity (kVel: clipped to +-5) and
// the new position, clipped to [0, pos_hi].
struct CRoomsTry {
  float ny, nx, vy, vx;
};

template <bool kVel>
__device__ __forceinline__ CRoomsTry crooms_try(const CRoomsMap& M, float py,
                                                float px, float vy, float vx,
                                                float ay, float ax) {
  CRoomsTry out;
  out.vy = vy;
  out.vx = vx;
  if (kVel) {
    out.vy = clampf(__fadd_rn(vy, ay), -kMaxVelocity, kMaxVelocity);
    out.vx = clampf(__fadd_rn(vx, ax), -kMaxVelocity, kMaxVelocity);
    out.ny = __fadd_rn(py, out.vy);
    out.nx = __fadd_rn(px, out.vx);
  } else {
    out.ny = __fadd_rn(py, ay);
    out.nx = __fadd_rn(px, ax);
  }
  out.ny = clampf(out.ny, 0.0f, M.pos_hi_y);
  out.nx = clampf(out.nx, 0.0f, M.pos_hi_x);
  return out;
}

// A wall hit's new position: within the CURRENT cell (py, px), N(0, 0.5)
// about its center from the standard normals (nry, nrx), its upper edge one
// ULP down.
__device__ __forceinline__ void crooms_resample(const CRoomsMap& M, float py,
                                                float px, float nry, float nrx,
                                                float& ry, float& rx) {
  const float ceny =
      __fadd_rn(__fmul_rn(floorf(over_cs(M, py)), M.cs), M.half);
  const float cenx =
      __fadd_rn(__fmul_rn(floorf(over_cs(M, px)), M.cs), M.half);
  const float hiy = nextafterf(__fadd_rn(ceny, M.half), 0.0f);
  const float hix = nextafterf(__fadd_rn(cenx, M.half), 0.0f);
  ry = clampf(__fadd_rn(ceny, __fmul_rn(nry, 0.5f)), __fsub_rn(ceny, M.half), hiy);
  rx = clampf(__fadd_rn(cenx, __fmul_rn(nrx, 0.5f)), __fsub_rn(cenx, M.half), hix);
}

// The end of the step from the position and velocity after the wall test
// (oob: it hit): the goal test, the reward, elapsed and truncation.
__device__ __forceinline__ CRoomsMove crooms_finish(const CRoomsMap& M, bool oob,
                                                    float py, float px, float vy,
                                                    float vx, float gy, float gx,
                                                    int& elapsed) {
  CRoomsMove out;
  out.py = py;
  out.px = px;
  out.vy = vy;
  out.vx = vx;
  const float dy = __fsub_rn(py, gy), dx = __fsub_rn(px, gx);
  out.done = __fadd_rn(__fmul_rn(dy, dy), __fmul_rn(dx, dx)) <= M.thr2;
  out.rew = out.done ? M.r_goal : (oob ? M.r_wall : M.r_step);
  elapsed += 1;
  out.ep_len = elapsed;
  out.reset = out.done || elapsed > M.time_limit;  // strict >
  if (out.reset) elapsed = 0;
  return out;
}

// a uniform walkable cell's center from one draw, with the reference's
// implicit cell size 1 for spawns; n_valid and W are invariant divisors
// (gpt::UDiv), so no runtime integer division
__device__ __forceinline__ void crooms_spawn(const int32_t* valid,
                                             const UDiv& n_valid, const UDiv& W,
                                             uint32_t u, float& cy, float& cx) {
  const uint32_t cell = (uint32_t)valid[rbits(u, n_valid)];  // >= 0
  const uint32_t row = udiv(cell, W);
  cy = __fadd_rn((float)(int)row, 0.5f);
  cx = __fadd_rn((float)(int)(cell + row * W.neg), 0.5f);  // cell % W
}

}  // namespace gpt
