// One Taxi env step (device side), shared by the port's Taxi kernels:
// fused_taxi.cu (the rollout) and fused_qlearning.cu (the tabular trainers).
//
// It is the transition and rewards of the JAX package's Taxi kernels
// (reference extended_taxi.py:244-287), the task reset (a new passenger
// after a dropoff that does not end the episode, rejection-free d != p) and
// the full episode reset.  Its plain PyTorch twin is
// gym_po_tpu_torch/ops/taxi_dynamics.py::TaxiDynamics.step, which draws the
// same sites in the same order.
//
// Draw sites, from the caller's first free site j, every step whatever the
// masks say: task pn, task d0, full-reset cell (rbits(rows) then
// rbits(cols) when every cell is valid, else one rbits(n_valid)), reset pr,
// reset dr0.
#pragma once

#include <stdint.h>

#include "kernel_rng.cuh"

namespace gpt {

// runtime map constants (the divisors are not compile-time constants)
struct TaxiMap {
  int nlocs, rows, cols, n_valid, all_valid, n_pass, time_limit;
  float r_goal, r_bad, r_any;
};

struct TaxiStep {
  int s_mid;   // after the task reset, before the full reset
  int s_next;  // after the full reset
  float rew;
  bool done;   // all passengers delivered
  bool reset;  // done or truncated: the episode ended
  int ep_len;  // elapsed at the end of the step, before a reset zeroes it
};

// Steps state s under action a.  cell_move [nc*4], loc_at [nc] and
// valid_cells [n_valid] are the per-cell tables (in shared memory);
// completed and elapsed are carried and zeroed at a reset.
template <class RNG>
__device__ __forceinline__ TaxiStep taxi_step(
    const TaxiMap& M, const int32_t* cell_move, const int32_t* loc_at,
    const int32_t* valid_cells, const RNG& rng, int j, int s, int a,
    int& completed, int& elapsed) {
  const int nlocs = M.nlocs, cols = M.cols;
  const int pd = (nlocs + 1) * nlocs;
  // decode (reference extended_taxi.py:84-94)
  const int rc = s / pd;
  const int rem = s - rc * pd;
  const int p = rem / nlocs;
  const int d = rem - p * nlocs;
  const int moved = cell_move[rc * 4 + min(a, 3)];
  const bool is_pd = a == 4;
  const int loc = loc_at[rc];
  const bool goal = is_pd && p == nlocs && loc == d;
  const bool pickup = is_pd && p < nlocs && loc == p;
  const bool bad = is_pd && !goal && !pickup;
  const int p2 = pickup ? nlocs : p;
  const int rc2 = is_pd ? rc : moved;
  completed += goal ? 1 : 0;
  elapsed += 1;
  TaxiStep out;
  out.rew = goal ? M.r_goal : (bad ? M.r_bad : M.r_any);
  out.done = completed == M.n_pass;
  const bool trunc = elapsed > M.time_limit;  // strict >, reference :279
  out.reset = out.done || trunc;
  // task reset
  const bool task = goal && !out.reset;
  const int pn = rbits(rng.draw(j++), nlocs);
  const int d0 = rbits(rng.draw(j++), nlocs - 1);
  const int p3 = task ? pn : p2;
  const int d3 = task ? d0 + (d0 >= pn ? 1 : 0) : d;
  out.s_mid = (rc2 * (nlocs + 1) + p3) * nlocs + d3;
  // full reset
  int rc_new;
  if (M.all_valid) {
    const int rr = rbits(rng.draw(j++), M.rows);
    rc_new = rr * cols + rbits(rng.draw(j++), cols);
  } else {
    rc_new = valid_cells[rbits(rng.draw(j++), M.n_valid)];
  }
  const int pr = rbits(rng.draw(j++), nlocs);
  const int dr0 = rbits(rng.draw(j++), nlocs - 1);
  const int rc3 = out.reset ? rc_new : rc2;
  const int p4 = out.reset ? pr : p3;
  const int d4 = out.reset ? dr0 + (dr0 >= pr ? 1 : 0) : d3;
  out.s_next = (rc3 * (nlocs + 1) + p4) * nlocs + d4;
  out.ep_len = elapsed;
  if (out.reset) {
    completed = 0;
    elapsed = 0;
  }
  return out;
}

}  // namespace gpt
