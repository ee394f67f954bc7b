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
//
// Two forms of one step: taxi_step_pos on a decoded state (rc, p, d) with
// the draws reduced by invariant divisors, for the rollout, which decodes
// once before its K-step loop and encodes once after it, so its loop holds
// no integer division; and taxi_step on the flat code, for the trainers,
// which index their Q tables by it every step.
#pragma once

#include <stdint.h>

#include "kernel_rng.cuh"

namespace gpt {

// runtime map constants
struct TaxiMap {
  int nlocs, rows, cols, n_valid, all_valid, n_pass, time_limit;
  float r_goal, r_bad, r_any;
};

// A decoded state: taxi cell rc = r * cols + c, passenger p (nlocs: in the
// taxi), destination d.  The flat code is (rc * (nlocs + 1) + p) * nlocs + d.
struct TaxiPos {
  int rc, p, d;
};

struct TaxiStep {
  int s_mid;   // after the task reset, before the full reset
  int s_next;  // after the full reset
  float rew;
  bool done;   // all passengers delivered
  bool reset;  // done or truncated: the episode ended
  int ep_len;  // elapsed at the end of the step, before a reset zeroes it
};

// The same step on decoded states (taxi_step_pos).
struct TaxiStepPos {
  TaxiPos mid, next;
  float rew;
  bool done, reset;
  int ep_len;
};

// The draws' reductions u % n by the map's divisors.  TaxiMod takes them
// as runtime ints (nvcc emits a division sequence for each); TaxiDivs
// from invariant-divisor constants (gpt::UDiv), computed on the host.
struct TaxiMod {
  int nlocs, rows, cols, n_valid;
  __device__ int loc(uint32_t u) const { return rbits(u, nlocs); }
  __device__ int loc1(uint32_t u) const { return rbits(u, nlocs - 1); }
  __device__ int row(uint32_t u) const { return rbits(u, rows); }
  __device__ int col(uint32_t u) const { return rbits(u, cols); }
  __device__ int valid(uint32_t u) const { return rbits(u, n_valid); }
};

// Field order mirrored by ops/fused_taxi.py (TAXI_DIVISORS).
struct TaxiDivs {
  UDiv pd, nlocs, nlocs1, rows, cols, n_valid;  // nlocs1: nlocs - 1
  __device__ int loc(uint32_t u) const { return rbits(u, nlocs); }
  __device__ int loc1(uint32_t u) const { return rbits(u, nlocs1); }
  __device__ int row(uint32_t u) const { return rbits(u, rows); }
  __device__ int col(uint32_t u) const { return rbits(u, cols); }
  __device__ int valid(uint32_t u) const { return rbits(u, n_valid); }
};

// Steps decoded state x under action a.  cell_move [nc*4], loc_at [nc] and
// valid_cells [n_valid] are the per-cell tables (in shared memory);
// completed and elapsed are carried and zeroed at a reset.  No division of
// its own: the draws reduce through mod, the full-reset cell is composed by
// one multiply-add.
template <class RNG, class Mod>
__device__ __forceinline__ TaxiStepPos taxi_step_pos(
    const TaxiMap& M, const Mod& mod, const int32_t* cell_move,
    const int32_t* loc_at, const int32_t* valid_cells, const RNG& rng, int j,
    TaxiPos x, int a, int& completed, int& elapsed) {
  const int nlocs = M.nlocs;
  const int moved = cell_move[x.rc * 4 + min(a, 3)];
  const bool is_pd = a == 4;
  const int loc = loc_at[x.rc];
  const bool goal = is_pd && x.p == nlocs && loc == x.d;
  const bool pickup = is_pd && x.p < nlocs && loc == x.p;
  const bool bad = is_pd && !goal && !pickup;
  const int p2 = pickup ? nlocs : x.p;
  const int rc2 = is_pd ? x.rc : moved;
  completed += goal ? 1 : 0;
  elapsed += 1;
  TaxiStepPos out;
  out.rew = goal ? M.r_goal : (bad ? M.r_bad : M.r_any);
  out.done = completed == M.n_pass;
  const bool trunc = elapsed > M.time_limit;  // strict >, reference :279
  out.reset = out.done || trunc;
  // task reset
  const bool task = goal && !out.reset;
  const int pn = mod.loc(rng.draw(j++));
  const int d0 = mod.loc1(rng.draw(j++));
  out.mid.rc = rc2;
  out.mid.p = task ? pn : p2;
  out.mid.d = task ? d0 + (d0 >= pn ? 1 : 0) : x.d;
  // full reset
  int rc_new;
  if (M.all_valid) {
    const int rr = mod.row(rng.draw(j++));
    rc_new = rr * M.cols + mod.col(rng.draw(j++));
  } else {
    rc_new = valid_cells[mod.valid(rng.draw(j++))];
  }
  const int pr = mod.loc(rng.draw(j++));
  const int dr0 = mod.loc1(rng.draw(j++));
  out.next.rc = out.reset ? rc_new : rc2;
  out.next.p = out.reset ? pr : out.mid.p;
  out.next.d = out.reset ? dr0 + (dr0 >= pr ? 1 : 0) : out.mid.d;
  out.ep_len = elapsed;
  if (out.reset) {
    completed = 0;
    elapsed = 0;
  }
  return out;
}

__device__ __forceinline__ int taxi_encode(const TaxiMap& M, TaxiPos x) {
  return (x.rc * (M.nlocs + 1) + x.p) * M.nlocs + x.d;
}

// The flat form, for the tabular trainers: steps encoded state s (decoded
// here, reference extended_taxi.py:84-94), draws reduced by runtime ints.
template <class RNG>
__device__ __forceinline__ TaxiStep taxi_step(
    const TaxiMap& M, const int32_t* cell_move, const int32_t* loc_at,
    const int32_t* valid_cells, const RNG& rng, int j, int s, int a,
    int& completed, int& elapsed) {
  const int nlocs = M.nlocs;
  const int pd = (nlocs + 1) * nlocs;
  const int rc = s / pd;
  const int rem = s - rc * pd;
  const int p = rem / nlocs;
  const TaxiMod mod = {M.nlocs, M.rows, M.cols, M.n_valid};
  const TaxiStepPos st =
      taxi_step_pos(M, mod, cell_move, loc_at, valid_cells, rng, j,
                    TaxiPos{rc, p, rem - p * nlocs}, a, completed, elapsed);
  TaxiStep out;
  out.s_mid = taxi_encode(M, st.mid);
  out.s_next = taxi_encode(M, st.next);
  out.rew = st.rew;
  out.done = st.done;
  out.reset = st.reset;
  out.ep_len = st.ep_len;
  return out;
}

}  // namespace gpt
