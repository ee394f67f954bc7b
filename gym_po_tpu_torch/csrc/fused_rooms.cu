// Fused K-step ROOMS rollout for Hopper (sm_90a).
//
// Replaces the TPU kernel
// gym_po_tpu/ops/fused_rooms.py::make_fused_rooms_rollout (a Pallas kernel
// over [R, 128] VMEM tiles, with the grid and spawn banks stored as stacks
// of 128-lane rows and every lookup a lane shuffle per row).  It computes
// what that kernel computes, not its block structure: one thread per env
// over the flat [B] layout, the K-step loop in registers (agent, goal,
// elapsed, reward sum and the four episode-stat accumulators), and the
// step's tables in shared memory: the wall bytes [ncells], the walkable-cell
// list and the A flat displacements, at most 1,225 + 4 * (852 + 8) bytes
// (layout '32').  The plain PyTorch twin is gym_po_tpu_torch/ops/fused_rooms.py.
//
// What bounds it on this card: not memory.  Each env reads 8 B of state and
// writes 8 B (+4 B per f32 output) once per call, whatever K is; the tape,
// in tape mode, is a test device.  The work is integer: one Philox4x32-10
// block per step (3-5 draw sites), the u % n of each draw and two
// shared-memory lookups.  None of it divides at run time: every reduction
// (n_act, n_act - 1, n_valid) goes through an invariant divisor (gpt::UDiv,
// one multiply-add and a shift) whose constants the host hands in.  The
// respawns (their draws and the walkable-cell lookups) run only where the
// episode ends, drawn through gpt::LazyRNG: block 1 (the agent's site when
// both spawns are random) is computed only there.  The respawn choices
// (random or fixed goal and agent) are template parameters, so every draw
// site is a compile-time constant.  The step itself is rooms_step.cuh,
// shared with the trainers.
//
// Draw sites, in body order: commanded action rbits(A), failure coin
// runiform() < p, alternative action rbits(A - 1) (every step), goal
// respawn (random goal only), agent respawn (random agent only) (where the
// episode ends).  The twin draws every site every step; the draws skipped
// here are ones it discards.

#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_rng.cuh"
#include "rooms_step.cuh"

// Mirrored field for field by _RoomsParams in ops/fused_rooms.py.
struct RoomsParams {
  int32_t num_envs, num_steps, rows_per_tile, n_sites;
  int32_t ncells, n_valid, n_act, time_limit, episode_stats;
  int32_t fixed_goal, fixed_agent;  // flat cells, -1 when drawn
  uint32_t key0, key1;
  float p_fail, r_step, r_wall, r_goal;
  // the reductions' invariant divisors: n_act, n_act - 1, n_valid (after
  // the fields above, which keep the layout of the struct without them: a
  // probe can launch an older build on these params)
  gpt::UDiv act_div, alt_div, valid_div;
};

namespace {

template <bool kRandGoal, bool kRandAgent>
__global__ void fused_rooms_kernel(RoomsParams P,
                                   const int32_t* __restrict__ agent_in,
                                   const int32_t* __restrict__ goal_in,
                                   const uint8_t* __restrict__ wall,
                                   const int32_t* __restrict__ valid,
                                   const int32_t* __restrict__ disp,
                                   const int32_t* __restrict__ tape,
                                   int32_t* __restrict__ agent_out,
                                   int32_t* __restrict__ goal_out,
                                   float* __restrict__ rew_out,
                                   float* __restrict__ ep_ret_out,
                                   float* __restrict__ ep_len_out,
                                   float* __restrict__ ep_cnt_out) {
  extern __shared__ int32_t smem[];
  int32_t* s_valid = smem;
  int32_t* s_disp = s_valid + P.n_valid;
  uint8_t* s_wall = reinterpret_cast<uint8_t*>(s_disp + P.n_act);
  for (int i = threadIdx.x; i < P.n_valid; i += blockDim.x) s_valid[i] = valid[i];
  for (int i = threadIdx.x; i < P.n_act; i += blockDim.x) s_disp[i] = disp[i];
  for (int i = threadIdx.x; i < P.ncells; i += blockDim.x) s_wall[i] = wall[i];
  __syncthreads();

  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= P.num_envs) return;

  int agent = agent_in[e], goal = goal_in[e];
  // An agent outside [0, ncells) would index the tables out of bounds.
  // Such an env reads no table and comes out as agent' = goal' = -1 with
  // NaN sums, as in the twin.  The goal is only compared, never looked up:
  // layout '32''s default goal lies outside its grid.
  if ((unsigned)agent >= (unsigned)P.ncells) {
    const float nan = __int_as_float(0x7fc00000);
    agent_out[e] = goal_out[e] = -1;
    rew_out[e] = nan;
    if (P.episode_stats) ep_ret_out[e] = ep_len_out[e] = ep_cnt_out[e] = nan;
    return;
  }
  gpt::LazyRNG rng(tape, P.key0, P.key1, e, P.num_steps, P.rows_per_tile,
                   P.n_sites);
  const gpt::RoomsMap M = {P.ncells, P.n_valid, P.time_limit,
                           P.r_step, P.r_wall, P.r_goal};
  constexpr int kAgentSite = kRandGoal ? 4 : 3;
  int elapsed = 0;
  float racc = 0.f, cur_ret = 0.f, ep_ret = 0.f, ep_len = 0.f, ep_cnt = 0.f;
  for (int t = 0; t < P.num_steps; ++t) {
    rng.begin_step(t);
    const gpt::U32x4 b0 = rng.block(0);
    const int a_cmd = gpt::rbits(rng.draw(0, b0), P.act_div);
    const bool fail = gpt::runiform(rng.draw(1, b0)) < P.p_fail;
    const int alt = gpt::rbits(rng.draw(2, b0), P.alt_div);
    const gpt::RoomsMove mv =
        gpt::rooms_move(M, s_wall, s_disp, agent, goal,
                        gpt::rooms_executed(fail, alt, a_cmd), elapsed);
    agent = mv.agent;
    if (mv.reset) {
      // goal first (site 3, block 0), then agent (site 3 or 4): the JAX
      // kernel's body order
      goal = kRandGoal ? gpt::rooms_spawn(s_valid, P.valid_div, rng.draw(3, b0))
                       : P.fixed_goal;
      if (kRandAgent) {
        const gpt::U32x4 b1 = kAgentSite > 3 ? rng.block(1) : b0;
        agent = gpt::rooms_spawn(s_valid, P.valid_div, rng.draw(kAgentSite, b1));
      } else {
        agent = P.fixed_agent;
      }
    }
    if (P.episode_stats) {
      cur_ret = cur_ret + mv.rew;
      if (mv.reset) {
        ep_ret = ep_ret + cur_ret;
        ep_len = ep_len + (float)mv.ep_len;
        ep_cnt = ep_cnt + 1.f;
        cur_ret = 0.f;
      }
    }
    racc = racc + mv.rew;
  }
  agent_out[e] = agent;
  goal_out[e] = goal;
  rew_out[e] = racc;
  if (P.episode_stats) {
    ep_ret_out[e] = ep_ret;
    ep_len_out[e] = ep_len;
    ep_cnt_out[e] = ep_cnt;
  }
}

}  // namespace

extern "C" int fused_rooms_launch(const RoomsParams* P, const void* agent_in,
                                  const void* goal_in, const void* wall,
                                  const void* valid, const void* disp,
                                  const void* tape, void* agent_out,
                                  void* goal_out, void* rew, void* ep_ret,
                                  void* ep_len, void* ep_cnt, void* stream) {
  const bool rand_goal = P->fixed_goal < 0, rand_agent = P->fixed_agent < 0;
  // sites 0-4 in two blocks; the divisors the ones the params name
  if (P->n_sites != 3 + rand_goal + rand_agent || P->act_div.n != (uint32_t)P->n_act ||
      P->alt_div.n != (uint32_t)P->n_act - 1 || P->valid_div.n != (uint32_t)P->n_valid)
    return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const int blocks = (P->num_envs + threads - 1) / threads;
  const size_t smem =
      sizeof(int32_t) * (P->n_valid + P->n_act) + ((P->ncells + 3) / 4) * 4;
  auto kern = rand_goal ? (rand_agent ? fused_rooms_kernel<true, true>
                                      : fused_rooms_kernel<true, false>)
                        : (rand_agent ? fused_rooms_kernel<false, true>
                                      : fused_rooms_kernel<false, false>);
  kern<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      *P, (const int32_t*)agent_in, (const int32_t*)goal_in,
      (const uint8_t*)wall, (const int32_t*)valid, (const int32_t*)disp,
      (const int32_t*)tape, (int32_t*)agent_out, (int32_t*)goal_out,
      (float*)rew, (float*)ep_ret, (float*)ep_len, (float*)ep_cnt);
  return (int)cudaGetLastError();
}
