// Fused K-step continuous-ROOMS rollout for Hopper (sm_90a).
//
// Replaces the TPU kernel
// gym_po_tpu/ops/fused_crooms.py::make_fused_crooms_rollout (a Pallas kernel
// over [R, 128] VMEM tiles of f32 positions and velocities, Box-Muller noise
// from the hardware PRNG, the wall and spawn banks stacks of 128-lane rows,
// every lookup a lane shuffle per row).  It computes what that kernel
// computes, not its block structure: one thread per env over the flat [B]
// layout, the K-step loop in registers (position, velocity, goal, elapsed,
// reward sum, episode stats), the padded wall bank (at most 1,280 bytes) and
// the walkable-cell list (at most 852 ints) in shared memory.  The plain
// PyTorch twin is gym_po_tpu_torch/ops/fused_crooms.py; the step,
// crooms_step.cuh, is shared with the Q trainer.
//
// What bounds it on this card: not memory.  Each env reads 24 B and writes
// 28 B (+12 B of stats) once per call, whatever K is.  The work per env-step
// is draws and libm: the contract has 10-12 draw sites in three
// Philox4x32-10 blocks and four Box-Muller normals (a logf, a cosf and a
// sqrtf each), two for the action and two for a wall hit's resample, and
// the JAX kernel computes all of them every step.  A step uses the
// resample's only where the env hits a wall (about one env-step in eleven
// at the registry's defaults, but in almost every warp-step) and the spawn
// draws only where it resets (rarely).  So the kernel draws blocks 0 and 1
// and the action's two normals every step, and puts the resample (block 2,
// two normals, the cell's centre) and the spawn (block 2 and two
// invariant-divisor reductions, no runtime division) under branches on the
// hit and the reset: a warp in which no env hits skips the resample, and in
// one where some do, only they compute it.  (Sharing the hitting lanes'
// normals out over the warp's lanes, one normal a lane, measured slower:
// probe_fused_taxi's variant warp-packed; an explicit __any_sync vote on
// each branch, no faster: warp-vote.)  The division by the cell size is one
// multiply when the host finds the size a power of two (over_cs).  The respawn choices
// and the velocity flag are template parameters, so every draw site is a
// compile-time constant.
//
// Exactness: the f32 arithmetic is written with __fmul_rn/__fadd_rn/
// __fsub_rn/__fdiv_rn (crooms_step.cuh), so nvcc contracts nothing into an
// FMA and each operation rounds as in the twin; the normals are
// gpt::rnormal, the same logf/cosf/sqrtf the twin's torch.log/cos/sqrt call
// on the card.
//
// Draw sites, in body order: ay's uniform, ay's normal (two), ax's uniform,
// ax's normal (two) (sites 0-5, every step), the resample normals ry and rx
// (two each, sites 6-9, where the env hits a wall), goal respawn (random goal
// only), agent respawn (random agent only) (where it resets).  The twin
// draws every site every step; the draws skipped here are ones it discards.

#include <cuda_runtime.h>
#include <stdint.h>

#include "crooms_step.cuh"
#include "kernel_rng.cuh"
#include "state_rollout.cuh"

// Mirrored field for field by _CRoomsParams in ops/fused_crooms.py.
struct CRoomsParams {
  gpt::RolloutHeader h;
  int32_t W, nbank, n_valid, use_vel, rand_goal, rand_agent;
  float cs, half, pos_hi_y, pos_hi_x, thr2, r_step, r_wall, r_goal;
  float std, power, goal_y, goal_x, agent_y, agent_x;  // fixed spawns
  float inv_cs;  // 2^-k where cs = 2^k, else 0 (crooms_step.cuh, over_cs)
  gpt::UDiv valid_div, col_div;  // n_valid and W, for the spawns
};

namespace {

using Ptrs = gpt::StatePtrs<6>;

template <bool kVel, bool kRandGoal, bool kRandAgent>
__global__ void __launch_bounds__(gpt::kRolloutThreads)
fused_crooms_kernel(CRoomsParams P, Ptrs p, const uint8_t* __restrict__ wall,
                    const int32_t* __restrict__ valid,
                    const int32_t* __restrict__ tape) {
  extern __shared__ int32_t smem[];
  int32_t* s_valid = smem;
  uint8_t* s_wall = reinterpret_cast<uint8_t*>(s_valid + P.n_valid);
  for (int i = threadIdx.x; i < P.n_valid; i += blockDim.x) s_valid[i] = valid[i];
  for (int i = threadIdx.x; i < P.nbank; i += blockDim.x) s_wall[i] = wall[i];
  __syncthreads();

  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= P.h.num_envs) return;
  float py = p.in_f(0, e), px = p.in_f(1, e), vy = p.in_f(2, e), vx = p.in_f(3, e);
  float gy = p.in_f(4, e), gx = p.in_f(5, e);
  gpt::LazyRNG rng(tape, P.h.key0, P.h.key1, e, P.h.num_steps,
                   P.h.rows_per_tile, P.h.n_sites);
  const gpt::CRoomsMap M = {P.W, P.nbank, P.h.time_limit, P.cs, P.half,
                            P.pos_hi_y, P.pos_hi_x, P.thr2, P.r_step, P.r_wall,
                            P.r_goal, P.inv_cs};
  constexpr int kAgentSite = kRandGoal ? 11 : 10;
  int elapsed = 0;
  float racc = 0.f;
  gpt::EpisodeStats stats;
  for (int t = 0; t < P.h.num_steps; ++t) {
    rng.begin_step(t);
    const gpt::U32x4 b0 = rng.block(0), b1 = rng.block(1);
    const float uy = gpt::runiform(rng.draw(0, b0));
    const float ay = gpt::crooms_yx_action(
        uy, gpt::rnormal(rng.draw(1, b0), rng.draw(2, b0)), P.std, P.power);
    const float ux = gpt::runiform(rng.draw(3, b0));
    const float ax = gpt::crooms_yx_action(
        ux, gpt::rnormal(rng.draw(4, b1), rng.draw(5, b1)), P.std, P.power);
    const gpt::CRoomsTry tr = gpt::crooms_try<kVel>(M, py, px, vy, vx, ay, ax);
    const bool oob =
        gpt::bank_at(s_wall, M.nbank, gpt::crooms_cell(M, tr.ny, tr.nx)) == 1;
    float ny = tr.ny, nx = tr.nx;
    if (oob) {
      // a wall hit: block 2, the resample's two normals and its centre
      const gpt::U32x4 b2 = rng.block(2);
      const float nry = gpt::rnormal(rng.draw(6, b1), rng.draw(7, b1));
      const float nrx = gpt::rnormal(rng.draw(8, b2), rng.draw(9, b2));
      gpt::crooms_resample(M, py, px, nry, nrx, ny, nx);
    }
    const gpt::CRoomsMove mv =
        gpt::crooms_finish(M, oob, ny, nx, oob ? 0.0f : tr.vy,
                           oob ? 0.0f : tr.vx, gy, gx, elapsed);
    py = mv.py;
    px = mv.px;
    vy = mv.vy;
    vx = mv.vx;
    if (mv.reset) {
      // goal first, then agent: the JAX kernel's body order
      gpt::U32x4 b2 = {};
      if (kRandGoal || kRandAgent) b2 = rng.block(2);
      gy = P.goal_y;
      gx = P.goal_x;
      py = P.agent_y;
      px = P.agent_x;
      if (kRandGoal)
        gpt::crooms_spawn(s_valid, P.valid_div, P.col_div, rng.draw(10, b2), gy, gx);
      if (kRandAgent)
        gpt::crooms_spawn(s_valid, P.valid_div, P.col_div, rng.draw(kAgentSite, b2),
                          py, px);
      vy = 0.f;
      vx = 0.f;
    }
    if (P.h.episode_stats) stats.add(mv.rew, mv.reset, mv.ep_len);
    racc = __fadd_rn(racc, mv.rew);
  }
  p.out_f(0, e, py);
  p.out_f(1, e, px);
  p.out_f(2, e, vy);
  p.out_f(3, e, vx);
  p.out_f(4, e, gy);
  p.out_f(5, e, gx);
  p.out_f(6, e, racc);
  if (P.h.episode_stats) stats.store(p, 7, e);
}

using Kernel = void (*)(CRoomsParams, Ptrs, const uint8_t*, const int32_t*,
                        const int32_t*);

template <bool kVel, bool kRandGoal>
Kernel pick_agent(bool rand_agent) {
  return rand_agent ? fused_crooms_kernel<kVel, kRandGoal, true>
                    : fused_crooms_kernel<kVel, kRandGoal, false>;
}

template <bool kVel>
Kernel pick_goal(bool rand_goal, bool rand_agent) {
  return rand_goal ? pick_agent<kVel, true>(rand_agent)
                   : pick_agent<kVel, false>(rand_agent);
}

}  // namespace

// in: py, px, vy, vx, gy, gx; out: the same six, reward sums, then ep_ret,
// ep_len, ep_cnt (null without episode stats); tab: wall bank, valid cells.
// The pointers travel to the kernel by value, in its parameters.
extern "C" int fused_crooms_launch(const CRoomsParams* P, const void* const* in,
                                   void* const* out, const void* const* tab,
                                   const void* tape, void* stream) {
  if (P->h.n_sites != 10 + P->rand_goal + P->rand_agent)
    return (int)cudaErrorInvalidValue;  // sites 0-11, three blocks
  const int threads = gpt::kRolloutThreads;
  const int blocks = (P->h.num_envs + threads - 1) / threads;
  const size_t smem = sizeof(int32_t) * P->n_valid + ((P->nbank + 3) / 4) * 4;
  const Kernel kern = P->use_vel ? pick_goal<true>(P->rand_goal, P->rand_agent)
                                 : pick_goal<false>(P->rand_goal, P->rand_agent);
  kern<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      *P, Ptrs(in, out), static_cast<const uint8_t*>(tab[0]),
      static_cast<const int32_t*>(tab[1]), static_cast<const int32_t*>(tape));
  return (int)cudaGetLastError();
}

namespace {

__global__ void rnormal_parts_kernel(const uint32_t* __restrict__ w1,
                                     const uint32_t* __restrict__ w2, float* lg,
                                     float* cs, float* nrm, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  lg[i] = logf(fmaxf(gpt::runiform(w1[i]), 1e-12f));
  cs[i] = cosf(6.2831854820251465f * gpt::runiform(w2[i]));
  nrm[i] = gpt::rnormal(w1[i], w2[i]);
}

}  // namespace

// The libm check of the Box-Muller normal: for draws w1[i], w2[i], the
// logf of the first uniform, the cosf of 2*pi times the second, and
// gpt::rnormal itself, as the kernels compute them (chip_smoke.py holds
// them to torch's CUDA log and cos over every uniform a draw can give).
extern "C" int rnormal_parts_launch(const void* w1, const void* w2, void* lg,
                                    void* cs, void* nrm, long long n,
                                    void* stream) {
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  rnormal_parts_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(w1), static_cast<const uint32_t*>(w2),
      static_cast<float*>(lg), static_cast<float*>(cs), static_cast<float*>(nrm),
      n);
  return (int)cudaGetLastError();
}
