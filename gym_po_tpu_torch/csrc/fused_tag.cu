// Fused K-step rollouts of the point-mass Tag and HeavenHell tasks for Hopper
// (sm_90a).
//
// Replaces two TPU kernels, gym_po_tpu/ops/fused_tag.py::
// make_fused_tag_rollout (entry point fused_tag_launch) and
// make_fused_heavenhell_rollout (fused_heavenhell_launch): Pallas kernels over
// [R, 128] VMEM tiles of the f32 state, drawing from the hardware PRNG.  Each
// is one thread per env here, over the flat [B] layout, with the K-step loop
// in registers and no tables.  The plain PyTorch twins are
// gym_po_tpu_torch/ops/fused_tag.py.
//
// What bounds them on this card: not memory (16 B or 12 B in, 20 B or 16 B
// out per env per call, whatever K is), but the draws and the arithmetic.
// Tag's contract has 21 sites per env-step in six Philox4x32-10 blocks, but
// a step uses only block 0 (the two move uniforms and the flee mode) unless
// the env resets, which at the registry's defaults is a tag, a few in a
// million env-steps (the agent walks at random, 0.25 a step, and the target
// flees at 0.5).  So the kernel draws block 0 and does the flee rule (one sqrtf and
// one IEEE division) every step, and the respawn under a branch: a warp in
// which no env resets skips it (SIMT runs a branch only if a lane takes it;
// an explicit __any_sync vote measured no faster, probe_fused_taxi's
// variant warp-vote), and each resetting env takes its candidates in order,
// computing each Philox block when its search first reaches it and stopping
// at the first candidate that qualifies; the corner distances only when
// none does.  The draws it skips
// are the ones the twin draws and discards (the draw contract is unchanged).
// HeavenHell's contract has 5 sites in two blocks, but a step uses only the
// two move uniforms (block 0) unless the env resets, which at the registry's
// defaults only reaching a site does (its time limit, 500, is past a call of
// K = 256 steps, and elapsed restarts at every call): so it draws block 0
// every step and the spawn (sites 2-3 from block 0, the coin from block 1)
// under a branch, and does a dozen compares and two squared distances.
//
// Exactness: every f32 operation is __fmul_rn/__fadd_rn/__fsub_rn/__fdiv_rn/
// __fsqrt_rn, so nvcc contracts nothing into an FMA and each rounds as in
// the twin's eager PyTorch and the JAX package's XLA on the CPU.
//
// Draw sites, in body order.  Tag: the agent's two move uniforms, the flee
// mode rbits(4), the respawn agent's x and y, then the eight respawn
// candidates' x and y (sites 0-2 used every step, 3-20 only where the env
// resets).  HeavenHell: the two move uniforms (sites 0-1, every step), the
// respawn x and y and the heaven coin (bit 0 of the draw) (sites 2-4, only
// where the env resets).

#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_rng.cuh"
#include "state_rollout.cuh"

// Mirrored field for field by _TagParams in ops/fused_tag.py.
struct TagParams {
  gpt::RolloutHeader h;
  float speed;
};

namespace {

constexpr float kCage = 4.5f;
constexpr float kTagRadius2 = 2.25f;      // 1.5^2
constexpr float kMinSpawnDist2 = 25.0f;   // 5.0^2
constexpr float kTargetStep = 0.5f;
constexpr float kHeavenX = -6.25f, kHeavenY = 6.0f, kSiteRadius2 = 4.0f;

__device__ __forceinline__ float sq(float x) { return __fmul_rn(x, x); }

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// x + (u * 2 - 1) * speed
__device__ __forceinline__ float move(float x, float u, float speed) {
  return __fadd_rn(x, __fmul_rn(__fsub_rn(__fmul_rn(u, 2.0f), 1.0f), speed));
}

// uniform in the cage: u * 9 - 4.5
__device__ __forceinline__ float rcage(uint32_t u) {
  return __fsub_rn(__fmul_rn(gpt::runiform(u), 2.0f * kCage), kCage);
}

// squared distance (c0 - a0)^2 + (c1 - a1)^2
__device__ __forceinline__ float dist2(float c0, float c1, float a0, float a1) {
  return __fadd_rn(sq(__fsub_rn(c0, a0)), sq(__fsub_rn(c1, a1)));
}

using TagPtrs = gpt::StatePtrs<4>;
using HHPtrs = gpt::StatePtrs<3>;

// Tag's respawn of one env (an env whose episode ended): the agent uniform
// in the cage (sites 3, 4); the target the first of 8 candidates (sites
// 5 + 2k, 6 + 2k) at least 5 away, else the farthest corner (a running
// strict maximum over the four).  Block b of the step is computed when the
// search first reaches a site in it; b0 is block 0, already drawn.
__device__ __forceinline__ void tag_respawn(const gpt::LazyRNG& rng,
                                            const gpt::U32x4& b0, float& a0,
                                            float& a1, float& t0, float& t1) {
  gpt::U32x4 blk = rng.block(1);
  a0 = rcage(rng.draw(3, b0));
  a1 = rcage(rng.draw(4, blk));
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int j = 5 + 2 * k;  // x's site; y's is j + 1, in the next block for odd k
    const float c0 = rcage(rng.draw(j, blk));
    if (j % 4 == 3) blk = rng.block((j + 1) / 4);
    const float c1 = rcage(rng.draw(j + 1, blk));
    if (dist2(c0, c1, a0, a1) >= kMinSpawnDist2) {
      t0 = c0;
      t1 = c1;
      return;
    }
  }
  const float corner[4][2] = {
      {-kCage, -kCage}, {-kCage, kCage}, {kCage, -kCage}, {kCage, kCage}};
  t0 = corner[0][0];
  t1 = corner[0][1];
  float best = dist2(t0, t1, a0, a1);
#pragma unroll
  for (int c = 1; c < 4; ++c) {
    const float d = dist2(corner[c][0], corner[c][1], a0, a1);
    if (d > best) {
      t0 = corner[c][0];
      t1 = corner[c][1];
    }
    best = fmaxf(best, d);
  }
}

__global__ void __launch_bounds__(gpt::kRolloutThreads)
fused_tag_kernel(TagParams P, TagPtrs p, const int32_t* __restrict__ tape) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= P.h.num_envs) return;
  float a0 = p.in_f(0, e), a1 = p.in_f(1, e), t0 = p.in_f(2, e), t1 = p.in_f(3, e);
  gpt::LazyRNG rng(tape, P.h.key0, P.h.key1, e, P.h.num_steps,
                   P.h.rows_per_tile, P.h.n_sites);
  int elapsed = 0;
  float racc = 0.f;
  gpt::EpisodeStats stats;
  for (int t = 0; t < P.h.num_steps; ++t) {
    rng.begin_step(t);
    const gpt::U32x4 b0 = rng.block(0);
    a0 = clampf(move(a0, gpt::runiform(rng.draw(0, b0)), P.speed), -kCage, kCage);
    a1 = clampf(move(a1, gpt::runiform(rng.draw(1, b0)), P.speed), -kCage, kCage);
    // the target's flee rule: away, the two orthogonals, or stay
    const int mode = gpt::rbits(rng.draw(2, b0), 4);
    const float w0 = __fsub_rn(t0, a0), w1 = __fsub_rn(t1, a1);
    const float nrm = __fsqrt_rn(__fadd_rn(sq(w0), sq(w1)));
    const float inv = nrm > 1e-9f ? __fdiv_rn(1.0f, fmaxf(nrm, 1e-9f)) : 0.0f;
    const float u0 = __fmul_rn(w0, inv), u1 = __fmul_rn(w1, inv);
    const float s0 = mode == 0 ? u0 : mode == 1 ? -u1 : mode == 2 ? u1 : 0.0f;
    const float s1 = mode == 0 ? u1 : mode == 1 ? u0 : mode == 2 ? -u0 : 0.0f;
    const float n0 = __fadd_rn(t0, __fmul_rn(s0, kTargetStep));
    const float n1 = __fadd_rn(t1, __fmul_rn(s1, kTargetStep));
    if (!(fabsf(n0) > kCage || fabsf(n1) > kCage)) {
      t0 = n0;
      t1 = n1;
    }
    const bool done = dist2(a0, a1, t0, t1) <= kTagRadius2;
    const float rew = done ? 1.0f : 0.0f;
    elapsed += 1;
    const int length = elapsed;
    const bool reset = done || elapsed >= P.h.time_limit;
    if (reset) elapsed = 0;
    if (reset) tag_respawn(rng, b0, a0, a1, t0, t1);
    if (P.h.episode_stats) stats.add(rew, reset, length);
    racc = __fadd_rn(racc, rew);
  }
  p.out_f(0, e, a0);
  p.out_f(1, e, a1);
  p.out_f(2, e, t0);
  p.out_f(3, e, t1);
  p.out_f(4, e, racc);
  if (P.h.episode_stats) stats.store(p, 5, e);
}

__device__ __forceinline__ bool in_free(float x, float y) {
  const bool stem = x >= -2.0f && x <= 2.0f && y >= -1.5f && y <= 4.5f;
  const bool bar = x >= -8.0f && x <= 8.0f && y >= 4.0f && y <= 8.0f;
  return stem || bar;
}

__global__ void __launch_bounds__(gpt::kRolloutThreads)
fused_heavenhell_kernel(TagParams P, HHPtrs p, const int32_t* __restrict__ tape) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= P.h.num_envs) return;
  float x = p.in_f(0, e), y = p.in_f(1, e);
  int h = p.in_i(2, e);
  gpt::LazyRNG rng(tape, P.h.key0, P.h.key1, e, P.h.num_steps,
                   P.h.rows_per_tile, P.h.n_sites);
  int elapsed = 0;
  float racc = 0.f;
  gpt::EpisodeStats stats;
  for (int t = 0; t < P.h.num_steps; ++t) {
    rng.begin_step(t);
    const gpt::U32x4 b0 = rng.block(0);
    const float px = move(x, gpt::runiform(rng.draw(0, b0)), P.speed);
    const float py = move(y, gpt::runiform(rng.draw(1, b0)), P.speed);
    if (in_free(px, py)) {
      x = px;
      y = py;
    }
    const float dy2 = sq(__fsub_rn(y, kHeavenY));
    const bool at_left = __fadd_rn(sq(__fsub_rn(x, kHeavenX)), dy2) <= kSiteRadius2;
    const bool at_right = __fadd_rn(sq(__fadd_rn(x, kHeavenX)), dy2) <= kSiteRadius2;
    const bool done = at_left || at_right;
    const bool reached = h == 1 ? at_right : at_left;
    const float rew = done ? (reached ? 1.0f : -1.0f) : 0.0f;
    elapsed += 1;
    const int length = elapsed;
    const bool reset = done || elapsed >= P.h.time_limit;
    if (reset) {
      elapsed = 0;
      // spawn: x ~ U(-1, 1), y ~ U(0, 1) (block 0), a fair heaven coin
      // (block 1, computed only here)
      x = __fsub_rn(__fmul_rn(gpt::runiform(rng.draw(2, b0)), 2.0f), 1.0f);
      y = gpt::runiform(rng.draw(3, b0));
      h = (int)(rng.draw(4, rng.block(1)) & 1u);
    }
    if (P.h.episode_stats) stats.add(rew, reset, length);
    racc = __fadd_rn(racc, rew);
  }
  p.out_f(0, e, x);
  p.out_f(1, e, y);
  p.out_i(2, e, h);
  p.out_f(3, e, racc);
  if (P.h.episode_stats) stats.store(p, 4, e);
}

}  // namespace

// in: a0, a1, t0, t1; out: the same four, reward sums, then ep_ret, ep_len,
// ep_cnt (null without episode stats); no tables.
extern "C" int fused_tag_launch(const TagParams* P, const void* const* in,
                                void* const* out, const void* const* /*tab*/,
                                const void* tape, void* stream) {
  if (P->h.n_sites != 21) return (int)cudaErrorInvalidValue;  // sites 0-20
  const int threads = gpt::kRolloutThreads;
  const int blocks = (P->h.num_envs + threads - 1) / threads;
  fused_tag_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      *P, TagPtrs(in, out), static_cast<const int32_t*>(tape));
  return (int)cudaGetLastError();
}

// in: x, y (f32), heaven (int32); out: the same three, reward sums, then
// ep_ret, ep_len, ep_cnt (null without episode stats); no tables.
extern "C" int fused_heavenhell_launch(const TagParams* P, const void* const* in,
                                       void* const* out, const void* const* /*tab*/,
                                       const void* tape, void* stream) {
  if (P->h.n_sites != 5) return (int)cudaErrorInvalidValue;  // sites 0-4
  const int threads = gpt::kRolloutThreads;
  const int blocks = (P->h.num_envs + threads - 1) / threads;
  fused_heavenhell_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      *P, HHPtrs(in, out), static_cast<const int32_t*>(tape));
  return (int)cudaGetLastError();
}
