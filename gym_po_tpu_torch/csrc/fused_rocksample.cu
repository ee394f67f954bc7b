// Fused K-step RockSample rollout for Hopper (sm_90a).
//
// Replaces the TPU kernel
// gym_po_tpu/ops/fused_rocksample.py::make_fused_rocksample_rollout (a
// Pallas kernel over [R, 128] VMEM tiles, the rock-at-cell and rock
// coordinate tables as 128-lane rows read by lane shuffles).  It computes
// what that kernel computes: one thread per env over the flat [B] layout,
// the K-step loop in registers (position, rock-quality bitmask, elapsed,
// reward sum and the four episode-stat accumulators), and the rock-at-cell
// table [rows * cols <= 128] in shared memory, k marking "no rock".  The
// sensor draw is taken every step, as in the JAX kernel, but its result is
// dead there (the reading is not materialized), so the accuracy
// 0.5 * (1 + 2^(-d/d0)) and the rock coordinates it needs are not computed
// here.  The plain PyTorch twin is gym_po_tpu_torch/ops/fused_rocksample.py.
//
// What bounds it on this card: not memory.  Each env reads 8 B of state and
// writes 8 B (+4 B per f32 output) once per call, whatever K is.  The work
// is integer: one Philox4x32-10 block per step (3 draw sites) and a few
// dozen instructions of step.  The parent design also paid three runtime
// 32-bit divisions per env-step (about twenty instructions each, with a
// float reciprocal on the quarter-rate unit): the action's u % (5 + k),
// the position's pos / cols and pos % cols, and the reset bits' u % 2^k.
// This design carries (y, x) across the loop and composes pos once after
// it (the rock lookup reads s_rock_at[y * cols + x]); the action reduces
// by an invariant divisor (gpt::UDiv, constants computed on the host) and
// the reset bits by the mask 2^k - 1, so no integer division is left in
// the loop.
//
// Draw sites, in body order, every step: action rbits(5 + k), sensor
// runiform() (unused), reset bitmask rbits(2^k) (drawn whether or not the
// env resets).  A sample reads the rock at the cell before the move;
// truncation is elapsed >= time_limit (the rooms kernels use >).

#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_rng.cuh"

// Mirrored field for field by _RockSampleParams in ops/fused_rocksample.py.
struct RockSampleParams {
  int32_t num_envs, num_steps, rows_per_tile, n_sites;
  int32_t rows, cols, k, init_cell, time_limit, episode_stats;
  uint32_t key0, key1;
  gpt::UDiv n_act;  // 5 + k actions
};

namespace {

constexpr float kGoodReward = 10.f, kBadPenalty = -10.f, kExitReward = 10.f;
constexpr float kIllegalSample = -100.f;

__global__ void fused_rocksample_kernel(RockSampleParams P,
                                        const int32_t* __restrict__ pos_in,
                                        const int32_t* __restrict__ mask_in,
                                        const int32_t* __restrict__ rock_at,
                                        const int32_t* __restrict__ tape,
                                        int32_t* __restrict__ pos_out,
                                        int32_t* __restrict__ mask_out,
                                        float* __restrict__ rew_out,
                                        float* __restrict__ ep_ret_out,
                                        float* __restrict__ ep_len_out,
                                        float* __restrict__ ep_cnt_out) {
  __shared__ int32_t s_rock_at[128];
  const int ncells = P.rows * P.cols;
  for (int i = threadIdx.x; i < ncells; i += blockDim.x) s_rock_at[i] = rock_at[i];
  __syncthreads();

  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= P.num_envs) return;

  const int pos = pos_in[e];
  int mask = mask_in[e];
  // A position outside the map would index the table out of bounds.  Such
  // an env comes out as pos' = mask' = -1 with NaN sums, as in the twin.
  if ((unsigned)pos >= (unsigned)ncells) {
    const float nan = __int_as_float(0x7fc00000);
    pos_out[e] = mask_out[e] = -1;
    rew_out[e] = nan;
    if (P.episode_stats) ep_ret_out[e] = ep_len_out[e] = ep_cnt_out[e] = nan;
    return;
  }
  gpt::KernelRNG<1> rng(tape, P.key0, P.key1, e, P.num_steps, P.rows_per_tile,
                        P.n_sites);
  const uint32_t reset_bits = (1u << P.k) - 1u;  // u % 2^k
  // once per env, outside the loop: the loop carries (y, x)
  const int y0 = P.init_cell / P.cols, x0 = P.init_cell - y0 * P.cols;
  int y = pos / P.cols, x = pos - y * P.cols;
  int elapsed = 0;
  float racc = 0.f, cur_ret = 0.f, ep_ret = 0.f, ep_len = 0.f, ep_cnt = 0.f;
  for (int t = 0; t < P.num_steps; ++t) {
    rng.begin_step(t);
    const int a = gpt::rbits(rng.draw(0), P.n_act);
    // movement (N=0 E=1 S=2 W=3); exit east off-grid terminates
    const bool is_move = a < 4;
    const int ny = y + (a == 0 ? -1 : (a == 2 ? 1 : 0));
    const int nx = x + (a == 1 ? 1 : (a == 3 ? -1 : 0));
    const bool exited = is_move && nx >= P.cols;
    const bool inside = is_move && ny >= 0 && ny < P.rows && nx >= 0 && nx < P.cols;
    // sampling: the rock at the cell before the move
    const int ridx = s_rock_at[y * P.cols + x];
    const bool on_rock = ridx < P.k;
    const int rbit = min(ridx, P.k - 1);
    const bool is_sample = a == 4;
    const float sample_rew =
        on_rock ? (((mask >> rbit) & 1) ? kGoodReward : kBadPenalty) : kIllegalSample;
    const int mask2 = (is_sample && on_rock) ? (mask & ~(1 << rbit)) : mask;
    (void)rng.draw(1);  // sensor uniform: drawn, unused (see above)
    const float rew = exited ? kExitReward : (is_sample ? sample_rew : 0.f);
    elapsed += 1;
    const bool reset = exited || elapsed >= P.time_limit;  // >=
    if (P.episode_stats) {
      cur_ret = cur_ret + rew;
      if (reset) {
        ep_ret = ep_ret + cur_ret;
        ep_len = ep_len + (float)elapsed;
        ep_cnt = ep_cnt + 1.f;
        cur_ret = 0.f;
      }
    }
    const int new_mask = (int)(rng.draw(2) & reset_bits);
    y = reset ? y0 : (inside ? ny : y);
    x = reset ? x0 : (inside ? nx : x);
    mask = reset ? new_mask : mask2;
    if (reset) elapsed = 0;
    racc = racc + rew;
  }
  pos_out[e] = y * P.cols + x;
  mask_out[e] = mask;
  rew_out[e] = racc;
  if (P.episode_stats) {
    ep_ret_out[e] = ep_ret;
    ep_len_out[e] = ep_len;
    ep_cnt_out[e] = ep_cnt;
  }
}

}  // namespace

extern "C" int fused_rocksample_launch(const RockSampleParams* P,
                                       const void* pos_in, const void* mask_in,
                                       const void* rock_at, const void* tape,
                                       void* pos_out, void* mask_out, void* rew,
                                       void* ep_ret, void* ep_len, void* ep_cnt,
                                       void* stream) {
  if (P->n_sites != 3 || P->rows * P->cols > 128 || P->k < 1 || P->k > 30)
    return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const int blocks = (P->num_envs + threads - 1) / threads;
  fused_rocksample_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      *P, (const int32_t*)pos_in, (const int32_t*)mask_in,
      (const int32_t*)rock_at, (const int32_t*)tape, (int32_t*)pos_out,
      (int32_t*)mask_out, (float*)rew, (float*)ep_ret, (float*)ep_len,
      (float*)ep_cnt);
  return (int)cudaGetLastError();
}
