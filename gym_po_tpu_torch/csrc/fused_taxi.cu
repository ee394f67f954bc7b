// Fused K-step Taxi rollout for Hopper (sm_90a).
//
// Replaces the TPU kernel gym_po_tpu/ops/fused_taxi.py::make_fused_taxi_rollout
// (a Pallas kernel over [R, 128] VMEM tiles).  It computes what that kernel
// computes, not its block structure: one thread per env over the flat [B]
// layout, the K-step loop in registers (state, completed, elapsed, reward sum
// and the four episode-stat accumulators), and the small tables in shared
// memory: cell_move [nc*4], loc_at [nc], the valid-cell list and the optional
// [ns] greedy policy, at most a few KB.  The TPU's [1, 128] lane banks and
// its combined/per-action cell_move split are TPU devices and are not carried
// over.  The plain PyTorch twin is gym_po_tpu_torch/ops/fused_taxi.py.
//
// What bounds it on this card: not memory.  Each env reads 4 B of state and
// writes 4 B (+4 B per f32 output) once per call, whatever K is; the tape,
// in tape mode, is a test device.  The work is integer: each step does div/mod
// by the runtime map constants pd, nlocs and cols (a few dozen instructions
// each, the divisors are not compile-time constants here), two Philox4x32-10
// blocks (20 rounds of two 32x32 multiplies) for the 5-7 draw sites, and the
// u % n of each draw.  The design keeps every intermediate in registers and
// the lookups in shared memory, so the kernel runs at the integer issue rate.
// Compile-time map constants, several envs per thread and CUDA graphs are
// left for later work.
//
// Draw sites, in body order, every step whatever the masks say: action
// (random policy only), task pn, task d0, full-reset cell (rbits(rows) then
// rbits(cols) when every cell is valid, else one rbits(n_valid)), reset pr,
// reset dr0.

#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_rng.cuh"

namespace {

struct TaxiParams {
  int num_envs, num_steps, rows_per_tile, n_sites;
  int nlocs, rows, cols, nc, n_valid, all_valid, ns_policy;
  int n_pass, time_limit, episode_stats;
  float r_goal, r_bad, r_any;
  uint32_t key0, key1;
};

__global__ void fused_taxi_kernel(TaxiParams P, const int32_t* __restrict__ s_in,
                                  const int32_t* __restrict__ cell_move,
                                  const int32_t* __restrict__ loc_at,
                                  const int32_t* __restrict__ valid_cells,
                                  const int32_t* __restrict__ policy,
                                  const int32_t* __restrict__ tape,
                                  int32_t* __restrict__ s_out,
                                  float* __restrict__ rew_out,
                                  float* __restrict__ ep_ret_out,
                                  float* __restrict__ ep_len_out,
                                  float* __restrict__ ep_cnt_out) {
  extern __shared__ int32_t smem[];
  int32_t* s_cm = smem;
  int32_t* s_la = s_cm + P.nc * 4;
  int32_t* s_vc = s_la + P.nc;
  int32_t* s_pol = s_vc + P.n_valid;
  for (int i = threadIdx.x; i < P.nc * 4; i += blockDim.x) s_cm[i] = cell_move[i];
  for (int i = threadIdx.x; i < P.nc; i += blockDim.x) s_la[i] = loc_at[i];
  for (int i = threadIdx.x; i < P.n_valid; i += blockDim.x) s_vc[i] = valid_cells[i];
  for (int i = threadIdx.x; i < P.ns_policy; i += blockDim.x) s_pol[i] = policy[i];
  __syncthreads();

  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= P.num_envs) return;

  const int nlocs = P.nlocs, cols = P.cols;
  const int pd = (nlocs + 1) * nlocs;
  gpt::KernelRNG rng(tape, P.key0, P.key1, e, P.num_steps, P.rows_per_tile,
                     P.n_sites);

  int s = s_in[e];
  // An input outside [0, ns) would index the tables out of bounds.  Such an
  // env reads no table and comes out as s' = -1 with NaN sums, as in the
  // twin; every later state is valid by construction.  One unsigned compare
  // covers both ends (the two-sided form cost about 1 % more).
  if ((unsigned)s >= (unsigned)(P.nc * pd)) {
    const float nan = __int_as_float(0x7fc00000);
    s_out[e] = -1;
    rew_out[e] = nan;
    if (P.episode_stats) {
      ep_ret_out[e] = nan;
      ep_len_out[e] = nan;
      ep_cnt_out[e] = nan;
    }
    return;
  }
  int completed = 0, elapsed = 0;
  float racc = 0.f, cur_ret = 0.f, ep_ret = 0.f, ep_len = 0.f, ep_cnt = 0.f;
  for (int t = 0; t < P.num_steps; ++t) {
    rng.begin_step(t);
    int j = 0;
    int a;
    if (P.ns_policy) {
      a = s_pol[s];
    } else {
      a = gpt::rbits(rng.draw(j++), 5);
    }
    // decode (reference extended_taxi.py:84-94)
    const int rc = s / pd;
    const int rem = s - rc * pd;
    const int p = rem / nlocs;
    const int d = rem - p * nlocs;
    const int moved = s_cm[rc * 4 + min(a, 3)];
    const bool is_pd = a == 4;
    const int loc = s_la[rc];
    const bool goal = is_pd && p == nlocs && loc == d;
    const bool pickup = is_pd && p < nlocs && loc == p;
    const bool bad = is_pd && !goal && !pickup;
    const int p2 = pickup ? nlocs : p;
    const int rc2 = is_pd ? rc : moved;
    completed += goal ? 1 : 0;
    const float rew = goal ? P.r_goal : (bad ? P.r_bad : P.r_any);
    elapsed += 1;
    const bool done = completed == P.n_pass;
    const bool trunc = elapsed > P.time_limit;  // strict >, reference :279
    // task reset: rejection-free d != p
    const bool task = goal && !(done || trunc);
    const int pn = gpt::rbits(rng.draw(j++), nlocs);
    const int d0 = gpt::rbits(rng.draw(j++), nlocs - 1);
    const int dn = d0 + (d0 >= pn ? 1 : 0);
    const int p3 = task ? pn : p2;
    const int d3 = task ? dn : d;
    // full reset
    const bool reset = done || trunc;
    int rc_new;
    if (P.all_valid) {
      const int rr = gpt::rbits(rng.draw(j++), P.rows);
      const int cc = gpt::rbits(rng.draw(j++), cols);
      rc_new = rr * cols + cc;
    } else {
      rc_new = s_vc[gpt::rbits(rng.draw(j++), P.n_valid)];
    }
    const int pr = gpt::rbits(rng.draw(j++), nlocs);
    const int dr0 = gpt::rbits(rng.draw(j++), nlocs - 1);
    const int dr = dr0 + (dr0 >= pr ? 1 : 0);
    const int rc3 = reset ? rc_new : rc2;
    const int p4 = reset ? pr : p3;
    const int d4 = reset ? dr : d3;
    if (reset) completed = 0;
    s = (rc3 * (nlocs + 1) + p4) * nlocs + d4;
    if (P.episode_stats) {
      cur_ret = cur_ret + rew;
      if (reset) {
        ep_ret = ep_ret + cur_ret;
        ep_len = ep_len + (float)elapsed;  // before elapsed is zeroed
        ep_cnt = ep_cnt + 1.f;
        cur_ret = 0.f;
      }
    }
    if (reset) elapsed = 0;
    racc = racc + rew;
  }
  s_out[e] = s;
  rew_out[e] = racc;
  if (P.episode_stats) {
    ep_ret_out[e] = ep_ret;
    ep_len_out[e] = ep_len;
    ep_cnt_out[e] = ep_cnt;
  }
}

}  // namespace

extern "C" int fused_taxi_launch(
    const void* s_in, void* s_out, void* rew, void* ep_ret, void* ep_len,
    void* ep_cnt, const void* cell_move, const void* loc_at,
    const void* valid_cells, const void* policy, const void* tape,
    unsigned int key0, unsigned int key1, int num_envs, int num_steps,
    int rows_per_tile, int n_sites, int nlocs, int rows, int cols,
    int n_valid, int all_valid, int ns_policy, int n_pass, int time_limit,
    float r_goal, float r_bad, float r_any, int episode_stats, void* stream) {
  TaxiParams P;
  P.num_envs = num_envs;
  P.num_steps = num_steps;
  P.rows_per_tile = rows_per_tile;
  P.n_sites = n_sites;
  P.nlocs = nlocs;
  P.rows = rows;
  P.cols = cols;
  P.nc = rows * cols;
  P.n_valid = n_valid;
  P.all_valid = all_valid;
  P.ns_policy = ns_policy;
  P.n_pass = n_pass;
  P.time_limit = time_limit;
  P.episode_stats = episode_stats;
  P.r_goal = r_goal;
  P.r_bad = r_bad;
  P.r_any = r_any;
  P.key0 = key0;
  P.key1 = key1;
  const int threads = 256;
  const int blocks = (num_envs + threads - 1) / threads;
  const size_t smem = sizeof(int32_t) * (P.nc * 5 + n_valid + ns_policy);
  fused_taxi_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      P, (const int32_t*)s_in, (const int32_t*)cell_move,
      (const int32_t*)loc_at, (const int32_t*)valid_cells,
      (const int32_t*)policy, (const int32_t*)tape, (int32_t*)s_out,
      (float*)rew, (float*)ep_ret, (float*)ep_len, (float*)ep_cnt);
  return (int)cudaGetLastError();
}
