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
// in tape mode, is a test device.  The work is integer: two Philox4x32-10
// blocks (rounds of 32x32->64 multiplies on the FMA pipe and three-input
// XORs on the ALU pipe) for the 5-7 draw sites, and the u % n of each draw.
// The map's divisors (pd, nlocs, nlocs - 1, rows, cols, n_valid) are known
// only at run time, and a runtime 32-bit u % n is a sequence of about
// twenty instructions with a float reciprocal on the quarter-rate unit;
// the parent design paid nine of them per env-step (the state's decode,
// six draws, the encode).  This design decodes the state into (rc, p, d)
// once before the K-step loop and encodes it once after; the loop carries
// the three in registers, the greedy policy's index is two multiply-adds,
// and every draw reduces by an invariant divisor (gpt::UDiv, constants
// computed on the host): no integer division is left in the loop.  One
// kernel serves every map, its divisors in the parameters.  Every
// intermediate stays in registers and the lookups in shared memory, so the
// kernel runs at the integer issue rate.  The policy choice is a template
// parameter, so every draw site is a compile-time constant and picks its
// Philox word without selects.  The Taxi step itself is taxi_step.cuh,
// shared with the tabular trainers.
//
// Draw sites, in body order, every step whatever the masks say: action
// (random policy only), then the Taxi step's (taxi_step.cuh: task pn, task
// d0, full-reset cell, reset pr, reset dr0).

#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_rng.cuh"
#include "taxi_step.cuh"

namespace {

struct TaxiParams {
  int num_envs, num_steps, rows_per_tile, n_sites;
  int nlocs, rows, cols, nc, n_valid, all_valid, ns_policy;
  int n_pass, time_limit, episode_stats;
  float r_goal, r_bad, r_any;
  uint32_t key0, key1;
  gpt::TaxiDivs div;
};

// kPolicy: actions from the policy table, else drawn.  A compile-time
// choice, so every draw site is a constant and its word a register
template <bool kPolicy>
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

  const int pd = (P.nlocs + 1) * P.nlocs;
  gpt::KernelRNG<2> rng(tape, P.key0, P.key1, e, P.num_steps,
                        P.rows_per_tile, P.n_sites);

  const int s = s_in[e];
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
  const gpt::TaxiMap M = {P.nlocs, P.rows, P.cols, P.n_valid, P.all_valid,
                          P.n_pass, P.time_limit, P.r_goal, P.r_bad,
                          P.r_any};
  // decode once (reference extended_taxi.py:84-94); the loop carries x
  gpt::TaxiPos x;
  x.rc = (int)gpt::udiv((uint32_t)s, P.div.pd);
  const int rem = s - x.rc * pd;
  x.p = (int)gpt::udiv((uint32_t)rem, P.div.nlocs);
  x.d = rem - x.p * P.nlocs;
  int completed = 0, elapsed = 0;
  float racc = 0.f, cur_ret = 0.f, ep_ret = 0.f, ep_len = 0.f, ep_cnt = 0.f;
  for (int t = 0; t < P.num_steps; ++t) {
    rng.begin_step(t);
    int j = 0;
    const int a = kPolicy ? s_pol[gpt::taxi_encode(M, x)]
                          : gpt::rbits(rng.draw(j++), 5);
    const gpt::TaxiStepPos st = gpt::taxi_step_pos(
        M, P.div, s_cm, s_la, s_vc, rng, j, x, a, completed, elapsed);
    x = st.next;
    if (P.episode_stats) {
      cur_ret = cur_ret + st.rew;
      if (st.reset) {
        ep_ret = ep_ret + cur_ret;
        ep_len = ep_len + (float)st.ep_len;  // before elapsed is zeroed
        ep_cnt = ep_cnt + 1.f;
        cur_ret = 0.f;
      }
    }
    racc = racc + st.rew;
  }
  s_out[e] = gpt::taxi_encode(M, x);
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
    float r_goal, float r_bad, float r_any, int episode_stats,
    const gpt::TaxiDivs* divs, void* stream) {
  if (n_sites > 8) return (int)cudaErrorInvalidValue;  // KernelRNG<2>
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
  P.div = *divs;  // host memory: the kernel takes it by value
  const int threads = 256;
  const int blocks = (num_envs + threads - 1) / threads;
  const size_t smem = sizeof(int32_t) * (P.nc * 5 + n_valid + ns_policy);
  auto kern = ns_policy ? fused_taxi_kernel<true> : fused_taxi_kernel<false>;
  kern<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      P, (const int32_t*)s_in, (const int32_t*)cell_move,
      (const int32_t*)loc_at, (const int32_t*)valid_cells,
      (const int32_t*)policy, (const int32_t*)tape, (int32_t*)s_out,
      (float*)rew, (float*)ep_ret, (float*)ep_len, (float*)ep_cnt);
  return (int)cudaGetLastError();
}

namespace {

// gpt::udiv / gpt::umod against the hardware's u / n and u % n for every
// uint32 u, one divisor per blockIdx.y; adds each divisor's count of u
// where either differs to bad[y].
__global__ void udiv_check_kernel(const gpt::UDiv* __restrict__ divs,
                                  unsigned long long* __restrict__ bad) {
  const gpt::UDiv d = divs[blockIdx.y];
  const uint64_t stride = (uint64_t)gridDim.x * blockDim.x;
  unsigned int miss = 0;
  for (uint64_t i = (uint64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < (1ull << 32); i += stride) {
    const uint32_t u = (uint32_t)i;
    miss += (gpt::udiv(u, d) != u / d.n) | (gpt::umod(u, d) != u % d.n);
  }
  for (int o = 16; o; o >>= 1) miss += __shfl_xor_sync(0xffffffffu, miss, o);
  if ((threadIdx.x & 31) == 0 && miss) atomicAdd(bad + blockIdx.y, (unsigned long long)miss);
}

}  // namespace

// divs: n_divs gpt::UDiv on the device; bad: n_divs zeroed uint64 counts.
extern "C" int udiv_check_launch(const void* divs, int n_divs, void* bad,
                                 void* stream) {
  udiv_check_kernel<<<dim3(4096, n_divs), 256, 0, (cudaStream_t)stream>>>(
      (const gpt::UDiv*)divs, (unsigned long long*)bad);
  return (int)cudaGetLastError();
}
