// Fused tabular Q-learning on Taxi for Hopper (sm_90a): the whole trainer,
// K steps of acting, stepping and updating, in one launch.
//
// Replaces two TPU kernels:
//  * gym_po_tpu/ops/fused_qlearning.py::make_fused_q_trainer: epsilon-greedy
//    Q-learning on the classic and extended maps, Q indexed by state or by
//    Hansen obs, optional Expected-SARSA target, optional Watkins/Peng Q(lambda)
//    over a ring of the last L table addresses (entry point fused_q_launch);
//  * gym_po_tpu/ops/fused_double_q.py::make_fused_double_q_trainer: double
//    Q-learning on the classic map, a per-env coin picking which of two
//    stacked tables is updated (entry point fused_double_q_launch).
// Both are one templated kernel.  The plain PyTorch twins are
// gym_po_tpu_torch/ops/fused_qlearning.py and ops/fused_double_q.py.
//
// What bounds it on this card: the step-to-step dependence, not bytes or
// arithmetic.  Every step reads the Q table that all B envs updated in the
// step before, so the TPU kernel is one program over the whole batch (grid
// of 1).  Here it is one persistent cooperative launch: grid.sync() twice
// per step (after the accumulation, after the apply), each a grid-wide
// barrier, plus B integer atomics per step into a table of at most 7,168
// entries.  On an H100 at B = 65,536 a step takes about 12 us: half of it
// the two barriers, a third the atomics (probe_fused_qlearning.py, figures
// in PERF.md); the per-env work (two Philox blocks, a few div/mod, ten
// shared-memory lookups) is small beside that.  The bytes are tiny: 4 B of
// state in and out per env per call, and the 28 KB table.  The other way to
// order the steps, one launch per step, measured about 4x more per step
// through the Python wrapper; that figure includes the wrapper's host work
// per launch, which a CUDA graph would not pay, so it is an upper figure.
//
// Design:
//  * The grid is sized from the occupancy API to what is co-resident, and
//    each thread owns the envs gtid + i*nthreads for all K steps; their
//    state, counters, trace age and reward sum stay in thread-local arrays.
//    The trace ring (L table addresses per env) is a [L, B] scratch buffer.
//  * Each block keeps a copy of the flat Q table in shared memory for the
//    lookups; the TPU's [nb, 128] lane banks and its MXU mask scatter are
//    not carried over: entry (obs, a) sits at flat index a*nsp + obs.
//  * Order-independent sums: each lr*td (times (gamma*lambda)^k on the trace)
//    is added as an int64 fixed point at scale 2^32 (round half to even),
//    and duplicate counts as int32, so the result does not depend on the
//    order of the atomics and equals the twin's index_add_ bit for bit.
//    Tabular Q from zeros is full of exact ties among actions, and a
//    one-ulp difference would flip an argmax.  The apply converts once:
//    (float)(sum * 2^-32), then divides by max(count, 1) in f32.  A term
//    with |w| > 2^6 (or NaN) is past the fixed point's range: it flags its
//    entry, which becomes NaN, so a diverging run goes non-finite as an f32
//    sum would, and the twin does the same.
//  * The Taxi step (transition, task reset, full reset, and their draws)
//    is taxi_step.cuh, shared with fused_taxi.cu.
//  * Float arithmetic that the twin rounds per operation (the TD target, the
//    Expected-SARSA blend) uses __fmul_rn/__fadd_rn/__fsub_rn, which nvcc
//    never contracts into an FMA.
//
// Draw sites per step, in body order, every step whatever the masks say:
// explore r24, random action rbits(5), [double Q: table coin rbits(2)],
// task pn, task d0, full-reset cell (rbits(rows) then rbits(cols) when every
// cell is valid, else one rbits(n_valid)), reset pr, reset dr0.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "kernel_rng.cuh"
#include "taxi_step.cuh"

namespace cg = cooperative_groups;

constexpr int kMaxTrace = 64;

// Mirrored field for field by _QParams in ops/fused_qlearning.py.  Outside
// the anonymous namespace: the extern "C" entry points take it, and a type
// with internal linkage would give them internal linkage too.
struct QParams {
  int32_t num_envs, num_steps, rows_per_tile, n_sites;
  int32_t nlocs, rows, cols, n_valid, all_valid, hansen;
  int32_t n_pass, time_limit;
  int32_t nsp;  // stride between actions in the flat table (nsb * 128)
  int32_t nq;   // entries of the (stacked) flat table
  int32_t average, expected_sarsa, trace_len, watkins_cut;
  uint32_t key0, key1;
  float r_goal, r_bad, r_any, gamma, lr, eps;
  float coefs[kMaxTrace];  // (gamma*lambda)^k in f32, k < trace_len
};

namespace {

constexpr int kThreads = 256;
constexpr int kMaxEnvsPerThread = 8;
constexpr double kFix = 4294967296.0;                // 2^32
constexpr double kUnfix = 2.3283064365386963e-10;    // 2^-32
// |w| <= 2^6 per term and at most 2^24 terms an entry per step (the wrapper
// checks B * L) keep the int64 sum below 2^62; counts stay below 2^24
constexpr float kMaxTerm = 64.0f;
constexpr int kOverflow = 1 << 30;

__device__ __forceinline__ float pick5(const float v[5], int a) {
  return a == 0 ? v[0] : a == 1 ? v[1] : a == 2 ? v[2] : a == 3 ? v[3] : v[4];
}

// first maximum (strict >), as _first_argmax in the JAX kernel
__device__ __forceinline__ int first_argmax(const float v[5], float& best) {
  int best_a = 0;
  best = v[0];
#pragma unroll
  for (int a = 1; a < 5; ++a)
    if (v[a] > best) {
      best = v[a];
      best_a = a;
    }
  return best_a;
}

__device__ __forceinline__ void lookup(const float* q, int idx, int nsp,
                                       float v[5]) {
#pragma unroll
  for (int a = 0; a < 5; ++a) v[a] = q[a * nsp + idx];
}

// cnt[addr] counts the terms (when averaging) and flags a term out of the
// fixed point's range with kOverflow; such an entry becomes NaN at the apply
__device__ __forceinline__ void accumulate(long long* acc, int* cnt, int addr,
                                           float w, bool average) {
  if (!(fabsf(w) <= kMaxTerm)) {  // also NaN
    atomicOr(cnt + addr, kOverflow);
    return;
  }
  const long long fx = __double2ll_rn((double)w * kFix);
  atomicAdd(reinterpret_cast<unsigned long long*>(acc + addr),
            static_cast<unsigned long long>(fx));
  if (average) atomicAdd(cnt + addr, 1);
}

template <int NBLK, bool kDouble>
__global__ void __launch_bounds__(kThreads)
fused_q_kernel(QParams P, int envs_per_thread,
               const int32_t* __restrict__ s_in, int32_t* __restrict__ s_out,
               float* __restrict__ rew_out, const float* __restrict__ q_in,
               float* q_out, long long* acc, int* cnt, int* ring,
               const int32_t* __restrict__ cell_move,
               const int32_t* __restrict__ loc_at,
               const int32_t* __restrict__ hansen_cell,
               const int32_t* __restrict__ valid_cells,
               const int32_t* __restrict__ tape) {
  cg::grid_group grid = cg::this_grid();
  const int nc = P.rows * P.cols;
  extern __shared__ float smem[];
  float* s_q = smem;
  int32_t* s_cm = reinterpret_cast<int32_t*>(s_q + P.nq);
  int32_t* s_la = s_cm + nc * 4;
  int32_t* s_hc = s_la + nc;
  int32_t* s_vc = s_hc + nc;
  for (int i = threadIdx.x; i < P.nq; i += blockDim.x) s_q[i] = q_in[i];
  for (int i = threadIdx.x; i < nc * 4; i += blockDim.x) s_cm[i] = cell_move[i];
  for (int i = threadIdx.x; i < nc; i += blockDim.x) {
    s_la[i] = loc_at[i];
    s_hc[i] = hansen_cell[i];
  }
  for (int i = threadIdx.x; i < P.n_valid; i += blockDim.x) s_vc[i] = valid_cells[i];
  __syncthreads();

  const int B = P.num_envs;
  const int nthreads = gridDim.x * blockDim.x;
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  const int nlocs = P.nlocs, nsp = P.nsp;
  const int pd = (nlocs + 1) * nlocs;
  const gpt::TaxiMap M = {nlocs, P.rows, P.cols, P.n_valid, P.all_valid,
                          P.n_pass, P.time_limit, P.r_goal, P.r_bad, P.r_any};
  const int L = P.trace_len;
  const bool trace = !kDouble && L > 1;
  const bool average = P.average != 0;
  const int eps24 = __float2int_rz(__fmul_rn(P.eps, 16777216.0f));
  const int nq1 = P.nq / 2;  // double Q: table B starts here

  auto obs_of = [&](int s) {
    if (kDouble || !P.hansen) return s;  // double Q indexes by state
    const int rc = s / pd, rem = s - (s / pd) * pd;
    return (s_hc[rc] * (nlocs + 1) + rem / nlocs) * nlocs + rem % nlocs;
  };

  // per-env state; an env whose input state lies outside [0, ns) is
  // inactive: it draws nothing that matters, updates nothing, and comes out
  // as s' = -1 with a NaN reward sum, as in the twin
  int s_l[kMaxEnvsPerThread], comp_l[kMaxEnvsPerThread];
  int el_l[kMaxEnvsPerThread], age_l[kMaxEnvsPerThread];
  float racc_l[kMaxEnvsPerThread];
  for (int i = 0; i < envs_per_thread; ++i) {
    const long long e = gtid + (long long)i * nthreads;
    const int s = e < B ? s_in[e] : -1;
    s_l[i] = (unsigned)s < (unsigned)(nc * pd) ? s : -1;
    comp_l[i] = el_l[i] = age_l[i] = 0;
    racc_l[i] = 0.f;
  }

  for (int t = 0; t < P.num_steps; ++t) {
    for (int i = 0; i < envs_per_thread; ++i) {
      const long long e = gtid + (long long)i * nthreads;
      if (e >= B || s_l[i] < 0) continue;
      gpt::KernelRNG<NBLK> rng(tape, P.key0, P.key1, e, P.num_steps,
                               P.rows_per_tile, P.n_sites);
      rng.begin_step(t);
      const int s = s_l[i];
      int j = 0;
      // --- act ---
      const int qidx = obs_of(s);
      float va[5], vb[5];
      lookup(s_q, qidx, nsp, va);
      float best_v;
      int greedy;
      if (kDouble) {
        lookup(s_q + nq1, qidx, nsp, vb);
        float vs[5];
#pragma unroll
        for (int a = 0; a < 5; ++a) vs[a] = __fadd_rn(va[a], vb[a]);
        greedy = first_argmax(vs, best_v);
      } else {
        greedy = first_argmax(va, best_v);
      }
      const bool explore = gpt::r24(rng.draw(j++)) < eps24;
      const int ra = gpt::rbits(rng.draw(j++), 5);
      const int a = explore ? ra : greedy;
      const int coin = kDouble ? gpt::rbits(rng.draw(j++), 2) : 0;
      const float q_taken = (kDouble && coin) ? pick5(vb, a) : pick5(va, a);
      int age = age_l[i];
      // Watkins cut before the update (argmax ties count as greedy)
      if (trace && P.watkins_cut && q_taken < best_v) age = 0;

      // --- taxi step: transition, task reset, full reset ---
      int completed = comp_l[i], elapsed = el_l[i];
      const gpt::TaxiStep st = gpt::taxi_step(M, s_cm, s_la, s_vc, rng, j, s,
                                              a, completed, elapsed);

      // --- TD target from the state before the full reset ---
      const int qidx2 = obs_of(st.s_mid);
      float va2[5];
      lookup(s_q, qidx2, nsp, va2);
      float next_v;
      if (kDouble) {
        // select with the updating table, evaluate with the other one
        float vb2[5], mx;
        lookup(s_q + nq1, qidx2, nsp, vb2);
        const int sel_a = first_argmax(va2, mx);
        const int sel_b = first_argmax(vb2, mx);
        next_v = coin == 0 ? pick5(vb2, sel_a) : pick5(va2, sel_b);
      } else {
        float next_max;
        first_argmax(va2, next_max);
        next_v = next_max;
        if (P.expected_sarsa) {
          float sum = va2[0];
#pragma unroll
          for (int k = 1; k < 5; ++k) sum = __fadd_rn(sum, va2[k]);
          next_v = __fadd_rn(__fmul_rn(__fsub_rn(1.0f, P.eps), next_max),
                             __fmul_rn(__fmul_rn(P.eps, 0.2f), sum));
        }
      }
      const float target = __fadd_rn(
          st.rew, __fmul_rn(__fmul_rn(P.gamma, next_v), st.done ? 0.0f : 1.0f));
      const float wd = __fmul_rn(P.lr, __fsub_rn(target, q_taken));
      const int addr = coin * nq1 + a * nsp + qidx;
      if (trace) {
        ring[(long long)(t % L) * B + e] = addr;
        age = min(age + 1, L);
        for (int k = 0; k < age; ++k) {
          const int slot = (t - k + L) % L;
          accumulate(acc, cnt, ring[(long long)slot * B + e],
                     __fmul_rn(P.coefs[k], wd), average);
        }
      } else {
        accumulate(acc, cnt, addr, wd, average);
      }
      if (st.reset) age = 0;  // the trace dies at full resets, not task ones
      s_l[i] = st.s_next;
      comp_l[i] = completed;
      el_l[i] = elapsed;
      age_l[i] = age;
      racc_l[i] = racc_l[i] + st.rew;
    }

    // --- apply this step's update once every env has added to it ---
    grid.sync();
    for (int i = gtid; i < P.nq; i += nthreads) {
      const int c = __ldcg(cnt + i);
      float dq = __double2float_rn(__ll2double_rn(__ldcg(acc + i)) * kUnfix);
      if (average) dq = __fdiv_rn(dq, (float)max(c & ~kOverflow, 1));
      if (c & kOverflow) dq = __int_as_float(0x7fc00000);  // NaN
      q_out[i] = __fadd_rn(s_q[i], dq);
      acc[i] = 0;
      cnt[i] = 0;
    }
    grid.sync();
    for (int i = threadIdx.x; i < P.nq; i += blockDim.x) s_q[i] = __ldcg(q_out + i);
    __syncthreads();
  }
  if (P.num_steps == 0)
    for (int i = gtid; i < P.nq; i += nthreads) q_out[i] = q_in[i];

  for (int i = 0; i < envs_per_thread; ++i) {
    const long long e = gtid + (long long)i * nthreads;
    if (e >= B) break;
    s_out[e] = s_l[i];
    rew_out[e] = s_l[i] < 0 ? __int_as_float(0x7fc00000) : racc_l[i];
  }
}

template <int NBLK, bool kDouble>
int launch(const QParams* P, const void* s_in, void* s_out, void* rew_out,
           const void* q_in, void* q_out, void* acc, void* cnt, void* ring,
           const void* cell_move, const void* loc_at, const void* hansen_cell,
           const void* valid_cells, const void* tape, int* grid_out,
           void* stream) {
  if (P->n_sites > 4 * NBLK || P->trace_len > kMaxTrace || P->trace_len < 1)
    return (int)cudaErrorInvalidValue;
  auto kern = fused_q_kernel<NBLK, kDouble>;
  const int nc = P->rows * P->cols;
  const size_t smem =
      sizeof(float) * P->nq + sizeof(int32_t) * (nc * 6 + P->n_valid);
  int dev = 0, num_sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&num_sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                        smem);
  if (err != cudaSuccess) return (int)err;
  const int need = (P->num_envs + kThreads - 1) / kThreads;
  const int blocks = std::min(need, per_sm * num_sms);
  if (blocks < 1) return (int)cudaErrorInvalidConfiguration;
  const long long per_launch = (long long)blocks * kThreads;
  int ept = (int)((P->num_envs + per_launch - 1) / per_launch);
  if (ept > kMaxEnvsPerThread) return (int)cudaErrorInvalidConfiguration;
  grid_out[0] = blocks;
  grid_out[1] = ept;
  QParams p = *P;
  void* args[] = {&p, &ept, (void*)&s_in, &s_out, &rew_out, &q_in, &q_out,
                  &acc, &cnt, &ring, &cell_move, &loc_at, &hansen_cell,
                  &valid_cells, &tape};
  err = cudaLaunchCooperativeKernel((const void*)kern, dim3(blocks),
                                    dim3(kThreads), args, smem,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fused_q_launch(const QParams* P, const void* s_in, void* s_out,
                              void* rew_out, const void* q_in, void* q_out,
                              void* acc, void* cnt, void* ring,
                              const void* cell_move, const void* loc_at,
                              const void* hansen_cell, const void* valid_cells,
                              const void* tape, int* grid_out, void* stream) {
  return launch<2, false>(P, s_in, s_out, rew_out, q_in, q_out, acc, cnt, ring,
                          cell_move, loc_at, hansen_cell, valid_cells, tape,
                          grid_out, stream);
}

extern "C" int fused_double_q_launch(const QParams* P, const void* s_in,
                                     void* s_out, void* rew_out,
                                     const void* q_in, void* q_out, void* acc,
                                     void* cnt, void* ring,
                                     const void* cell_move, const void* loc_at,
                                     const void* hansen_cell,
                                     const void* valid_cells, const void* tape,
                                     int* grid_out, void* stream) {
  return launch<3, true>(P, s_in, s_out, rew_out, q_in, q_out, acc, cnt, ring,
                         cell_move, loc_at, hansen_cell, valid_cells, tape,
                         grid_out, stream);
}
