// Pieces shared by the port's tabular trainer kernels (device and launch
// side): fused_qlearning.cu (Q, Q(lambda) and double Q on Taxi; Q and
// Q(lambda) on ROOMS) and fused_ac.cu (actor-critic on ROOMS).
//
//  * Per-action table lookups, the select of one action's value and the
//    first argmax, over a compile-time action count N, so every value stays
//    in a register.  A table keeps entry (obs, a) at flat index
//    a * nsp + obs; the TPU's [nb, 128] lane banks are a reshape of it.
//  * Order-independent update sums: each term is added as an int64 fixed
//    point at scale 2^32 (round half to even) and counted as int32, so a
//    sum does not depend on the order of the atomics and equals the twins'
//    index_add_ bit for bit.  The apply converts once, (float)(sum * 2^-32),
//    then divides by max(count, 1) in f32 when averaging.  A term with
//    |w| > 2^6 (or NaN) is past the fixed point's range: it flags its entry,
//    which becomes NaN, so a diverging run goes non-finite as an f32 sum
//    would.  The twins are apply_update in ops/fused_qlearning.py and the
//    actor-critic's in ops/fused_ac.py.
//  * The geometry of a persistent cooperative launch: as many blocks as are
//    co-resident (occupancy API), each thread owning up to
//    kMaxEnvsPerThread envs for all K steps.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace gpt {

constexpr int kTrainerThreads = 256;
constexpr int kMaxEnvsPerThread = 8;
constexpr double kFix = 4294967296.0;              // 2^32
constexpr double kUnfix = 2.3283064365386963e-10;  // 2^-32
// |w| <= 2^6 per term and at most 2^24 terms an entry per step (the
// wrappers check it) keep the int64 sum below 2^62; counts stay below 2^24
constexpr float kMaxTerm = 64.0f;
constexpr int kOverflow = 1 << 30;

// v[a] by selects rather than a dynamic register index
template <int N>
__device__ __forceinline__ float pick(const float (&v)[N], int a) {
  float out = v[0];
#pragma unroll
  for (int i = 1; i < N; ++i) out = a == i ? v[i] : out;
  return out;
}

// first maximum (strict >), as _first_argmax in the JAX kernels
template <int N>
__device__ __forceinline__ int first_argmax(const float (&v)[N], float& best) {
  int best_a = 0;
  best = v[0];
#pragma unroll
  for (int a = 1; a < N; ++a)
    if (v[a] > best) {
      best = v[a];
      best_a = a;
    }
  return best_a;
}

template <int N>
__device__ __forceinline__ void lookup(const float* q, int idx, int nsp,
                                       float (&v)[N]) {
#pragma unroll
  for (int a = 0; a < N; ++a) v[a] = q[a * nsp + idx];
}

// adds w to acc[addr] in fixed point; false, adding nothing, past its range
__device__ __forceinline__ bool fix_add(long long* acc, int addr, float w) {
  if (!(fabsf(w) <= kMaxTerm)) return false;  // also NaN
  const long long fx = __double2ll_rn((double)w * kFix);
  atomicAdd(reinterpret_cast<unsigned long long*>(acc + addr),
            static_cast<unsigned long long>(fx));
  return true;
}

// one term: cnt[addr] counts it (when averaging), or flags it with
// kOverflow when it is out of range
__device__ __forceinline__ void accumulate(long long* acc, int* cnt, int addr,
                                           float w, bool average) {
  if (!fix_add(acc, addr, w)) {
    atomicOr(cnt + addr, kOverflow);
    return;
  }
  if (average) atomicAdd(cnt + addr, 1);
}

// an entry's update from its sum and count word
__device__ __forceinline__ float fix_delta(long long sum, int c, bool average) {
  float dq = __double2float_rn(__ll2double_rn(sum) * kUnfix);
  if (average) dq = __fdiv_rn(dq, (float)max(c & ~kOverflow, 1));
  if (c & kOverflow) dq = __int_as_float(0x7fc00000);  // NaN
  return dq;
}

// Blocks (all co-resident) and envs per thread of a persistent cooperative
// launch of kern over num_envs envs with smem bytes of dynamic shared memory.
template <class Kernel>
cudaError_t coop_geometry(Kernel kern, size_t smem, long long num_envs,
                          int* blocks, int* envs_per_thread) {
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
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        kTrainerThreads, smem);
  if (err != cudaSuccess) return err;
  const long long need = (num_envs + kTrainerThreads - 1) / kTrainerThreads;
  *blocks = (int)std::min<long long>(need, (long long)per_sm * num_sms);
  if (*blocks < 1) return cudaErrorInvalidConfiguration;
  const long long per_launch = (long long)*blocks * kTrainerThreads;
  *envs_per_thread = (int)((num_envs + per_launch - 1) / per_launch);
  if (*envs_per_thread > kMaxEnvsPerThread) return cudaErrorInvalidConfiguration;
  return cudaSuccess;
}

}  // namespace gpt
