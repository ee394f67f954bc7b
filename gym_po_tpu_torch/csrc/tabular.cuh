// Pieces shared by the port's tabular trainer kernels (device and launch
// side): fused_qlearning.cu (Q, Q(lambda) and double Q on Taxi; Q and
// Q(lambda) on ROOMS; Q on MultistoryFourRooms), fused_ac.cu (actor-critic
// on ROOMS) and fused_q_crooms.cu (Q on CRooms).
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
//  * Per-block update sums with one grid barrier per step (BlockSums): each
//    step's terms go first into a slab in the block's shared memory, the
//    block then adds each word it touched into one of three global
//    accumulators used in rotation, and after the one barrier every block
//    applies the finished sums to its own copy of the table.  Where the
//    slab does not fit beside a launch that takes the batch, the terms go
//    straight into the step's global accumulator (accumulate), with the
//    same rotation, barrier and apply.  Every one-step trainer, Q(lambda),
//    the actor-critic and the CRooms Q trainer run this protocol.
//  * The geometry of a persistent cooperative launch: as many blocks as are
//    co-resident (occupancy API), each thread owning up to
//    kMaxEnvsPerThread envs for all K steps; coop_geometry_room also makes
//    room in shared memory for an optional piece (the Q(lambda) ring, the
//    one-step trainers' slab) where a launch with it still takes the
//    batch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace gpt {

constexpr int kTrainerThreads = 256;
constexpr int kMaxEnvsPerThread = 8;
// blocks per SM a trainer must keep co-resident for B = 2^20 to launch:
// 2^20 envs / (8 per thread * 256 threads * 132 SMs) = 3.88 (the launch
// bounds of the kernels whose registers would otherwise exceed 64)
constexpr int kMinBlocksPerSM = 4;
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

// one term straight into a global accumulator: cnt[addr] counts it (when
// averaging), or flags it with kOverflow when it is out of range
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

// Observations rounded up to 4, the stride of a slab's rows: every slab and
// accumulator is then a whole number of 16-byte words.
__host__ __device__ __forceinline__ int slab_stride(int n_obs) {
  return (n_obs + 3) & ~3;
}

// The update sums of one trainer step, summed per block in shared memory
// (on_chip) or not (each term one global atomic), and across blocks in one
// of three global accumulators.
//
// A count word o carries kPer sums, sum j at j * n + o: kPer = 1 gives every
// table entry its own count (Q, Q(lambda)), kPer = A + 1 gives an
// observation one count for its A + 1 entries (the actor-critic).  Global
// buffer b (the step's t % 3) holds kPer * n int64 sums and n int32 counts.
// Step t adds into buffer t % 3; after the step's one grid barrier every
// block reads it, and a slice of every block clears buffer (t + 2) % 3,
// which every block finished reading before that barrier and which no block
// adds to before the next one.  The caller zeroes buffers 0 and 1.
//
// The block's 64-bit adds are two native 32-bit shared-memory atomics on
// the word's halves (the low word, then the high word plus the low word's
// carry): the sum of the halves is the int64 sum modulo 2^64, which the
// range guard keeps exact.  A term past the range sets kOverflow in the
// global count word directly: a flag summed over blocks would carry into
// the count.  Off chip (kPer = 1 only) a term is accumulate()'s two global
// atomics into step t's buffer, counted whether or not the trainer
// averages: the count word is what marks a word as touched for apply.
template <int kPer>
struct BlockSums {
  unsigned long long* s_sum;  // [kPer * n] shared, when on chip
  int* s_cnt;                 // [n] shared, when on chip
  long long* g_sum;           // [3][kPer * n] global
  int* g_cnt;                 // [3][n] global
  int n;
  bool on_chip;

  static __host__ __device__ size_t smem_bytes(int n) {
    return (size_t)n * (kPer * sizeof(unsigned long long) + sizeof(int));
  }
  // carves the slab out of shared memory at smem (8-byte aligned), or
  // takes none of it when not on chip
  __device__ BlockSums(void* smem, long long* g_sum_, int* g_cnt_, int n_,
                       bool on_chip_ = true)
      : s_sum(static_cast<unsigned long long*>(smem)),
        s_cnt(reinterpret_cast<int*>(s_sum + (on_chip_ ? (long long)kPer * n_ : 0))),
        g_sum(g_sum_), g_cnt(g_cnt_), n(n_), on_chip(on_chip_) {
    if (!on_chip) return;
    for (int i = threadIdx.x; i < kPer * n; i += blockDim.x) s_sum[i] = 0;
    for (int i = threadIdx.x; i < n; i += blockDim.x) s_cnt[i] = 0;
  }
  __device__ void* end() const { return on_chip ? s_cnt + n : s_cnt; }
  __device__ long long* sums(int t) const {
    return g_sum + (long long)(t % 3) * kPer * n;
  }
  __device__ int* counts(int t) const { return g_cnt + (t % 3) * n; }

  // w into sum j of count word o; false, adding nothing, past the range
  __device__ __forceinline__ bool add(int j, int o, float w) const {
    if (!(fabsf(w) <= kMaxTerm)) return false;  // also NaN
    const unsigned long long fx =
        static_cast<unsigned long long>(__double2ll_rn((double)w * kFix));
    unsigned int* h = reinterpret_cast<unsigned int*>(s_sum + j * n + o);
    const unsigned int lo = (unsigned int)fx, hi = (unsigned int)(fx >> 32);
    const unsigned int carry = atomicAdd(h, lo) + lo < lo;
    if (hi + carry) atomicAdd(h + 1, hi + carry);
    return true;
  }
  __device__ __forceinline__ void count(int o) const { atomicAdd(s_cnt + o, 1); }
  __device__ __forceinline__ void flag(int t, int o) const {
    atomicOr(counts(t) + o, kOverflow);
  }
  // one term with its own count word (kPer = 1)
  __device__ __forceinline__ void term(int t, int c, float w) const {
    if (!on_chip) accumulate(sums(t), counts(t), c, w, true);
    else if (add(0, c, w)) count(c);
    else flag(t, c);
  }

  // After a __syncthreads(): every count word the block touched, and its
  // kPer sums, into step t's accumulator, one global atomic each; the slab
  // is left zero.  Nothing to do off chip.
  __device__ void flush(int t) const {
    if (!on_chip) return;
    long long* g = sums(t);
    int* gc = counts(t);
    for (int o = threadIdx.x; o < n; o += blockDim.x) {
      const int k = s_cnt[o];
      if (!k) continue;
      atomicAdd(gc + o, k);
      s_cnt[o] = 0;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        atomicAdd(reinterpret_cast<unsigned long long*>(g + j * n + o),
                  s_sum[j * n + o]);
        s_sum[j * n + o] = 0;
      }
    }
  }
  // After the grid barrier: for every count word o that step t touched,
  // fn(o, count word, its sum) with kPer = 1, fn(o, count word, the step's
  // sums) otherwise (read past L1: other SMs added them).  With kPer = 1 a
  // thread reads 4 count words and their 4 sums with three independent
  // 16-byte loads (n is a multiple of 4, slab_stride's), rather than a sum
  // after each count it finds set: one L2 round trip per 4 words.
  template <class F>
  __device__ void apply(int t, F&& fn) const {
    if constexpr (kPer == 1) {
      const int4* gc = reinterpret_cast<const int4*>(counts(t));
      const longlong2* g = reinterpret_cast<const longlong2*>(sums(t));
      for (int o = threadIdx.x; o < n / 4; o += blockDim.x) {
        const int4 k = __ldcg(gc + o);
        const longlong2 s0 = __ldcg(g + 2 * o), s1 = __ldcg(g + 2 * o + 1);
        if (k.x) fn(4 * o, k.x, s0.x);
        if (k.y) fn(4 * o + 1, k.y, s0.y);
        if (k.z) fn(4 * o + 2, k.z, s1.x);
        if (k.w) fn(4 * o + 3, k.w, s1.y);
      }
    } else {
      const long long* g = sums(t);
      const int* gc = counts(t);
      for (int o = threadIdx.x; o < n; o += blockDim.x) {
        const int k = __ldcg(gc + o);
        if (k) fn(o, k, g);
      }
    }
  }
  // After the grid barrier: this thread's slice of the buffer of step t + 2
  __device__ void clear_ahead(int t) const {
    long long* g = sums(t + 2);
    int* gc = counts(t + 2);
    const int nthreads = gridDim.x * blockDim.x;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < kPer * n; i += nthreads) {
      g[i] = 0;
      if (i < n) gc[i] = 0;
    }
  }
};

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

// The geometry of a launch that keeps extra_bytes of shared memory beside
// smem_base for an optional piece, where such a launch gives each thread at
// most max_envs envs: *taken = 1.  Otherwise (more envs than that, or no
// room) *taken = 0 and the geometry is that of smem_base alone: the caller
// keeps the piece in global memory.  *smem is the dynamic shared memory to
// launch with.  The Q(lambda) ring (one slot per thread, max_envs = 1) and
// the one-step trainers' slab (max_envs = kMaxEnvsPerThread) choose so.
template <class Kernel>
cudaError_t coop_geometry_room(Kernel kern, size_t smem_base, size_t extra_bytes,
                               int max_envs, long long num_envs, int* blocks,
                               int* envs_per_thread, int* taken, size_t* smem) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 dev);
  if (err != cudaSuccess) return err;
  const size_t bytes = smem_base + extra_bytes;
  if (bytes <= (size_t)optin) {
    err = coop_geometry(kern, bytes, num_envs, blocks, envs_per_thread);
    if (err == cudaSuccess && *envs_per_thread <= max_envs) {
      *taken = 1;
      *smem = bytes;
      return cudaSuccess;
    }
    if (err != cudaSuccess && err != cudaErrorInvalidConfiguration) return err;
  }
  *taken = 0;
  *smem = smem_base;
  return coop_geometry(kern, smem_base, num_envs, blocks, envs_per_thread);
}

}  // namespace gpt
