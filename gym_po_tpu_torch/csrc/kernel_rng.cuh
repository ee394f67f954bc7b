// Draw contract of the port's kernels (device side).
//
// Replaces the draw helpers of the TPU kernels,
// gym_po_tpu/ops/kernel_rng.py::KernelRNG.  Its plain PyTorch twin is
// gym_po_tpu_torch/ops/kernel_rng.py, which spells out the same algorithm
// line for line; the two agree bit for bit.
//
// A kernel draws one uint32 per env at each numbered site of its loop body,
// every step.  Two modes:
//  * tape: read the JAX package's int32 tape.  For env e in tile
//    g = e / (R*128), site j at step t sits at row
//    g*slab + (j*K + t)*R + (e/128) % R, column e % 128, with
//    slab = n_sites*K*R.
//  * Philox4x32-10 (Salmon et al., SC'11, written out here rather than taken
//    from curand): key = (seed lo, seed hi), counter = (e, t, j/4, 0), site j
//    takes word j%4.  A draw depends on (seed, e, t, j) alone, not on the
//    launch geometry.
#pragma once

#include <stdint.h>

namespace gpt {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;
constexpr int kMaxSites = 8;  // two Philox blocks per env per step

struct U32x4 {
  uint32_t w[4];
};

__device__ __forceinline__ U32x4 philox4x32_10(uint32_t c0, uint32_t c1,
                                               uint32_t c2, uint32_t c3,
                                               uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    if (i) {
      k0 += kPhiloxW0;
      k1 += kPhiloxW1;
    }
    const uint32_t lo0 = kPhiloxM0 * c0, hi0 = __umulhi(kPhiloxM0, c0);
    const uint32_t lo1 = kPhiloxM1 * c2, hi1 = __umulhi(kPhiloxM1, c2);
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  U32x4 out = {{c0, c1, c2, c3}};
  return out;
}

// Per-thread draw source for one env.  begin_step(t) must precede the
// step's draws; draw(j) returns site j's uint32 for that step.
// word w of a block by selects rather than a dynamic register index, which
// would put the block in local memory
__device__ __forceinline__ uint32_t pick4(const U32x4& b, int w) {
  return w == 0 ? b.w[0] : w == 1 ? b.w[1] : w == 2 ? b.w[2] : b.w[3];
}

struct KernelRNG {
  const int32_t* tape;  // null: Philox mode
  long long tape_base;  // tape offset of (tile, row, lane) at site 0, step 0
  int num_steps, rows_per_tile, n_sites;
  uint32_t env, key0, key1;
  int step;
  U32x4 blk[2];

  __device__ __forceinline__ KernelRNG(const int32_t* tape_, uint32_t seed_lo,
                                       uint32_t seed_hi, long long e,
                                       int num_steps_, int rows_per_tile_,
                                       int n_sites_)
      : tape(tape_), num_steps(num_steps_), rows_per_tile(rows_per_tile_),
        n_sites(n_sites_), env((uint32_t)e), key0(seed_lo), key1(seed_hi),
        step(0) {
    const long long R = rows_per_tile_;
    const long long g = e / (R * 128), r = (e / 128) % R, lane = e % 128;
    const long long slab = (long long)n_sites_ * num_steps_ * R;
    tape_base = (g * slab + r) * 128 + lane;
  }

  __device__ __forceinline__ void begin_step(int t) {
    step = t;
    if (!tape) {
      blk[0] = philox4x32_10(env, (uint32_t)t, 0u, 0u, key0, key1);
      if (n_sites > 4)
        blk[1] = philox4x32_10(env, (uint32_t)t, 1u, 0u, key0, key1);
    }
  }

  __device__ __forceinline__ uint32_t draw(int j) const {
    if (tape) {
      const long long row = ((long long)j * num_steps + step) * rows_per_tile;
      return (uint32_t)__ldg(tape + tape_base + row * 128);
    }
    return j < 4 ? pick4(blk[0], j & 3) : pick4(blk[1], j & 3);
  }
};

// uniform int in [0, n): u % n (bias <= n/2^32)
__device__ __forceinline__ int rbits(uint32_t u, int n) {
  return (int)(u % (uint32_t)n);
}
// uniform int in [0, 2^24)
__device__ __forceinline__ int r24(uint32_t u) { return (int)(u >> 8); }
// exact f32 in [0, 1) from the top 24 bits
__device__ __forceinline__ float runiform(uint32_t u) {
  return (float)(u >> 8) * 5.9604644775390625e-08f;  // 2^-24
}
// Box-Muller standard normal from two draws
__device__ __forceinline__ float rnormal(uint32_t u1, uint32_t u2) {
  const float a = fmaxf(runiform(u1), 1e-12f);
  return sqrtf(-2.0f * logf(a)) * cosf(6.2831854820251465f * runiform(u2));
}

}  // namespace gpt
