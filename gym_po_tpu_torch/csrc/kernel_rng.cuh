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
//    launch geometry, so sites 0-7 give the same words whatever n_sites is.
//    KernelRNG<NBLK> holds NBLK blocks: a compile-time count, so each word
//    is picked by selects and stays in registers (a runtime block count
//    would index a local array dynamically and put it in local memory).
//    It serves n_sites <= 4*NBLK; the launcher checks that.
//    LazyRNG computes a block only where the kernel first needs one of its
//    words, so a kernel that uses some sites only on a rare branch (a
//    respawn, a wall hit) draws nothing there on the other steps; since a
//    draw depends on (seed, e, t, j) alone, skipping or moving a block
//    changes no draw that is used.
#pragma once

#include <stdint.h>

namespace gpt {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;

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

// word w of a block by selects rather than a dynamic register index, which
// would put the block in local memory
__device__ __forceinline__ uint32_t pick4(const U32x4& b, int w) {
  return w == 0 ? b.w[0] : w == 1 ? b.w[1] : w == 2 ? b.w[2] : b.w[3];
}

// tape offset of env e's (tile, row, lane) at site 0, step 0: the tape is
// [n_tiles, n_sites, num_steps, rows_per_tile, 128]
__device__ __forceinline__ long long tape_base_of(long long e, int num_steps,
                                                  int rows_per_tile, int n_sites) {
  const long long R = rows_per_tile;
  const long long g = e / (R * 128), r = (e / 128) % R, lane = e % 128;
  const long long slab = (long long)n_sites * num_steps * R;
  return (g * slab + r) * 128 + lane;
}

// site j's word at step t, from the tape offset tape_base_of gives
__device__ __forceinline__ uint32_t tape_word(const int32_t* tape,
                                              long long tape_base, int j, int t,
                                              int num_steps, int rows_per_tile) {
  const long long row = ((long long)j * num_steps + t) * rows_per_tile;
  return (uint32_t)__ldg(tape + tape_base + row * 128);
}

// Per-thread draw source for one env.  begin_step(t) must precede the
// step's draws; draw(j) returns site j's uint32 for that step.
template <int NBLK>
struct KernelRNG {
  const int32_t* tape;  // null: Philox mode
  long long tape_base;  // tape offset of (tile, row, lane) at site 0, step 0
  int num_steps, rows_per_tile, n_sites;
  uint32_t env, key0, key1;
  int step;
  U32x4 blk[NBLK];

  __device__ __forceinline__ KernelRNG(const int32_t* tape_, uint32_t seed_lo,
                                       uint32_t seed_hi, long long e,
                                       int num_steps_, int rows_per_tile_,
                                       int n_sites_)
      : tape(tape_), num_steps(num_steps_), rows_per_tile(rows_per_tile_),
        n_sites(n_sites_), env((uint32_t)e), key0(seed_lo), key1(seed_hi),
        step(0) {
    tape_base = tape_base_of(e, num_steps_, rows_per_tile_, n_sites_);
  }

  __device__ __forceinline__ void begin_step(int t) {
    step = t;
    if (!tape) {
#pragma unroll
      for (int b = 0; b < NBLK; ++b)
        if (b == 0 || 4 * b < n_sites)
          blk[b] = philox4x32_10(env, (uint32_t)t, (uint32_t)b, 0u, key0, key1);
    }
  }

  __device__ __forceinline__ uint32_t draw(int j) const {
    if (tape) return tape_word(tape, tape_base, j, step, num_steps, rows_per_tile);
    // j < 4 ? block 0 : j < 8 ? block 1 : ..., by selects
    uint32_t u = pick4(blk[NBLK - 1], j & 3);
#pragma unroll
    for (int b = NBLK - 2; b >= 0; --b)
      if (j < 4 * (b + 1)) u = pick4(blk[b], j & 3);
    return u;
  }
};

// Per-thread draw source that computes a Philox block where the kernel asks
// for it: block(b) is block b of the current step (all zero in tape mode),
// draw(j, blk) site j's word, word j % 4 of blk, the block that holds it (the
// tape's word in tape mode).
struct LazyRNG {
  const int32_t* tape;  // null: Philox mode
  long long tape_base;
  int num_steps, rows_per_tile;
  uint32_t env, key0, key1;
  int step;

  __device__ __forceinline__ LazyRNG(const int32_t* tape_, uint32_t seed_lo,
                                     uint32_t seed_hi, long long e,
                                     int num_steps_, int rows_per_tile_,
                                     int n_sites)
      : tape(tape_), num_steps(num_steps_), rows_per_tile(rows_per_tile_),
        env((uint32_t)e), key0(seed_lo), key1(seed_hi), step(0) {
    tape_base = tape_base_of(e, num_steps_, rows_per_tile_, n_sites);
  }
  // with the tape offset given: a launch whose batch is one tile
  // (rows_per_tile * 128 = B) has env e at offset e, and a kernel that makes
  // its RNG inside a loop then divides nothing there
  __device__ __forceinline__ LazyRNG(const int32_t* tape_, long long tape_base_,
                                     uint32_t seed_lo, uint32_t seed_hi,
                                     long long e, int num_steps_,
                                     int rows_per_tile_)
      : tape(tape_), tape_base(tape_base_), num_steps(num_steps_),
        rows_per_tile(rows_per_tile_), env((uint32_t)e), key0(seed_lo),
        key1(seed_hi), step(0) {}

  __device__ __forceinline__ void begin_step(int t) { step = t; }

  __device__ __forceinline__ U32x4 block(int b) const {
    if (tape) return U32x4{};
    return philox4x32_10(env, (uint32_t)step, (uint32_t)b, 0u, key0, key1);
  }

  __device__ __forceinline__ uint32_t draw(int j, const U32x4& blk) const {
    if (tape) return tape_word(tape, tape_base, j, step, num_steps, rows_per_tile);
    return pick4(blk, j & 3);
  }
};

// uniform int in [0, n): u % n (bias <= n/2^32)
__device__ __forceinline__ int rbits(uint32_t u, int n) {
  return (int)(u % (uint32_t)n);
}
// Division by an invariant divisor 1 <= n < 2^32, exact for every uint32 u,
// as one 32x32->64 multiply-add and a shift:
//   u / n = hi32(mul * u + add) >> sh.
// For n not a power of two, sh = floor(log2 n) and mul is the 32-bit
// round-up multiplier ceil(2^(32+sh) / n) with add = 0 where it is exact
// for every u (Granlund & Montgomery, "Division by invariant integers using
// multiplication", PLDI 1994, thm. 4.2: error mul * n - 2^(32+sh) at most
// 2^sh); for the other divisors, which would need its 33-bit form, the
// round-down multiplier floor(2^(32+sh) / n) with the fix-up add = mul,
// i.e. mul * (u + 1) (Robison, "N-bit unsigned division via N-bit
// multiply-add", ARITH 2005: one of the two is always exact).  A power of
// two 2^k takes mul = 2^(32-k) (k >= 1), and n = 1 takes mul = add =
// 2^32 - 1.  nvcc makes the quotient an IMAD.HI.U32 with the 64-bit addend,
// an add and a shift, and the remainder u + q * (2^32 - n) one IMAD: five
// instructions where a runtime u % n takes about twenty, with a float
// reciprocal on the quarter-rate unit.  The constants are computed on the
// host (ops/kernel_rng.py::UDiv.of, whose twin udivmod spells out the same
// formula) and handed to a kernel in its parameters.
struct UDiv {
  uint32_t mul, sh;
  uint64_t add;  // 0 or mul: the fix-up
  uint32_t n, neg;  // neg = 2^32 - n (mod 2^32)
};

__device__ __forceinline__ uint32_t udiv(uint32_t u, const UDiv& d) {
  return (uint32_t)(((uint64_t)d.mul * u + d.add) >> 32) >> d.sh;  // < 2^64
}
__device__ __forceinline__ uint32_t umod(uint32_t u, const UDiv& d) {
  return u + udiv(u, d) * d.neg;  // u - q * n, mod 2^32
}
// uniform int in [0, n) by an invariant divisor: u % n, as rbits(u, n)
__device__ __forceinline__ int rbits(uint32_t u, const UDiv& d) {
  return (int)umod(u, d);
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
