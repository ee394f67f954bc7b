// The articulated ant's constrained forward dynamics for Hopper (sm_90a):
// three kernels.
//
// Replaces no TPU kernel.  It is the port of the JAX package's default
// pipeline="scalar" forward (gym_po_tpu/physics/engine.py:87-97), which
// XLA lowers on the TPU to straight-line [B]-vector code: every per-env
// quantity a scalar, every structural zero dropped at trace time.
//
//   ant_smooth  smooth_forward_s (gym_po_tpu/physics/dynamics.py:553): FK,
//               CoMs, world inertias and dof axes, the mass matrix over each
//               body's active dofs, the bias force (RNEA with zero qacc),
//               actuation, damping, and the 14x14 Cholesky solve
//               (chol_solve_s, gym_po_tpu/physics/linalg.py).  One warp
//               per env.
//   ant_rows    contact_candidates_s + constraint_rows_scalar
//               (gym_po_tpu/physics/contact.py:422, :568): 8 joint-limit
//               rows, 25 floor candidates, per wall slot the torso
//               sphere-box and the 12 capsules' capsule-box triples, then
//               4 pyramid rows per candidate.  One thread per (unit, env).
//   ant_newton  solve_constraints_newton_s (contact.py:915): `iters` Newton
//               iterations over the active rows (gradient, Hessian, 14x14
//               Cholesky, `ls_iters` bisections of the line search's
//               derivative on [0, 2]).  One warp per env.
//
// The plain PyTorch twins are in gym_po_tpu_torch/ops/ant_forward.py (the
// port's batched array engine, laid out as the kernels lay out their
// buffers).
//
// Layout.  The model's constants are one buffer of T (the M_* offsets
// below, packed by ops/ant_forward.py::pack_model); each row's static dof
// support is a CSR table of int32 (row_ptr [ne + 1], row_dof [nnz]) and the
// mass matrix's a bitmask per row (m_rows [NV]); ant_rows' units are a
// table of UNIT_W int32 each (ops/ant_forward.py::units); ant_smooth reads
// the tree as an int32 table (the ST_* offsets, ops/ant_forward.py::
// smooth_table: each body's level, parent and hinge, each dof's anchor,
// bodies and actuator, the bodies of each packed entry of M).  Everything
// passed between kernels is env-minor, [k, B]: the kinematics the rows
// need (SKin: body xpos and xmat, dof_u, dof_p), M, qacc_smooth, each
// row's values over its support ([nnz, B]), aref, r and the active flags
// ([ne, B]).
//
// What bounds them on this card: neither bytes nor FLOPs but how many
// warps are in flight and how long each waits on its own dependent
// arithmetic.  At the envs' batch (B = 4,096) one env a thread is 128
// warps, about one an SM.  So:
//
// - ant_smooth runs one warp per env, WarpEnvs (8 at f32, 4 at f64)
//   consecutive envs a block.  The block copies its envs' qpos, qvel and
//   ctrl rows (contiguous runs) and the tree's table into shared memory;
//   each warp runs FK a tree level at a time (a lane per body of the level,
//   4 dependent levels in place of 12 bodies in series), the CoMs, world
//   inertias and each (body, rotation dof) pair's Jacobian column and
//   I^w u a lane each, the packed lower triangle of M a lane per entry
//   (dealt to the lanes heaviest first, each summed over its bodies only:
//   78 entries of 105 hold any), the bias force's velocities, frame rates, wrenches and
//   projection a lane per body or dof, and the solve by chol_solve_warp
//   (shared with ant_newton); then the block writes its outputs from shared
//   memory with the env index fastest.  Every per-env array lives in shared
//   memory (SE_SIZE values an env, static) or in registers at fixed
//   indices: no stack frame.
// - ant_rows runs a unit of work per thread: a limit row, a floor sphere
//   or capsule end, a slot's torso sphere-box, or a capsule's three
//   capsule-box slots in one slot (one pair of bisections).  blockIdx.y is
//   the unit, the env index is fastest within a warp: a warp runs one unit
//   over 32 consecutive envs, uniform, and its [k, B] reads of the
//   kinematics and writes of the rows coalesce.  A thread reads only its
//   body's frame and hinges (8 dof slots, not the 84 values of every dof),
//   so it keeps them in registers.  59 units on the tag arena, 98 on
//   heaven-hell: at B = 4,096 thousands of warps.
// - ant_newton runs one warp per env, WarpEnvs (8 at f32, 4 at f64)
//   consecutive envs a block.  The block first copies its envs' M, qs,
//   warm start and active flags into shared memory with the env index
//   fastest (a row of [k, B] is 8 consecutive values, one 32-byte sector
//   at f32).  Each warp then compacts its env's active rows (a ballot per
//   32 rows, in row order; no cap on their count) and keeps, for up to
//   ROWS_CAP of them, the rows densified over the 14 dofs in shared memory
//   (dof-major, an odd stride) and aref, D = 1/R, slack and slope in
//   registers, lane l holding rows l, l + 32, l + 64.  More active rows than
//   that (chip_smoke.py's contact states have at most 37 on the tag arena,
//   82 on heaven-hell; a test forces all ne) are taken chunk by chunk from
//   the rows' own buffers in every pass, in the same order.  No iteration reads global scratch.  M and H are packed lower
//   triangles in shared memory, each lane owning entries lane + 32 m: the
//   Hessian is accumulated per entry over the active rows in row order
//   (each row's weight and force broadcast by a shuffle), the Cholesky
//   factor runs column by column (the pivot read by all lanes, the column
//   and the trailing update spread over the lanes' entries) with the
//   forward substitution carried along, then the backward one row by row,
//   by the pivots' reciprocals.  The gradient is a lane per dof; the
//   line search's sum over rows a fixed-order butterfly (__shfl_xor_sync),
//   which leaves the same bits on every lane, so all lanes take the same
//   bisection branch.  The solve has no atomic: one launch is deterministic.
//   With a counter (rows_count, non-null while the port's spans are on)
//   the block adds its envs' active rows to it: each thread its own flags,
//   a warp sum, then one atomic add a block.  That build is its own
//   instance (COUNT); without a counter the kernel has no trace of it.
//   At f32 ptxas gives it about 100 registers a thread and a block takes
//   about 60 KB of shared memory, so 2 blocks (16 warps) fit an SM and
//   B = 4,096 runs in two waves, each warp bound by its chain of dependent
//   steps (the factor's and the substitutions' 28 column steps).
//
// No --use_fast_math: division, sqrt, sin and cos are IEEE/accurate.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ant {

constexpr int NB = 13, NV = 14, NQ = 15, NJ = 8, NU = 8, NG = 13;
constexpr int NCAP = NG - 1;
constexpr int NFLOOR = 1 + 2 * NCAP;      // torso sphere + both ends of each capsule
constexpr int NSLOT_CAND = 1 + 3 * NCAP;  // per wall slot: torso + 3 per capsule
constexpr int NLIM = NJ;
constexpr int NSLOTW = 13;  // per slot: lo+, hi+, lo-, hi- (3 each), axis

// SKin, [240, B]: body xpos, body xmat, dof_u, dof_p
constexpr int SK_XPOS = 0, SK_XMAT = SK_XPOS + 3 * NB, SK_DOFU = SK_XMAT + 9 * NB,
              SK_DOFP = SK_DOFU + 3 * NV;

// The model buffer: ops/ant_forward.py::MODEL_FIELDS in the same order.
enum : int {
  M_PARENT = 0,
  M_BODY_POS = M_PARENT + NB,
  M_BODY_MASS = M_BODY_POS + 3 * NB,
  M_BODY_IPOS = M_BODY_MASS + NB,
  M_BODY_INERTIA = M_BODY_IPOS + 3 * NB,
  M_BODY_JNT = M_BODY_INERTIA + 9 * NB,
  M_DOF_MASK = M_BODY_JNT + NB,
  M_JNT_BODY = M_DOF_MASK + NB * NV,
  M_JNT_AXIS = M_JNT_BODY + NJ,
  M_JNT_DOF = M_JNT_AXIS + 3 * NJ,
  M_JNT_QPOS = M_JNT_DOF + NJ,
  M_JNT_RANGE = M_JNT_QPOS + NJ,
  M_ARMATURE = M_JNT_RANGE + 2 * NJ,
  M_DAMPING = M_ARMATURE + NV,
  M_ACT_DOF = M_DAMPING + NV,
  M_GEOM_BODY = M_ACT_DOF + NU,
  M_GEOM_POS = M_GEOM_BODY + NG,
  M_GEOM_AXIS = M_GEOM_POS + 3 * NG,
  M_GEOM_R = M_GEOM_AXIS + 3 * NG,
  M_GEOM_H = M_GEOM_R + NG,
  M_BODY_INVW = M_GEOM_H + NG,
  M_DOF_INVW = M_BODY_INVW + NB,
  // scalars: gear, gravity, 2 * margin, mu, K, B (solref), solimp's d0,
  // dmax - d0, width, mid, power and its sigmoid's a and b, 2 mu^2 (1 + mu^2)
  M_GEAR = M_DOF_INVW + NV,
  M_GRAVITY,
  M_MARGIN2,
  M_MU,
  M_K,
  M_B,
  M_D0,
  M_DSPAN,
  M_WIDTH,
  M_MID,
  M_POWER,
  M_IMP_A,
  M_IMP_B,
  M_PYR,
  M_SLOTS  // NSLOTW values per wall slot
};

constexpr double BIG = 1e9;  // the distance of a capsule slot that holds no contact
constexpr double MINIMP = 1e-4, MAXIMP = 0.9999;

__device__ __forceinline__ float tsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double tsqrt(double x) { return sqrt(x); }
// sin and cos of a hinge's half angle x as sincospi(x / pi): its argument
// reduction is exact, so the kernel carries no Payne-Hanek slow path
// (sinf/cosf's and sin/cos's scratch array, the only stack frame they give
// ant_smooth).  At f32, x / pi is formed in f64, one rounding.
__device__ __forceinline__ void half_sincos(float x, float& s, float& c) {
  sincospif((float)((double)x * 0.318309886183790671538), &s, &c);
}
__device__ __forceinline__ void half_sincos(double x, double& s, double& c) {
  sincospi(x * 0.318309886183790671538, &s, &c);
}
__device__ __forceinline__ float tpow(float x, float p) { return powf(x, p); }
__device__ __forceinline__ double tpow(double x, double p) { return pow(x, p); }
template <typename T>
__device__ __forceinline__ T tabs(T x) { return x < T(0) ? -x : x; }
template <typename T>
__device__ __forceinline__ T tmax(T a, T b) { return a > b ? a : b; }
template <typename T>
__device__ __forceinline__ T tmin(T a, T b) { return a < b ? a : b; }
// jnp.clip(x, lo, hi) == min(max(x, lo), hi)
template <typename T>
__device__ __forceinline__ T tclip(T x, T lo, T hi) { return tmin(tmax(x, lo), hi); }

template <typename T>
__device__ __forceinline__ int as_int(T x) { return (int)x; }

template <typename T>
__device__ __forceinline__ T dot3(const T* a, const T* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

template <typename T>
__device__ __forceinline__ void cross3(const T* a, const T* b, T* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

// R @ v, R row-major 3x3
template <typename T>
__device__ __forceinline__ void mat_vec(const T* R, const T* v, T* out) {
  for (int i = 0; i < 3; ++i) out[i] = R[3 * i] * v[0] + R[3 * i + 1] * v[1] + R[3 * i + 2] * v[2];
}

template <typename T>
__device__ __forceinline__ void quat_to_mat(const T* q, T* R) {
  const T w = q[0], x = q[1], y = q[2], z = q[3];
  R[0] = T(1) - T(2) * (y * y + z * z);
  R[1] = T(2) * (x * y - w * z);
  R[2] = T(2) * (x * z + w * y);
  R[3] = T(2) * (x * y + w * z);
  R[4] = T(1) - T(2) * (x * x + z * z);
  R[5] = T(2) * (y * z - w * x);
  R[6] = T(2) * (x * z - w * y);
  R[7] = T(2) * (y * z + w * x);
  R[8] = T(1) - T(2) * (x * x + y * y);
}

template <typename T>
__device__ __forceinline__ void quat_mul(const T* q, const T* p, T* out) {
  out[0] = q[0] * p[0] - q[1] * p[1] - q[2] * p[2] - q[3] * p[3];
  out[1] = q[0] * p[1] + q[1] * p[0] + q[2] * p[3] - q[3] * p[2];
  out[2] = q[0] * p[2] - q[1] * p[3] + q[2] * p[0] + q[3] * p[1];
  out[3] = q[0] * p[3] + q[1] * p[2] - q[2] * p[1] + q[3] * p[0];
}

// MuJoCo's solimp sigmoid d(x) of a violation (_impedance)
template <typename T>
__device__ T impedance(const T* mdl, T violation) {
  const T power = mdl[M_POWER], mid = mdl[M_MID];
  const T x = tclip(tabs(violation) / mdl[M_WIDTH], T(0), T(1));
  T y;
  if (x <= mid) {
    y = mdl[M_IMP_A] * (power == T(2) ? x * x : tpow(x, power));
  } else {
    const T u = T(1) - x;
    y = T(1) - mdl[M_IMP_B] * (power == T(2) ? u * u : tpow(u, power));
  }
  return tclip(mdl[M_D0] + y * mdl[M_DSPAN], T(MINIMP), T(MAXIMP));
}

// ---------------------------------------------------------------- warp helpers

// ant_smooth and ant_newton run one warp per env, WarpEnvs<T>::value warps
// (consecutive envs) a block.
constexpr unsigned FULL = 0xffffffffu;
constexpr int NL = NV * (NV + 1) / 2;    // a symmetric matrix's packed lower triangle
constexpr int H_SLOTS = (NL + 31) / 32;  // a lane's entries of it: lane + 32 m
template <typename T>
struct WarpEnvs {
  static constexpr int value = sizeof(T) == 4 ? 8 : 4;
};

// the packed lower triangle, column after column: entry (i, k), i >= k
__host__ __device__ constexpr int col_off(int k) { return k * NV - k * (k - 1) / 2; }
__host__ __device__ constexpr int low(int i, int k) { return col_off(k) + i - k; }

__device__ __forceinline__ void low_pair(int t, int& i, int& k) {
  k = 0;
  while (t >= NV - k) {
    t -= NV - k;
    ++k;
  }
  i = k + t;
}

// the lane's entries of the packed lower triangle (tk -1: none)
__device__ __forceinline__ void lane_entries(int lane, int* ti, int* tk) {
#pragma unroll
  for (int m = 0; m < H_SLOTS; ++m) {
    ti[m] = tk[m] = -1;
    if (lane + 32 * m < NL) low_pair(lane + 32 * m, ti[m], tk[m]);
  }
}

// a sum over the warp by a butterfly: every lane ends with the same bits
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = v + __shfl_xor_sync(FULL, v, o);
  return v;
}

// chol_solve_s across the warp: H x = x.  H (packed; the lane's entries
// lane + 32 m at (ti, tk)) becomes its Cholesky factor L, right-looking:
// each entry takes its column's updates in the order k = 0, 1, ... as
// chol_factor_s does, and L y = x is carried along, column by column;
// then L^T x = y, row by row from the last.  Each pivot's reciprocal is
// kept (dinv) for the second substitution.
template <typename T>
__device__ __forceinline__ void chol_solve_warp(T* H, T* x, T* dinv, int lane, const int* ti,
                                                const int* tk) {
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const T d = tsqrt(H[col_off(j)]);
    const T inv = T(1) / d;
    const T y = x[j] * inv;
    T a[H_SLOTS], b[H_SLOTS];
#pragma unroll
    for (int m = 0; m < H_SLOTS; ++m)
      if (tk[m] > j) {
        a[m] = H[low(ti[m], j)];
        b[m] = H[low(tk[m], j)];
      }
    __syncwarp();
    if (lane == 0) {
      x[j] = y;
      dinv[j] = inv;
    }
#pragma unroll
    for (int m = 0; m < H_SLOTS; ++m) {
      const int t = lane + 32 * m;
      if (tk[m] == j) {
        if (ti[m] == j) {
          H[t] = d;
        } else {
          const T l = H[t] * inv;
          H[t] = l;
          x[ti[m]] = x[ti[m]] - l * y;
        }
      } else if (tk[m] > j) {
        H[t] = H[t] - (a[m] * inv) * (b[m] * inv);
      }
    }
    __syncwarp();
  }
#pragma unroll
  for (int j = NV - 1; j >= 0; --j) {
    const T z = x[j] * dinv[j];
    __syncwarp();
    if (lane == 0) x[j] = z;
#pragma unroll
    for (int m = 0; m < H_SLOTS; ++m)
      if (ti[m] == j && tk[m] >= 0 && tk[m] < j) x[tk[m]] = x[tk[m]] - H[lane + 32 * m] * z;
    __syncwarp();
  }
}

// ---------------------------------------------------------------- smooth

// The model's structure as ant_smooth reads it: one int32 table
// (ops/ant_forward.py::smooth_table, SMOOTH_FIELDS in the same order).
// Bitmasks: bit d of a body's dofs, bit b of a dof's or an entry's bodies.
constexpr int NPAIR = 64;  // (body, rotation dof) pairs the table can hold
enum : int {
  ST_NLEV = 0,                 // the tree's levels (the root alone is level 0)
  ST_LEVEL = ST_NLEV + 1,      // [NB] each body's level
  ST_PARENT = ST_LEVEL + NB,   // [NB] its parent (-1: the root, body 0)
  ST_JNT = ST_PARENT + NB,     // [NB] the hinge that moves it from its parent, or -1
  ST_QPOS = ST_JNT + NB,       // [NB] that hinge's qpos index, or -1
  ST_DOFS = ST_QPOS + NB,      // [NB] the dofs that move it (a bitmask)
  ST_PBASE = ST_DOFS + NB,     // [NB] its first (body, rotation dof) pair
  ST_PAIR = ST_PBASE + NB,     // [NPAIR] pair p as (body << 8) | dof, -1 past the last
  ST_ANCHOR = ST_PAIR + NPAIR, // [NV] a rotation dof's anchor body (its hinge's child)
  ST_DJNT = ST_ANCHOR + NV,    // [NV] a dof's hinge, or -1
  ST_DBODIES = ST_DJNT + NV,   // [NV] the bodies a dof moves
  ST_DACT = ST_DBODIES + NV,   // [NV] the actuator of a dof (the last), or -1
  ST_MENTRY = ST_DACT + NV,    // [NL] the packed entries of M as t | i << 8 | k << 16,
                               // the most bodies first (a lane's slots balance)
  ST_MBODIES = ST_MENTRY + NL, // [NL] the bodies that add to each, in that order
  ST_LEN = ST_MBODIES + NL
};

// One env's shared memory, in T: the inputs, the kinematics in the SKin
// output's order, then the intermediates; the packed M (kept for the
// output) and H (its copy, factored by the solve).
constexpr int SKIN_N = SK_DOFP + 3 * NV;
enum : int {
  SE_Q = 0,
  SE_QV = SE_Q + NQ,
  SE_CTRL = SE_QV + NV,
  SE_SKIN = SE_CTRL + NU,
  SE_XQUAT = SE_SKIN + SKIN_N,
  SE_COM = SE_XQUAT + 4 * NB,
  SE_IW = SE_COM + 3 * NB,
  SE_JP = SE_IW + 9 * NB,      // each pair's u_d x (com_b - p_d)
  SE_IWU = SE_JP + 3 * NPAIR,  // each pair's I_b^w u_d
  SE_CDOT = SE_IWU + 3 * NPAIR,
  SE_OMEGA = SE_CDOT + 3 * NB,
  SE_UDOT = SE_OMEGA + 3 * NB,
  SE_PDOT = SE_UDOT + 3 * NV,
  SE_FLIN = SE_PDOT + 3 * NV,
  SE_FANG = SE_FLIN + 3 * NB,
  SE_M = SE_FANG + 3 * NB,
  SE_H = SE_M + NL,
  SE_X = SE_H + NL,  // qfrc, then qacc_smooth
  SE_DINV = SE_X + NV,
  SE_SIZE = SE_DINV + NV
};

// the pair of body b and rotation dof d (d >= 3, active on b)
__device__ __forceinline__ int pair_of(const int* tab, int b, int d) {
  return tab[ST_PBASE + b] + __popc((unsigned)tab[ST_DOFS + b] & ((1u << d) - 1u) & ~7u);
}

// The CoM-anchored Jacobian column of dof d on body b (active pair):
// translation dofs the unit axis, rotation dofs their pair's u_d x (com_b - p_d).
template <typename T>
__device__ __forceinline__ void jp_col(const T* s, const int* tab, int b, int d, T* out) {
  if (d < 3) {
    out[0] = d == 0 ? T(1) : T(0);
    out[1] = d == 1 ? T(1) : T(0);
    out[2] = d == 2 ? T(1) : T(0);
  } else {
    const T* jp = s + SE_JP + 3 * pair_of(tab, b, d);
    for (int i = 0; i < 3; ++i) out[i] = jp[i];
  }
}

// R I R^T of body b (I symmetric, from the model)
template <typename T>
__device__ void world_inertia(const T* mdl, int b, const T* R, T* iw) {
  const T* I = mdl + M_BODY_INERTIA + 9 * b;
  T RI[9];
  for (int i = 0; i < 3; ++i)
    for (int k = 0; k < 3; ++k)
      RI[3 * i + k] = R[3 * i] * I[k] + R[3 * i + 1] * I[3 + k] + R[3 * i + 2] * I[6 + k];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) iw[3 * i + j] = dot3(RI + 3 * i, R + 3 * j);
}

// One env's smooth dynamics on its warp, everything in its shared memory
// s (SE_*; the inputs already there) and the block's table tab.  Lanes
// own bodies, dofs, pairs or packed entries of M in turn, a __syncwarp
// between dependent steps.  Each value takes its terms in the order of
// the JAX scalar code (smooth_forward_s).
template <typename T>
__device__ __forceinline__ void smooth_env(const T* __restrict__ mdl, const int* tab, T* s,
                                           int lane) {
  const T* q = s + SE_Q;
  const T* qv = s + SE_QV;
  T* xpos = s + SE_SKIN + SK_XPOS;
  T* xmat = s + SE_SKIN + SK_XMAT;
  T* dof_u = s + SE_SKIN + SK_DOFU;
  T* dof_p = s + SE_SKIN + SK_DOFP;
  T* xquat = s + SE_XQUAT;
  T* com = s + SE_COM;
  T* iw = s + SE_IW;
  T* cdot = s + SE_CDOT;
  T* omega = s + SE_OMEGA;
  T* udot = s + SE_UDOT;
  T* pdot = s + SE_PDOT;
  T* f_lin = s + SE_FLIN;
  T* f_ang = s + SE_FANG;
  const int b = lane, d = lane;  // a lane's body or dof
  const bool body = lane < NB, dof = lane < NV;
  int ti[H_SLOTS], tk[H_SLOTS];  // the lane's entries of H for the solve
  lane_entries(lane, ti, tk);

  // ---- FK (_fk_s) by tree level: the root, then a lane per body of each
  // level from its parent's frame
  if (lane == 0) {
    const T rw = q[3], rx = q[4], ry = q[5], rz = q[6];
    const T inv = T(1) / tsqrt(rw * rw + rx * rx + ry * ry + rz * rz);
    const T quat[4] = {rw * inv, rx * inv, ry * inv, rz * inv};
    for (int i = 0; i < 4; ++i) xquat[i] = quat[i];
    T R[9];
    quat_to_mat(quat, R);
    for (int i = 0; i < 9; ++i) xmat[i] = R[i];
    for (int i = 0; i < 3; ++i) xpos[i] = q[i];
  }
  const int level = body ? tab[ST_LEVEL + b] : -1;
  const int nlev = tab[ST_NLEV];
  for (int l = 1; l < nlev; ++l) {
    __syncwarp();
    if (level != l) continue;
    const int p = tab[ST_PARENT + b], j = tab[ST_JNT + b];
    T off[3];
    mat_vec(xmat + 9 * p, mdl + M_BODY_POS + 3 * b, off);
    for (int i = 0; i < 3; ++i) xpos[3 * b + i] = xpos[3 * p + i] + off[i];
    T quat[4];
    if (j >= 0) {
      T c, sn;
      half_sincos(T(0.5) * q[tab[ST_QPOS + b]], sn, c);
      const T* ax = mdl + M_JNT_AXIS + 3 * j;
      const T hq[4] = {c, sn * ax[0], sn * ax[1], sn * ax[2]};
      quat_mul(xquat + 4 * p, hq, quat);
    } else {
      for (int i = 0; i < 4; ++i) quat[i] = xquat[4 * p + i];
    }
    for (int i = 0; i < 4; ++i) xquat[4 * b + i] = quat[i];
    T R[9];
    quat_to_mat(quat, R);
    for (int i = 0; i < 9; ++i) xmat[9 * b + i] = R[i];
  }
  __syncwarp();

  // ---- kinematics_s: CoMs and world inertias a lane per body, dof axes
  // and anchors a lane per dof
  if (body) {
    T off[3], I[9];
    mat_vec(xmat + 9 * b, mdl + M_BODY_IPOS + 3 * b, off);
    for (int i = 0; i < 3; ++i) com[3 * b + i] = xpos[3 * b + i] + off[i];
    world_inertia(mdl, b, xmat + 9 * b, I);
    for (int i = 0; i < 9; ++i) iw[9 * b + i] = I[i];
  }
  if (dof) {
    T u[3] = {T(0), T(0), T(0)}, pt[3] = {T(0), T(0), T(0)};
    const int j = tab[ST_DJNT + d], a = tab[ST_ANCHOR + d];
    if (j >= 0) {  // a hinge: its child's frame
      mat_vec(xmat + 9 * a, mdl + M_JNT_AXIS + 3 * j, u);
    } else if (d >= 3) {  // a free rotation: the torso's axes
      for (int i = 0; i < 3; ++i) u[i] = xmat[3 * i + d - 3];
    }
    if (d >= 3)
      for (int i = 0; i < 3; ++i) pt[i] = xpos[3 * a + i];
    for (int i = 0; i < 3; ++i) {
      dof_u[3 * d + i] = u[i];
      dof_p[3 * d + i] = pt[i];
    }
  }
  __syncwarp();
  // each (body, rotation dof) pair's Jacobian column and I^w u_d
  for (int pi = lane; pi < NPAIR; pi += 32) {
    const int pr = tab[ST_PAIR + pi];
    if (pr < 0) break;
    const int pb = pr >> 8, pd = pr & 255;
    const T* u = dof_u + 3 * pd;
    const T arm[3] = {com[3 * pb] - dof_p[3 * pd], com[3 * pb + 1] - dof_p[3 * pd + 1],
                      com[3 * pb + 2] - dof_p[3 * pd + 2]};
    T jp[3], iwu[3];
    cross3(u, arm, jp);
    mat_vec(iw + 9 * pb, u, iwu);
    for (int i = 0; i < 3; ++i) {
      s[SE_JP + 3 * pi + i] = jp[i];
      s[SE_IWU + 3 * pi + i] = iwu[i];
    }
  }
  __syncwarp();

  // ---- mass_matrix_s: the lane's packed entries (i, k) in the table's
  // order, each summed over its bodies in body order (none: an exact
  // zero), the armature on the diagonal; H its copy for the solve
#pragma unroll
  for (int m = 0; m < H_SLOTS; ++m) {
    const int pos = lane + 32 * m;
    if (pos >= NL) break;
    const int me = tab[ST_MENTRY + pos];
    const int t = me & 255, i = (me >> 8) & 255, k = me >> 16;
    T acc = T(0);
    for (unsigned bs = (unsigned)tab[ST_MBODIES + pos]; bs; bs &= bs - 1u) {
      const int bb = __ffs(bs) - 1;
      T jk[3], ji[3];
      jp_col(s, tab, bb, k, jk);
      jp_col(s, tab, bb, i, ji);
      T v = mdl[M_BODY_MASS + bb] * dot3(jk, ji);
      if (k >= 3 && i >= 3) v = v + dot3(s + SE_IWU + 3 * pair_of(tab, bb, k), dof_u + 3 * i);
      acc = acc + v;
    }
    if (i == k) acc = acc + mdl[M_ARMATURE + k];
    s[SE_M + t] = acc;
    s[SE_H + t] = acc;
  }

  // ---- bias_force_s: the body velocities a lane per body
  if (body) {
    T c[3] = {T(0), T(0), T(0)}, w[3] = {T(0), T(0), T(0)};
    for (unsigned ds = (unsigned)tab[ST_DOFS + b]; ds; ds &= ds - 1u) {
      const int dd = __ffs(ds) - 1;
      T jd[3];
      jp_col(s, tab, b, dd, jd);
      for (int i = 0; i < 3; ++i) c[i] = c[i] + qv[dd] * jd[i];
      if (dd >= 3)
        for (int i = 0; i < 3; ++i) w[i] = w[i] + qv[dd] * dof_u[3 * dd + i];
    }
    for (int i = 0; i < 3; ++i) {
      cdot[3 * b + i] = c[i];
      omega[3 * b + i] = w[i];
    }
  }
  __syncwarp();
  // the rotation dofs' frame rates, a lane per dof
  if (dof && d >= 3) {
    const int a = tab[ST_ANCHOR + d];
    T ud[3], w[3];
    cross3(omega + 3 * a, dof_u + 3 * d, ud);
    const T arm[3] = {dof_p[3 * d] - com[3 * a], dof_p[3 * d + 1] - com[3 * a + 1],
                      dof_p[3 * d + 2] - com[3 * a + 2]};
    cross3(omega + 3 * a, arm, w);
    for (int i = 0; i < 3; ++i) {
      udot[3 * d + i] = ud[i];
      pdot[3 * d + i] = cdot[3 * a + i] + w[i];
    }
  }
  __syncwarp();
  // each body's J-dot q-dot and its wrench, a lane per body
  if (body) {
    T a_lin[3] = {T(0), T(0), T(0)}, a_ang[3] = {T(0), T(0), T(0)};
    for (unsigned ds = (unsigned)tab[ST_DOFS + b] & ~7u; ds; ds &= ds - 1u) {
      const int dd = __ffs(ds) - 1;
      const T arm[3] = {com[3 * b] - dof_p[3 * dd], com[3 * b + 1] - dof_p[3 * dd + 1],
                        com[3 * b + 2] - dof_p[3 * dd + 2]};
      const T rel[3] = {cdot[3 * b] - pdot[3 * dd], cdot[3 * b + 1] - pdot[3 * dd + 1],
                        cdot[3 * b + 2] - pdot[3 * dd + 2]};
      T c1[3], c2[3];
      cross3(udot + 3 * dd, arm, c1);
      cross3(dof_u + 3 * dd, rel, c2);
      for (int i = 0; i < 3; ++i) {
        a_lin[i] = a_lin[i] + qv[dd] * (c1[i] + c2[i]);
        a_ang[i] = a_ang[i] + qv[dd] * udot[3 * dd + i];
      }
    }
    const T mb = mdl[M_BODY_MASS + b];
    const T g[3] = {T(0), T(0), mdl[M_GRAVITY]};
    T ia[3], io[3], wio[3];
    mat_vec(iw + 9 * b, a_ang, ia);
    mat_vec(iw + 9 * b, omega + 3 * b, io);
    cross3(omega + 3 * b, io, wio);
    for (int i = 0; i < 3; ++i) {
      f_lin[3 * b + i] = mb * (a_lin[i] - g[i]);
      f_ang[3 * b + i] = ia[i] + wio[i];
    }
  }
  __syncwarp();
  // the wrenches projected on each dof (a lane per dof, its bodies in body
  // order); then actuation and damping: qfrc = tau - damping qvel - bias
  if (dof) {
    T bias = T(0);
    for (unsigned bs = (unsigned)tab[ST_DBODIES + d]; bs; bs &= bs - 1u) {
      const int bb = __ffs(bs) - 1;
      T jd[3];
      jp_col(s, tab, bb, d, jd);
      T v = dot3(jd, f_lin + 3 * bb);
      if (d >= 3) v = v + dot3(dof_u + 3 * d, f_ang + 3 * bb);
      bias = bias + v;
    }
    const int k = tab[ST_DACT + d];
    const T tau = k >= 0 ? mdl[M_GEAR] * tclip(s[SE_CTRL + k], T(-1), T(1)) : T(0);
    s[SE_X + d] = tau - mdl[M_DAMPING + d] * qv[d] - bias;
  }
  __syncwarp();

  // ---- qacc_smooth = M^-1 qfrc
  chol_solve_warp(s + SE_H, s + SE_X, s + SE_DINV, lane, ti, tk);
}

// One warp per env, W consecutive envs a block.  The block copies its
// envs' qpos, qvel and ctrl rows (W x 15, W x 14, W x 8 contiguous values)
// and the table into shared memory, each warp runs its env, and the block
// writes the outputs from shared memory with the env index fastest: a row
// of an env-minor [k, B] output is W consecutive values.  At f32 the
// launch bound leaves each thread 64 registers, so 4 blocks fit an SM and
// B = 4,096 runs in one wave on 132 SMs.
template <typename T, int W>
__global__ void __launch_bounds__(32 * W, sizeof(T) == 4 ? 4 : 1)
    ant_smooth_kernel(int B, const T* __restrict__ mdl, const int* __restrict__ tab,
                      const T* __restrict__ qpos, const T* __restrict__ qvel,
                      const T* __restrict__ ctrl, T* __restrict__ M_out,
                      T* __restrict__ qs_out, T* __restrict__ skin) {
  constexpr int N = 32 * W;
  __shared__ T sm[W * SE_SIZE];
  __shared__ int stab[ST_LEN];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int e0 = blockIdx.x * W, nw = B - e0 < W ? B - e0 : W;
  const size_t Bs = B;
  for (int x = threadIdx.x; x < ST_LEN; x += N) stab[x] = tab[x];
  for (int x = threadIdx.x; x < nw * NQ; x += N)
    sm[(x / NQ) * SE_SIZE + SE_Q + x % NQ] = qpos[(size_t)e0 * NQ + x];
  for (int x = threadIdx.x; x < nw * NV; x += N)
    sm[(x / NV) * SE_SIZE + SE_QV + x % NV] = qvel[(size_t)e0 * NV + x];
  for (int x = threadIdx.x; x < nw * NU; x += N)
    sm[(x / NU) * SE_SIZE + SE_CTRL + x % NU] = ctrl[(size_t)e0 * NU + x];
  __syncthreads();
  if (wid < nw) smooth_env(mdl, stab, sm + wid * SE_SIZE, lane);
  __syncthreads();
#pragma unroll 4
  for (int x = threadIdx.x; x < SKIN_N * W; x += N) {
    const int k = x / W, w = x % W;
    if (w < nw) skin[k * Bs + e0 + w] = sm[w * SE_SIZE + SE_SKIN + k];
  }
#pragma unroll 4
  for (int x = threadIdx.x; x < NV * NV * W; x += N) {
    const int k = x / W, w = x % W, r = k / NV, c = k % NV;
    if (w < nw) M_out[k * Bs + e0 + w] = sm[w * SE_SIZE + SE_M + (r >= c ? low(r, c) : low(c, r))];
  }
  for (int x = threadIdx.x; x < NV * W; x += N) {
    const int d = x / W, w = x % W;
    if (w < nw) qs_out[d * Bs + e0 + w] = sm[w * SE_SIZE + SE_X + d];
  }
}

// ---------------------------------------------------------------- rows

template <typename T>
struct Geo {
  T dist, n[3], pos[3];
};

// _sphere_box_s: a sphere against the box [lo, hi].  outside: the
// closest-point formula; with the centre inside, the nearest face (the
// first of equal depths in the order +x, -x, +y, -y, +z, -z).  n points
// from the box toward the sphere.
template <typename T>
__device__ bool sphere_box(const T* c, T r, const T* lo, const T* hi, Geo<T>& out) {
  T delta[3];
  for (int k = 0; k < 3; ++k) delta[k] = c[k] - tclip(c[k], lo[k], hi[k]);
  const T dn = tsqrt(dot3(delta, delta));
  const bool outside = dn > T(1e-12);
  if (outside) {
    const T inv = T(1) / dn;
    out.dist = dn - r;
    for (int k = 0; k < 3; ++k) out.n[k] = delta[k] * inv;
  } else {
    T best_d = hi[0] - c[0];
    int best = 0;
    const T depth[5] = {c[0] - lo[0], hi[1] - c[1], c[1] - lo[1], hi[2] - c[2], c[2] - lo[2]};
    for (int k = 0; k < 5; ++k)
      if (depth[k] < best_d) {
        best_d = depth[k];
        best = k + 1;
      }
    out.dist = -(best_d + r);
    for (int k = 0; k < 3; ++k) out.n[k] = T(0);
    out.n[best / 2] = (best % 2) ? T(-1) : T(1);
  }
  const T s = r + T(0.5) * out.dist;
  for (int k = 0; k < 3; ++k) out.pos[k] = c[k] - s * out.n[k];
  return outside;
}

template <typename T>
__device__ __forceinline__ T seg_fprime(const T* p0, const T* u, const T* lo, const T* hi, T t) {
  T res[3];
  for (int k = 0; k < 3; ++k) {
    const T pt = p0[k] + t * u[k];
    res[k] = tmax(pt - hi[k], T(0)) + tmin(pt - lo[k], T(0));
  }
  return dot3(u, res);
}

// the closed-form minimizer over the active residual pattern at t_ref
template <typename T>
__device__ __forceinline__ void closed_terms(const T* p0, const T* u, const T* lo, const T* hi,
                                             T t_ref, T& num, T& den) {
  num = den = T(0);
  for (int k = 0; k < 3; ++k) {
    const T pt = p0[k] + t_ref * u[k];
    const T rb = tmax(pt - hi[k], T(0)) + tmin(pt - lo[k], T(0));
    if (rb > T(0) || rb < T(0)) {
      const T target = rb > T(0) ? hi[k] : lo[k];
      num = num + u[k] * (target - p0[k]);
      den = den + u[k] * u[k];
    }
  }
}

// line_t of _capsule_box_slots_s: the start (strict = false) or the end
// (strict = true) of the minimizing set of f along the segment
template <typename T>
__device__ T line_t(const T* p0, const T* u, const T* lo, const T* hi, T fp0, T fp1,
                    bool strict) {
  T lo_t = T(0), hi_t = T(1);
  for (int it = 0; it < 10; ++it) {
    const T mid = T(0.5) * (lo_t + hi_t);
    const T f = seg_fprime(p0, u, lo, hi, mid);
    const bool up = strict ? f > T(0) : f >= T(0);
    if (up)
      hi_t = mid;
    else
      lo_t = mid;
  }
  T n_hi, d_hi, n_lo, d_lo;
  closed_terms(p0, u, lo, hi, hi_t, n_hi, d_hi);
  closed_terms(p0, u, lo, hi, lo_t, n_lo, d_lo);
  const bool use_hi = d_hi > T(1e-12);
  const T num = use_hi ? n_hi : n_lo, den = use_hi ? d_hi : d_lo;
  T t;
  if (den > T(1e-12))
    t = tclip(num / tmax(den, T(1e-12)), T(0), T(1));
  else
    t = T(0.5) * (lo_t + hi_t);
  if (strict) return fp1 <= T(0) ? T(1) : (fp0 > T(0) ? T(0) : t);
  return fp0 >= T(0) ? T(0) : (fp1 < T(0) ? T(1) : t);
}

// _capsule_box_slots_s: MuJoCo's capsule-box contacts as the JAX package
// reverse-engineered them (the start and the end of the minimizing set,
// and when they coincide the deepest other end sphere).  The distance of a
// slot that holds no contact is BIG.
template <typename T>
__device__ void capsule_box(const T* p0, const T* p1, T r, const T* lo, const T* hi, Geo<T>* out) {
  T u[3] = {p1[0] - p0[0], p1[1] - p0[1], p1[2] - p0[2]};
  const T fp0 = seg_fprime(p0, u, lo, hi, T(0)), fp1 = seg_fprime(p0, u, lo, hi, T(1));
  T t1 = line_t(p0, u, lo, hi, fp0, fp1, false);
  const T t2 = line_t(p0, u, lo, hi, fp0, fp1, true);
  Geo<T> e0, e1;
  const bool out0 = sphere_box(p0, r, lo, hi, e0);
  const bool out1 = sphere_box(p1, r, lo, hi, e1);
  const bool inside = !out0 || !out1;
  const bool pick_in1 = (!out0 && !out1) ? (e1.dist <= e0.dist) : !out1;
  if (inside) t1 = pick_in1 ? T(1) : T(0);
  T pt[3];
  for (int k = 0; k < 3; ++k) pt[k] = p0[k] + t1 * u[k];
  sphere_box(pt, r, lo, hi, out[0]);
  for (int k = 0; k < 3; ++k) pt[k] = p0[k] + t2 * u[k];
  const bool outside2 = sphere_box(pt, r, lo, hi, out[1]);
  const bool unique = tabs(t2 - t1) <= T(1e-6);
  if (!(outside2 && !unique && !inside)) out[1].dist = T(BIG);
  const T big = T(BIG);
  const T d0 = (out0 && t1 > T(1e-6)) ? e0.dist : big;
  const T d1 = (out1 && t1 < T(1.0 - 1e-6)) ? e1.dist : big;
  const bool pick1 = d1 < d0;
  out[2] = pick1 ? e1 : e0;
  out[2].dist = pick1 ? d1 : d0;
  if (!(unique && !inside && out[2].dist < big * T(0.5))) out[2].dist = big;
}

// A unit of ant_rows is one thread's work for one env (ops/ant_forward.py::
// units, one row of UNIT_W ints per unit, in the JAX candidate order): a
// joint-limit row, a floor sphere or capsule end, a wall slot's torso
// sphere-box, or one capsule's three capsule-box slots in one wall slot
// (they share the segment's two bisections).
enum : int { U_LIMIT = 0, U_FLOOR_TORSO, U_FLOOR_END, U_WALL_TORSO, U_WALL_CAPSULE };
enum : int {
  UF_KIND = 0,
  UF_INDEX,  // the hinge of a limit row, else the unit's first candidate
  UF_BODY,
  UF_GEOM,
  UF_SLOT,
  UF_END,     // a floor capsule end: 0 the segment's start, 1 its end
  UF_HINGE0,  // the hinge dofs that move the body, ascending (-1: none)
  UF_HINGE1,
  UNIT_W
};
constexpr int NSLOT8 = 8;  // a contact row's dofs: the 6 free ones, the body's <= 2 hinges

// What a contact's Jacobian rows read of one env: the torso's frame and
// the body's hinges (their world axes and anchors), and qvel of those 8
// dofs.  The others enter a contact row as exact zeros.
template <typename T>
struct RowCtx {
  const T* mdl;
  const int* row_ptr;
  const int* row_dof;
  size_t B;
  int e, body, hinge[2];
  T* vals;
  T* aref;
  T* r;
  T* active;
  T xpos0[3], R0[9];
  T hu[2][3], hp[2][3];
  T qv[NSLOT8];
};

// _jrow_entries: the Jacobian row of a contact at world point pos on the
// body, dotted with direction dr, over the body's 8 dof slots
template <typename T>
__device__ void jrow(const RowCtx<T>& c, const T* pos, const T* dr, T* col) {
  for (int k = 0; k < 3; ++k) col[k] = dr[k];
  T arm0[3] = {pos[0] - c.xpos0[0], pos[1] - c.xpos0[1], pos[2] - c.xpos0[2]};
  T m0[3];
  cross3(arm0, dr, m0);
  for (int i = 0; i < 3; ++i)
    col[3 + i] = c.R0[i] * m0[0] + c.R0[3 + i] * m0[1] + c.R0[6 + i] * m0[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    if (c.hinge[s] < 0) {
      col[6 + s] = T(0);
      continue;
    }
    T arm[3] = {pos[0] - c.hp[s][0], pos[1] - c.hp[s][1], pos[2] - c.hp[s][2]};
    T mh[3];
    cross3(arm, dr, mh);
    col[6 + s] = dot3(c.hu[s], mh);
  }
}

// a[s] for a runtime slot s, by selects (the array stays in registers)
template <typename T>
__device__ __forceinline__ T at_slot(const T* a, int s) {
  T v = a[0];
#pragma unroll
  for (int i = 1; i < NSLOT8; ++i) v = s == i ? a[i] : v;
  return v;
}

// the 4 pyramid rows (+t1, -t1, +t2, -t2) of candidate `cand`
template <typename T>
__device__ void emit_rows(const RowCtx<T>& c, int cand, T dist, const T* n, const T* t1,
                          const T* t2, const T* pos) {
  const T* mdl = c.mdl;
  T jn[NSLOT8], jt[2][NSLOT8];
  jrow(c, pos, n, jn);
  jrow(c, pos, t1, jt[0]);
  jrow(c, pos, t2, jt[1]);
  const T violation = dist - mdl[M_MARGIN2];
  const T active = dist < mdl[M_MARGIN2] ? T(1) : T(0);
  const T imp = impedance(mdl, violation);
  T vel_n = T(0);
#pragma unroll
  for (int s = 0; s < NSLOT8; ++s) vel_n = vel_n + c.qv[s] * jn[s];
  const T kd = mdl[M_K] * imp * violation;
  const T rc = (T(1) - imp) / imp * (mdl[M_PYR] * mdl[M_BODY_INVW + c.body]);
  const T mu = mdl[M_MU];
  const size_t B = c.B;
#pragma unroll
  for (int tk = 0; tk < 2; ++tk) {
    T vel_t = T(0);
#pragma unroll
    for (int s = 0; s < NSLOT8; ++s) vel_t = vel_t + c.qv[s] * jt[tk][s];
#pragma unroll
    for (int sg = 0; sg < 2; ++sg) {
      const T smu = sg ? -mu : mu;
      const int row = NLIM + 4 * cand + 2 * tk + sg;
      for (int k = c.row_ptr[row]; k < c.row_ptr[row + 1]; ++k) {
        const int d = c.row_dof[k];
        const int s = d < 6 ? d : (d == c.hinge[0] ? 6 : 7);
        c.vals[k * B + c.e] = at_slot(jn, s) + smu * at_slot(jt[tk], s);
      }
      c.aref[row * B + c.e] = -mdl[M_B] * (vel_n + smu * vel_t) - kd;
      c.r[row * B + c.e] = rc;
      c.active[row * B + c.e] = active;
    }
  }
}

// _make_frame_s: t = y if |n_y| < 0.5 else z, orthogonalised against n
template <typename T>
__device__ void make_frame(const T* n, T* t1, T* t2) {
  const bool ny_small = tabs(n[1]) < T(0.5);
  const T ty = ny_small ? T(1) : T(0), tz = ny_small ? T(0) : T(1);
  const T d = n[1] * ty + n[2] * tz;
  t1[0] = T(0) - d * n[0];
  t1[1] = ty - d * n[1];
  t1[2] = tz - d * n[2];
  const T inv = T(1) / tsqrt(dot3(t1, t1));
  for (int k = 0; k < 3; ++k) t1[k] = inv * t1[k];
  cross3(n, t1, t2);
}

// _select_bounds: a paired slot's box by the sign of the point's
// coordinate on the slot's axis (an unpaired slot holds one box twice)
template <typename T>
__device__ __forceinline__ const T* slot_box(const T* slot, const T* point) {
  const int ax = as_int(slot[12]);
  return point[ax] > T(0) ? slot : slot + 6;  // lo at [0, 3), hi at [3, 6)
}

// The joint-limit row of hinge j: the nearer bound
template <typename T>
__device__ void limit_row(const T* mdl, const int* row_ptr, int j, size_t B, int e,
                          const T* qpos, const T* qvel, T* vals, T* aref, T* r, T* active) {
  const T qj = qpos[(size_t)e * NQ + as_int(mdl[M_JNT_QPOS + j])];
  const T d_lo = qj - mdl[M_JNT_RANGE + 2 * j], d_hi = mdl[M_JNT_RANGE + 2 * j + 1] - qj;
  const bool lower = d_lo <= d_hi;
  const T pos_lim = lower ? d_lo : d_hi, sign = lower ? T(1) : T(-1);
  const T imp = impedance(mdl, pos_lim);
  const int dof = as_int(mdl[M_JNT_DOF + j]);
  vals[row_ptr[j] * B + e] = sign;
  aref[j * B + e] = -mdl[M_B] * (sign * qvel[(size_t)e * NV + dof]) - mdl[M_K] * imp * pos_lim;
  r[j * B + e] = (T(1) - imp) / imp * mdl[M_DOF_INVW + dof];
  active[j * B + e] = pos_lim < T(0) ? T(1) : T(0);
}

// One thread per (unit, env): blockIdx.y the unit, the env index fastest,
// so a warp runs one unit over 32 consecutive envs (uniform control flow,
// coalesced [k, B] reads and writes).
template <typename T>
__global__ void ant_rows_kernel(int B, const T* __restrict__ mdl, const int* __restrict__ tables,
                                int ne, const int* __restrict__ units,
                                const T* __restrict__ skin, const T* __restrict__ qpos,
                                const T* __restrict__ qvel, T* __restrict__ vals,
                                T* __restrict__ aref, T* __restrict__ r, T* __restrict__ active) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B) return;  // no warp-level operation follows
  const int* u = units + blockIdx.y * UNIT_W;
  const int kind = u[UF_KIND], index = u[UF_INDEX];
  const size_t Bs = B;
  if (kind == U_LIMIT) {
    limit_row(mdl, tables, index, Bs, e, qpos, qvel, vals, aref, r, active);
    return;
  }
  RowCtx<T> c;
  c.mdl = mdl;
  c.row_ptr = tables;
  c.row_dof = tables + ne + 1;
  c.B = Bs;
  c.e = e;
  c.body = u[UF_BODY];
  c.vals = vals;
  c.aref = aref;
  c.r = r;
  c.active = active;
  for (int i = 0; i < 3; ++i) c.xpos0[i] = skin[(SK_XPOS + i) * Bs + e];
  for (int i = 0; i < 9; ++i) c.R0[i] = skin[(SK_XMAT + i) * Bs + e];
  for (int d = 0; d < 6; ++d) c.qv[d] = qvel[(size_t)e * NV + d];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int d = c.hinge[s] = u[UF_HINGE0 + s];
    for (int i = 0; i < 3; ++i) {
      c.hu[s][i] = d < 0 ? T(0) : skin[(SK_DOFU + 3 * d + i) * Bs + e];
      c.hp[s][i] = d < 0 ? T(0) : skin[(SK_DOFP + 3 * d + i) * Bs + e];
    }
    c.qv[6 + s] = d < 0 ? T(0) : qvel[(size_t)e * NV + d];
  }

  // the geom in the world frame
  const int g = u[UF_GEOM], b = c.body;
  T R[9], center[3], off[3];
  for (int i = 0; i < 9; ++i) R[i] = skin[(SK_XMAT + 9 * b + i) * Bs + e];
  mat_vec(R, mdl + M_GEOM_POS + 3 * g, off);
  for (int i = 0; i < 3; ++i) center[i] = skin[(SK_XPOS + 3 * b + i) * Bs + e] + off[i];
  const T rr = mdl[M_GEOM_R + g];
  T axis_w[3], p0[3], p1[3];
  if (kind == U_FLOOR_END || kind == U_WALL_CAPSULE) {
    mat_vec(R, mdl + M_GEOM_AXIS + 3 * g, axis_w);
    const T h = mdl[M_GEOM_H + g];
    for (int i = 0; i < 3; ++i) {
      p0[i] = center[i] - h * axis_w[i];
      p1[i] = center[i] + h * axis_w[i];
    }
  }
  T t1[3], t2[3];
  if (kind == U_FLOOR_TORSO) {  // floor (z = 0): the torso sphere, a constant frame
    const T nz[3] = {T(0), T(0), T(1)};
    const T dist = center[2] - rr;
    const T pos[3] = {center[0], center[1], center[2] - (rr + T(0.5) * dist)};
    const T f1[3] = {T(0), T(1), T(0)}, f2[3] = {T(-1), T(0), T(0)};
    emit_rows(c, index, dist, nz, f1, f2, pos);
  } else if (kind == U_FLOOR_END) {
    // _capsule_floor_frame: t1 = -normalize(the axis on the plane)
    const T nz[3] = {T(0), T(0), T(1)};
    const T px = axis_w[0], py = axis_w[1];
    const T nrm = tsqrt(px * px + py * py);
    if (nrm > T(1e-8)) {
      const T inv = T(-1) / nrm;
      t1[0] = px * inv;
      t1[1] = py * inv;
    } else {
      t1[0] = T(0);
      t1[1] = T(1);
    }
    t1[2] = T(0);
    t2[0] = -t1[1];
    t2[1] = t1[0];
    t2[2] = T(0);
    const T* cc = u[UF_END] ? p1 : p0;
    const T dist = cc[2] - rr;
    const T pos[3] = {cc[0], cc[1], cc[2] - (rr + T(0.5) * dist)};
    emit_rows(c, index, dist, nz, t1, t2, pos);
  } else if (kind == U_WALL_TORSO) {
    const T* slot = mdl + M_SLOTS + NSLOTW * u[UF_SLOT];
    const T* box = slot_box(slot, center);
    Geo<T> geo;
    sphere_box(center, rr, box, box + 3, geo);
    make_frame(geo.n, t1, t2);
    emit_rows(c, index, geo.dist, geo.n, t1, t2, geo.pos);
  } else {  // U_WALL_CAPSULE: the capsule's three slots
    const T* slot = mdl + M_SLOTS + NSLOTW * u[UF_SLOT];
    const T mid[3] = {T(0.5) * (p0[0] + p1[0]), T(0.5) * (p0[1] + p1[1]),
                      T(0.5) * (p0[2] + p1[2])};
    const T* box = slot_box(slot, mid);
    Geo<T> geo[3];
    capsule_box(p0, p1, rr, box, box + 3, geo);
    for (int k = 0; k < 3; ++k) {
      make_frame(geo[k].n, t1, t2);
      emit_rows(c, index + k, geo[k].dist, geo[k].n, t1, t2, geo[k].pos);
    }
  }
}

// ---------------------------------------------------------------- newton

constexpr int ROWS_CAP = 96;              // active rows held in shared memory at once
constexpr int ROW_SLOTS = ROWS_CAP / 32;  // a lane's rows of a chunk: 32 c + lane
constexpr int JT_STRIDE = ROWS_CAP + 1;   // odd: a row's 14 dofs and a dof's 32 rows
                                          // each fall in distinct banks

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// One env's shared memory: M and H (packed), the nv-vectors q, qs, mq,
// rhs (-grad, then dq), tmp and the factor's reciprocal pivots; then the
// chunk's rows, Jt [NV][JT_STRIDE] (dof-major; before the compaction it
// holds the env's ne active flags); then the active rows' indices [ne].
template <typename T>
__host__ __device__ inline size_t newton_head_bytes() {
  return align16(sizeof(T) * (2 * NL + 6 * NV));
}
template <typename T>
__host__ __device__ inline size_t newton_rows_bytes(int ne) {
  const size_t jt = sizeof(T) * NV * JT_STRIDE;
  return align16(jt > (size_t)ne ? jt : (size_t)ne);
}
template <typename T>
__host__ __device__ inline size_t newton_env_bytes(int ne) {
  return newton_head_bytes<T>() + newton_rows_bytes<T>(ne) + align16(2 * (size_t)ne);
}

// (M x)_d over M's static support (mask: m_rows[d]), M packed
template <typename T>
__device__ __forceinline__ T m_row(const T* Mp, int mask, int d, const T* x) {
  T acc = T(0);
  for (int x2 = 0; x2 < NV; ++x2)
    if ((mask >> x2) & 1) acc = acc + Mp[x2 >= d ? low(x2, d) : low(d, x2)] * x[x2];
  return acc;
}

// A lane's rows of the chunk in registers: slot c holds row 32 c + lane.
template <typename T>
struct Chunk {
  T aref[ROW_SLOTS], D[ROW_SLOTS], slack[ROW_SLOTS], jdq[ROW_SLOTS];
};

// Active rows a0 .. a0 + n - 1 (n <= ROWS_CAP): each lane its rows' support
// values into Jt (dense over the dofs), aref and D = 1 / R into ch.
template <typename T>
__device__ void stage_rows(int a0, int n, int lane, const unsigned short* idx,
                           const int* row_ptr, const int* row_dof, const T* vals,
                           const T* aref, const T* rr, size_t B, int e, T* Jt, Chunk<T>& ch) {
  __syncwarp();  // the previous chunk's readers are done
#pragma unroll
  for (int c = 0; c < ROW_SLOTS; ++c) {
    const int s = 32 * c + lane;
    ch.aref[c] = ch.D[c] = T(0);
    if (s < n) {
      const int row = idx[a0 + s];
      for (int d = 0; d < NV; ++d) Jt[d * JT_STRIDE + s] = T(0);
#pragma unroll 4
      for (int k = row_ptr[row]; k < row_ptr[row + 1]; ++k)
        Jt[row_dof[k] * JT_STRIDE + s] = vals[k * B + e];
      ch.aref[c] = aref[row * B + e];
      ch.D[c] = T(1) / tmax(rr[row * B + e], T(1e-12));
    }
  }
  __syncwarp();
}

template <typename T>
__device__ __forceinline__ T row_dot(const T* Jt, int s, const T* x) {
  T acc = T(0);
#pragma unroll
  for (int d = 0; d < NV; ++d) acc = acc + Jt[d * JT_STRIDE + s] * x[d];
  return acc;
}

// the slack J q - aref of the lane's rows of a chunk of n, and with dq
// their slope J dq
template <typename T>
__device__ void chunk_slack(int n, int lane, const T* Jt, const T* q, const T* dq,
                            Chunk<T>& ch) {
#pragma unroll
  for (int c = 0; c < ROW_SLOTS; ++c) {
    const int s = 32 * c + lane;
    ch.slack[c] = s < n ? row_dot(Jt, s, q) - ch.aref[c] : T(0);
    if (dq) ch.jdq[c] = s < n ? row_dot(Jt, s, dq) : T(0);
  }
}

// A chunk's terms of the gradient (lane d < NV: grad_d) and of the
// Hessian (the lane's packed entries h), row after row in the active
// order: each row's force and weight broadcast from its lane.
template <typename T>
__device__ void chunk_terms(int n, int lane, const T* Jt, const Chunk<T>& ch, const int* ti,
                            const int* tk, T& grad, T* h) {
#pragma unroll
  for (int c = 0; c < ROW_SLOTS; ++c) {
    const T w = ch.slack[c] < T(0) ? ch.D[c] : T(0);  // the row's Hessian weight
    const T f = -ch.D[c] * ch.slack[c];               // its force where w > 0
    const int nn = n - 32 * c < 32 ? n - 32 * c : 32;
    for (int j = 0; j < nn; ++j) {
      const T wr = __shfl_sync(FULL, w, j);
      const T fr = __shfl_sync(FULL, f, j);
      if (wr == T(0)) continue;  // the same on every lane
      const int s = 32 * c + j;
      if (lane < NV) grad = grad - Jt[lane * JT_STRIDE + s] * fr;
#pragma unroll
      for (int m = 0; m < H_SLOTS; ++m) {
        if (tk[m] < 0) continue;
        const T acd = wr * Jt[tk[m] * JT_STRIDE + s];
        h[m] = h[m] + acd * Jt[ti[m] * JT_STRIDE + s];
      }
    }
  }
}

template <typename T, int W, bool COUNT>
__global__ void __launch_bounds__(32 * W)
    ant_newton_kernel(int B, int ne, int iters, int ls_iters, const int* __restrict__ tables,
                      const T* __restrict__ M_in, const T* __restrict__ qs_in,
                      const T* __restrict__ vals, const T* __restrict__ aref,
                      const T* __restrict__ rr, const T* __restrict__ act,
                      const T* __restrict__ warm, T* __restrict__ qacc_out,
                      T* __restrict__ warm_out, unsigned long long* __restrict__ rows_count) {
  extern __shared__ __align__(16) unsigned char ant_smem[];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int e0 = blockIdx.x * W, e = e0 + wid;
  const size_t Bs = B, env_bytes = newton_env_bytes<T>(ne), head = newton_head_bytes<T>();
  const int* row_ptr = tables;
  const int* row_dof = tables + ne + 1;
  const int* m_rows = row_dof + row_ptr[ne];

  // ---- the block's W envs into shared memory, the env index fastest: a
  // row of an env-minor [k, B] input is W consecutive values
#pragma unroll 4
  for (int x = threadIdx.x; x < NL * W; x += 32 * W) {
    const int t = x / W, w = x % W;
    int i, k;
    low_pair(t, i, k);
    ((T*)(ant_smem + w * env_bytes))[t] =
        e0 + w < B ? M_in[(size_t)(i * NV + k) * Bs + e0 + w] : T(0);
  }
  for (int x = threadIdx.x; x < NV * W; x += 32 * W) {
    const int w = x / NV, d = x % NV;  // warm is [B, NV]: W x NV consecutive values
    T* v = (T*)(ant_smem + w * env_bytes) + 2 * NL;
    T s = T(0), q0 = T(0);
    if (e0 + w < B) {
      s = qs_in[d * Bs + e0 + w];
      q0 = warm ? s + warm[(size_t)(e0 + w) * NV + d] : s;
    }
    v[d] = q0;
    v[NV + d] = s;
  }
#pragma unroll 4
  for (int x = threadIdx.x; x < ne * W; x += 32 * W) {
    const int row = x / W, w = x % W;
    ant_smem[w * env_bytes + head + row] = e0 + w < B && act[row * Bs + e0 + w] != T(0);
  }
  if constexpr (COUNT) {
    // the block's active rows: each thread its own flags, a warp sum, then
    // one atomic add a block
    __shared__ unsigned rows_part[W];
    unsigned n = 0;
    for (int x = threadIdx.x; x < ne * W; x += 32 * W)
      n += ant_smem[(x % W) * env_bytes + head + x / W];
    n = __reduce_add_sync(FULL, n);
    if (lane == 0) rows_part[wid] = n;
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned long long sum = 0;
      for (int w = 0; w < W; ++w) sum += rows_part[w];
      atomicAdd(rows_count, sum);
    }
  } else {
    __syncthreads();
  }
  if (e >= B) return;  // the whole warp, after the block's only barrier

  unsigned char* base = ant_smem + wid * env_bytes;
  T* Mp = (T*)base;
  T* H = Mp + NL;
  T* q = H + NL;
  T* qs = q + NV;
  T* mq = qs + NV;
  T* rhs = mq + NV;
  T* tmp = rhs + NV;
  T* dinv = tmp + NV;
  T* Jt = (T*)(base + head);
  unsigned short* idx = (unsigned short*)(base + head + newton_rows_bytes<T>(ne));

  // ---- the active rows (D = 1 / R > 0; the others add exact zeros),
  // compacted in row order
  int na = 0;
  for (int r0 = 0; r0 < ne; r0 += 32) {
    const bool on = r0 + lane < ne && base[head + r0 + lane];
    const unsigned bal = __ballot_sync(FULL, on);
    if (on) idx[na + __popc(bal & ((1u << lane) - 1u))] = (unsigned short)(r0 + lane);
    na += __popc(bal);
  }
  int ti[H_SLOTS], tk[H_SLOTS];  // the lane's entries of H (tk -1: none)
  lane_entries(lane, ti, tk);
  // up to ROWS_CAP active rows stay in shared memory and registers for the
  // whole solve; past that every pass over the rows takes them chunk by
  // chunk from the rows' own buffers, in the same order (the same sums)
  Chunk<T> ch;
  const bool resident = na <= ROWS_CAP;
  if (resident) stage_rows(0, na, lane, idx, row_ptr, row_dof, vals, aref, rr, Bs, e, Jt, ch);

  for (int it = 0; it < iters; ++it) {
    if (lane < NV) tmp[lane] = q[lane] - qs[lane];
    __syncwarp();
    if (lane < NV) mq[lane] = m_row(Mp, m_rows[lane], lane, tmp);
    __syncwarp();
    T grad = lane < NV ? mq[lane] : T(0);
    T h[H_SLOTS];
#pragma unroll
    for (int m = 0; m < H_SLOTS; ++m) h[m] = tk[m] >= 0 ? Mp[lane + 32 * m] : T(0);
    for (int a0 = 0; a0 < na; a0 += ROWS_CAP) {
      const int n = na - a0 < ROWS_CAP ? na - a0 : ROWS_CAP;
      if (!resident)
        stage_rows(a0, n, lane, idx, row_ptr, row_dof, vals, aref, rr, Bs, e, Jt, ch);
      chunk_slack(n, lane, Jt, q, (const T*)nullptr, ch);
      chunk_terms(n, lane, Jt, ch, ti, tk, grad, h);
    }
#pragma unroll
    for (int m = 0; m < H_SLOTS; ++m)
      if (tk[m] >= 0) H[lane + 32 * m] = h[m];
    if (lane < NV) rhs[lane] = -grad;
    __syncwarp();
    chol_solve_warp(H, rhs, dinv, lane, ti, tk);  // rhs = dq

    // exact line search: bisect phi'(alpha) on [0, 2]; phi' is the same
    // on every lane, so is each branch
    if (lane < NV) tmp[lane] = m_row(Mp, m_rows[lane], lane, rhs);
    __syncwarp();
    T g0 = T(0), gq = T(0);
    for (int d = 0; d < NV; ++d) {
      g0 = g0 + rhs[d] * mq[d];
      gq = gq + rhs[d] * tmp[d];
    }
    if (resident) chunk_slack(na, lane, Jt, q, rhs, ch);
    T lo = T(0), hi = T(2);
    for (int l = 0; l < ls_iters; ++l) {
      const T mid = T(0.5) * (lo + hi);
      T part = T(0);
      for (int a0 = 0; a0 < na; a0 += ROWS_CAP) {
        const int n = na - a0 < ROWS_CAP ? na - a0 : ROWS_CAP;
        if (!resident) {
          stage_rows(a0, n, lane, idx, row_ptr, row_dof, vals, aref, rr, Bs, e, Jt, ch);
          chunk_slack(n, lane, Jt, q, rhs, ch);
        }
#pragma unroll
        for (int c = 0; c < ROW_SLOTS; ++c) {
          if (32 * c + lane >= n) continue;
          const T jd = ch.jdq[c];
          const T s = ch.slack[c] + mid * jd;
          if (s < T(0)) part = part + jd * ch.D[c] * s;
        }
      }
      const T acc = (g0 + mid * gq) + warp_sum(part);
      if (acc > T(0))
        hi = mid;
      else
        lo = mid;
    }
    const T alpha = T(0.5) * (lo + hi);
    __syncwarp();
    if (lane < NV) q[lane] = q[lane] + alpha * rhs[lane];
    __syncwarp();
  }
  if (lane < NV) {
    qacc_out[(size_t)e * NV + lane] = q[lane];
    warm_out[(size_t)e * NV + lane] = q[lane] - qs[lane];
  }
}

}  // namespace ant

// ---------------------------------------------------------------- launchers
// Each returns cudaGetLastError() after its launch on `stream`; dtype 0 is
// float32, 1 float64.  Mirrored by ops/ant_forward.py.

namespace {
constexpr int kRowThreads = 128;  // ant_rows: 128 envs of one unit a block

int blocks_for(int B, int per_block) { return (B + per_block - 1) / per_block; }

// ant_newton's dynamic shared memory: above 48 KB a kernel must opt in on
// each device (once per device and size, before the first launch that needs
// it; the launch runs on the current device)
constexpr int kMaxDevices = 64;

template <typename T, bool COUNT>
int newton_launch(int B, int ne, int iters, int ls_iters, const void* tables, const void* M,
                  const void* qs, const void* vals, const void* aref, const void* r,
                  const void* active, const void* warm, void* qacc, void* warm_out,
                  void* rows_count, cudaStream_t st) {
  constexpr int W = ant::WarpEnvs<T>::value;
  const size_t smem = W * ant::newton_env_bytes<T>(ne);
  static size_t opted[kMaxDevices];  // 0: the default 48 KB
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && smem > opted[dev]) {
    err = cudaFuncSetAttribute(ant::ant_newton_kernel<T, W, COUNT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted[dev] = smem;
  }
  ant::ant_newton_kernel<T, W, COUNT><<<blocks_for(B, W), 32 * W, smem, st>>>(
      B, ne, iters, ls_iters, (const int*)tables, (const T*)M, (const T*)qs, (const T*)vals,
      (const T*)aref, (const T*)r, (const T*)active, (const T*)warm, (T*)qacc, (T*)warm_out,
      (unsigned long long*)rows_count);
  return (int)cudaGetLastError();
}

// ant_smooth's shared memory is static: its envs and the table, under the
// default 48 KB a block at either type
template <typename T>
int smooth_launch(int B, const void* mdl, const void* tab, const void* qpos, const void* qvel,
                  const void* ctrl, void* M, void* qs, void* skin, cudaStream_t st) {
  constexpr int W = ant::WarpEnvs<T>::value;
  static_assert(W * ant::SE_SIZE * sizeof(T) + ant::ST_LEN * sizeof(int) <= 48 * 1024,
                "ant_smooth's shared memory");
  ant::ant_smooth_kernel<T, W><<<blocks_for(B, W), 32 * W, 0, st>>>(
      B, (const T*)mdl, (const int*)tab, (const T*)qpos, (const T*)qvel, (const T*)ctrl, (T*)M,
      (T*)qs, (T*)skin);
  return (int)cudaGetLastError();
}
}  // namespace

extern "C" int ant_forward_model_len(int n_slots) { return ant::M_SLOTS + ant::NSLOTW * n_slots; }

extern "C" int ant_forward_unit_width() { return ant::UNIT_W; }

extern "C" int ant_smooth_table_len() { return ant::ST_LEN; }

// ant_newton's active rows an env held in shared memory for the whole solve
extern "C" int ant_newton_rows_cap() { return ant::ROWS_CAP; }

// ant_newton's shared memory a block (its envs a block: 8 at float32, 4 at float64)
extern "C" long long ant_newton_smem_bytes(int dtype, int ne) {
  if (dtype == 0) return ant::WarpEnvs<float>::value * (long long)ant::newton_env_bytes<float>(ne);
  if (dtype == 1) return ant::WarpEnvs<double>::value * (long long)ant::newton_env_bytes<double>(ne);
  return -1;
}

extern "C" int ant_smooth_launch(int dtype, int B, const void* mdl, const void* tab,
                                 const void* qpos, const void* qvel, const void* ctrl, void* M,
                                 void* qs, void* skin, void* stream) {
  if (B <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return smooth_launch<float>(B, mdl, tab, qpos, qvel, ctrl, M, qs, skin, st);
  if (dtype == 1) return smooth_launch<double>(B, mdl, tab, qpos, qvel, ctrl, M, qs, skin, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int ant_rows_launch(int dtype, int B, int n_slots, int ne, int n_units,
                               const void* mdl, const void* tables, const void* units,
                               const void* skin, const void* qpos, const void* qvel, void* vals,
                               void* aref, void* r, void* active, void* stream) {
  if (B <= 0 || n_slots < 0 || ne != ant::NLIM + 4 * (ant::NFLOOR + ant::NSLOT_CAND * n_slots) ||
      n_units != ant::NLIM + ant::NFLOOR + (1 + ant::NCAP) * n_slots)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(blocks_for(B, kRowThreads), n_units);
  if (dtype == 0)
    ant::ant_rows_kernel<float><<<grid, kRowThreads, 0, st>>>(
        B, (const float*)mdl, (const int*)tables, ne, (const int*)units, (const float*)skin,
        (const float*)qpos, (const float*)qvel, (float*)vals, (float*)aref, (float*)r,
        (float*)active);
  else if (dtype == 1)
    ant::ant_rows_kernel<double><<<grid, kRowThreads, 0, st>>>(
        B, (const double*)mdl, (const int*)tables, ne, (const int*)units, (const double*)skin,
        (const double*)qpos, (const double*)qvel, (double*)vals, (double*)aref, (double*)r,
        (double*)active);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int ant_newton_launch(int dtype, int B, int ne, int iters, int ls_iters,
                                 const void* tables, const void* M, const void* qs,
                                 const void* vals, const void* aref, const void* r,
                                 const void* active, const void* warm, void* qacc,
                                 void* warm_out, void* rows_count, void* stream) {
  if (B <= 0 || ne <= 0 || ne > 65535 || iters < 0 || ls_iters < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  // without a counter, the instance with no count
  if (dtype == 0)
    return (rows_count ? newton_launch<float, true> : newton_launch<float, false>)(
        B, ne, iters, ls_iters, tables, M, qs, vals, aref, r, active, warm, qacc, warm_out,
        rows_count, st);
  if (dtype == 1)
    return (rows_count ? newton_launch<double, true> : newton_launch<double, false>)(
        B, ne, iters, ls_iters, tables, M, qs, vals, aref, r, active, warm, qacc, warm_out,
        rows_count, st);
  return (int)cudaErrorInvalidValue;
}
