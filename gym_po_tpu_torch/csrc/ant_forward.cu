// The articulated ant's constrained forward dynamics for Hopper (sm_90a):
// three kernels, one env per thread.
//
// Replaces no TPU kernel.  It is the port of the JAX package's default
// pipeline="scalar" forward (gym_po_tpu/physics/engine.py:87-97), which
// XLA lowers on the TPU to straight-line [B]-vector code: every per-env
// quantity a scalar, every structural zero dropped at trace time.  Its
// counterpart here is straight-line scalar code per thread:
//
//   ant_smooth  smooth_forward_s (gym_po_tpu/physics/dynamics.py:553): FK,
//               CoMs, world inertias and dof axes, the mass matrix over each
//               body's active dofs, the bias force (RNEA with zero qacc),
//               actuation, damping, and the 14x14 Cholesky solve
//               (chol_solve_s, gym_po_tpu/physics/linalg.py).
//   ant_rows    contact_candidates_s + constraint_rows_scalar
//               (gym_po_tpu/physics/contact.py:422, :568): 8 joint-limit
//               rows, 25 floor candidates, per wall slot the torso
//               sphere-box and the 12 capsules' capsule-box triples, then
//               4 pyramid rows per candidate.
//   ant_newton  solve_constraints_newton_s (contact.py:915): `iters` Newton
//               iterations over the active rows (gradient, Hessian over each
//               row's static dof support, Cholesky, `ls_iters` bisections of
//               the line search's derivative on [0, 2]).
//
// The plain PyTorch twins are in gym_po_tpu_torch/ops/ant_forward.py (the
// port's batched array engine, laid out as the kernels lay out their
// buffers).
//
// Layout.  The model's constants are one buffer of T (the M_* offsets
// below, packed by ops/ant_forward.py::pack_model); each row's static dof
// support is a CSR table of int32 (row_ptr [ne + 1], row_dof [nnz]) and the
// mass matrix's a bitmask per row (m_rows [NV]).  Everything passed between
// kernels is env-minor, [k, B], so that a warp's loads coalesce: the
// kinematics the rows need (SKin: body xpos and xmat, dof_u, dof_p), M,
// qacc_smooth, each row's values over its support ([nnz, B]), aref, r and
// the active flags ([ne, B]).  The Newton kernel keeps M, H (factored in
// place) and a few nv-vectors per thread; the per-row slack, line-search
// slope and D = 1/R of the rows that are active (the only rows that
// contribute to the gradient, the Hessian or the line search) go to
// global scratch [ne, B].
//
// What bounds it on this card: neither bytes nor FLOPs.  At the envs'
// batch (B = 4,096) one thread per env is 128 warps, about one per SM, so
// each kernel runs at the latency of a single warp's dependent arithmetic
// and of its local-memory arrays (the per-thread frames: M, the Cholesky
// factor, the kinematics).  The design keeps the frame to a few KB (no
// dense ne x nv Jacobian) and skips the inactive rows in the solve.  No
// --use_fast_math: division, sqrt, sin and cos are IEEE/accurate.

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
__device__ __forceinline__ float tcos(float x) { return cosf(x); }
__device__ __forceinline__ double tcos(double x) { return cos(x); }
__device__ __forceinline__ float tsin(float x) { return sinf(x); }
__device__ __forceinline__ double tsin(double x) { return sin(x); }
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

// chol_factor_s: the lower triangle of A (row-major NV x NV) becomes L
template <typename T>
__device__ void chol_factor(T* A) {
  for (int j = 0; j < NV; ++j) {
    T s = A[j * NV + j];
    for (int k = 0; k < j; ++k) s = s - A[j * NV + k] * A[j * NV + k];
    const T d = tsqrt(s);
    A[j * NV + j] = d;
    const T inv = T(1) / d;
    for (int i = j + 1; i < NV; ++i) {
      T t = A[i * NV + j];
      for (int k = 0; k < j; ++k) t = t - A[i * NV + k] * A[j * NV + k];
      A[i * NV + j] = t * inv;
    }
  }
}

// chol_backsub_s: x <- (L L^T)^-1 x
template <typename T>
__device__ void chol_backsub(const T* L, T* x) {
  for (int i = 0; i < NV; ++i) {
    T s = x[i];
    for (int k = 0; k < i; ++k) s = s - L[i * NV + k] * x[k];
    x[i] = s / L[i * NV + i];
  }
  for (int i = NV - 1; i >= 0; --i) {
    T s = x[i];
    for (int k = i + 1; k < NV; ++k) s = s - L[k * NV + i] * x[k];
    x[i] = s / L[i * NV + i];
  }
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

template <typename T>
__device__ __forceinline__ bool dof_active(const T* mdl, int b, int d) {
  return mdl[M_DOF_MASK + b * NV + d] != T(0);
}

// ---------------------------------------------------------------- smooth

// The CoM-anchored Jacobian column of dof d on body b (active pair):
// translation dofs the unit axis, rotation dofs u_d x (com_b - p_d).
template <typename T>
__device__ __forceinline__ void jp_col(int d, const T* com_b, const T (*dof_u)[3],
                                       const T (*dof_p)[3], T* out) {
  if (d < 3) {
    out[0] = d == 0 ? T(1) : T(0);
    out[1] = d == 1 ? T(1) : T(0);
    out[2] = d == 2 ? T(1) : T(0);
  } else {
    T arm[3] = {com_b[0] - dof_p[d][0], com_b[1] - dof_p[d][1], com_b[2] - dof_p[d][2]};
    cross3(dof_u[d], arm, out);
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

template <typename T>
__global__ void ant_smooth_kernel(int B, const T* __restrict__ mdl, const T* __restrict__ qpos,
                                  const T* __restrict__ qvel, const T* __restrict__ ctrl,
                                  T* __restrict__ M_out, T* __restrict__ qs_out,
                                  T* __restrict__ skin) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B) return;
  const T* q = qpos + (size_t)e * NQ;
  T qv[NV];
  for (int d = 0; d < NV; ++d) qv[d] = qvel[(size_t)e * NV + d];

  // ---- FK (_fk_s): bodies in tree order, parents first
  T xpos[NB][3], xquat[NB][4], xmat[NB][9];
  {
    const T rw = q[3], rx = q[4], ry = q[5], rz = q[6];
    const T inv = T(1) / tsqrt(rw * rw + rx * rx + ry * ry + rz * rz);
    xquat[0][0] = rw * inv;
    xquat[0][1] = rx * inv;
    xquat[0][2] = ry * inv;
    xquat[0][3] = rz * inv;
    quat_to_mat(xquat[0], xmat[0]);
    for (int i = 0; i < 3; ++i) xpos[0][i] = q[i];
  }
  for (int b = 1; b < NB; ++b) {
    const int p = as_int(mdl[M_PARENT + b]);
    T off[3];
    mat_vec(xmat[p], mdl + M_BODY_POS + 3 * b, off);
    for (int i = 0; i < 3; ++i) xpos[b][i] = xpos[p][i] + off[i];
    const int j = as_int(mdl[M_BODY_JNT + b]);
    if (j >= 0) {
      const T ang = q[as_int(mdl[M_JNT_QPOS + j])];
      const T c = tcos(T(0.5) * ang), s = tsin(T(0.5) * ang);
      const T* ax = mdl + M_JNT_AXIS + 3 * j;
      const T hq[4] = {c, s * ax[0], s * ax[1], s * ax[2]};
      quat_mul(xquat[p], hq, xquat[b]);
    } else {
      for (int i = 0; i < 4; ++i) xquat[b][i] = xquat[p][i];
    }
    quat_to_mat(xquat[b], xmat[b]);
  }

  // ---- kinematics_s: CoMs, dof axes and anchors
  T com[NB][3];
  for (int b = 0; b < NB; ++b) {
    T off[3];
    mat_vec(xmat[b], mdl + M_BODY_IPOS + 3 * b, off);
    for (int i = 0; i < 3; ++i) com[b][i] = xpos[b][i] + off[i];
  }
  T dof_u[NV][3], dof_p[NV][3];
  int anchor[NV];
  for (int d = 0; d < NV; ++d) {
    anchor[d] = 0;
    for (int i = 0; i < 3; ++i) dof_u[d][i] = dof_p[d][i] = T(0);
  }
  for (int k = 0; k < 3; ++k)
    for (int i = 0; i < 3; ++i) {
      dof_u[3 + k][i] = xmat[0][3 * i + k];
      dof_p[3 + k][i] = xpos[0][i];
    }
  for (int j = 0; j < NJ; ++j) {
    const int child = as_int(mdl[M_JNT_BODY + j]), d = as_int(mdl[M_JNT_DOF + j]);
    mat_vec(xmat[child], mdl + M_JNT_AXIS + 3 * j, dof_u[d]);
    for (int i = 0; i < 3; ++i) dof_p[d][i] = xpos[child][i];
    anchor[d] = child;
  }

  // ---- mass_matrix_s over each body's active dof pairs; the body
  // velocities of bias_force_s on the same pass
  T M[NV * NV];
  for (int k = 0; k < NV * NV; ++k) M[k] = T(0);
  T cdot[NB][3], omega[NB][3];
  for (int b = 0; b < NB; ++b) {
    const T mb = mdl[M_BODY_MASS + b];
    T iw[9];
    world_inertia(mdl, b, xmat[b], iw);
    for (int i = 0; i < 3; ++i) cdot[b][i] = omega[b][i] = T(0);
    for (int d = 0; d < NV; ++d) {
      if (!dof_active(mdl, b, d)) continue;
      T jpd[3];
      jp_col(d, com[b], dof_u, dof_p, jpd);
      for (int i = 0; i < 3; ++i) cdot[b][i] = cdot[b][i] + qv[d] * jpd[i];
      T iw_jrd[3];
      if (d >= 3) {
        for (int i = 0; i < 3; ++i) omega[b][i] = omega[b][i] + qv[d] * dof_u[d][i];
        mat_vec(iw, dof_u[d], iw_jrd);
      }
      for (int x = d; x < NV; ++x) {
        if (!dof_active(mdl, b, x)) continue;
        T jpx[3];
        jp_col(x, com[b], dof_u, dof_p, jpx);
        T t = mb * dot3(jpd, jpx);
        if (d >= 3 && x >= 3) t = t + dot3(iw_jrd, dof_u[x]);
        M[d * NV + x] = M[d * NV + x] + t;
      }
    }
  }
  for (int d = 0; d < NV; ++d) {
    M[d * NV + d] = M[d * NV + d] + mdl[M_ARMATURE + d];
    for (int x = d + 1; x < NV; ++x) M[x * NV + d] = M[d * NV + x];
  }
  for (int k = 0; k < NV * NV; ++k) M_out[(size_t)k * B + e] = M[k];

  // ---- bias_force_s: the rotation dofs' frame rates, then each body's
  // J-dot q-dot and its wrench, projected back on the active columns
  T udot[NV][3], pdot[NV][3];
  for (int d = 3; d < NV; ++d) {
    const int a = anchor[d];
    cross3(omega[a], dof_u[d], udot[d]);
    T arm[3] = {dof_p[d][0] - com[a][0], dof_p[d][1] - com[a][1], dof_p[d][2] - com[a][2]};
    T w[3];
    cross3(omega[a], arm, w);
    for (int i = 0; i < 3; ++i) pdot[d][i] = cdot[a][i] + w[i];
  }
  T qfrc[NV];
  for (int d = 0; d < NV; ++d) qfrc[d] = T(0);
  const T g[3] = {T(0), T(0), mdl[M_GRAVITY]};
  for (int b = 0; b < NB; ++b) {
    T a_lin[3] = {T(0), T(0), T(0)}, a_ang[3] = {T(0), T(0), T(0)};
    for (int d = 3; d < NV; ++d) {
      if (!dof_active(mdl, b, d)) continue;
      T arm[3] = {com[b][0] - dof_p[d][0], com[b][1] - dof_p[d][1], com[b][2] - dof_p[d][2]};
      T rel[3] = {cdot[b][0] - pdot[d][0], cdot[b][1] - pdot[d][1], cdot[b][2] - pdot[d][2]};
      T c1[3], c2[3];
      cross3(udot[d], arm, c1);
      cross3(dof_u[d], rel, c2);
      for (int i = 0; i < 3; ++i) {
        a_lin[i] = a_lin[i] + qv[d] * (c1[i] + c2[i]);
        a_ang[i] = a_ang[i] + qv[d] * udot[d][i];
      }
    }
    const T mb = mdl[M_BODY_MASS + b];
    T iw[9], ia[3], io[3], wio[3], f_lin[3], f_ang[3];
    world_inertia(mdl, b, xmat[b], iw);
    mat_vec(iw, a_ang, ia);
    mat_vec(iw, omega[b], io);
    cross3(omega[b], io, wio);
    for (int i = 0; i < 3; ++i) {
      f_lin[i] = mb * (a_lin[i] - g[i]);
      f_ang[i] = ia[i] + wio[i];
    }
    for (int d = 0; d < NV; ++d) {
      if (!dof_active(mdl, b, d)) continue;
      T jpd[3];
      jp_col(d, com[b], dof_u, dof_p, jpd);
      T t = dot3(jpd, f_lin);
      if (d >= 3) t = t + dot3(dof_u[d], f_ang);
      qfrc[d] = qfrc[d] + t;  // the bias, negated below
    }
  }

  // ---- actuation, damping, qacc_smooth = M^-1 qfrc
  T tau[NV];
  for (int d = 0; d < NV; ++d) tau[d] = T(0);
  for (int k = 0; k < NU; ++k)
    tau[as_int(mdl[M_ACT_DOF + k])] =
        mdl[M_GEAR] * tclip(ctrl[(size_t)e * NU + k], T(-1), T(1));
  for (int d = 0; d < NV; ++d) qfrc[d] = tau[d] - mdl[M_DAMPING + d] * qv[d] - qfrc[d];
  chol_factor(M);
  chol_backsub(M, qfrc);
  for (int d = 0; d < NV; ++d) qs_out[(size_t)d * B + e] = qfrc[d];

  for (int b = 0; b < NB; ++b)
    for (int i = 0; i < 3; ++i) skin[(size_t)(SK_XPOS + 3 * b + i) * B + e] = xpos[b][i];
  for (int b = 0; b < NB; ++b)
    for (int i = 0; i < 9; ++i) skin[(size_t)(SK_XMAT + 9 * b + i) * B + e] = xmat[b][i];
  for (int d = 0; d < NV; ++d)
    for (int i = 0; i < 3; ++i) {
      skin[(size_t)(SK_DOFU + 3 * d + i) * B + e] = dof_u[d][i];
      skin[(size_t)(SK_DOFP + 3 * d + i) * B + e] = dof_p[d][i];
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

template <typename T>
struct RowCtx {
  const T* mdl;
  const int* row_ptr;
  const int* row_dof;
  int B, e;
  T* vals;
  T* aref;
  T* r;
  T* active;
  T xpos0[3], R0[9];
  T dof_u[NV][3], dof_p[NV][3];
  T qv[NV];
};

// _jrow_entries: the Jacobian row of a contact at world point pos on body
// `body`, dotted with direction dr, over the body's dofs (others 0)
template <typename T>
__device__ void jrow(const RowCtx<T>& c, int body, const T* pos, const T* dr, T* col) {
  for (int k = 0; k < 3; ++k) col[k] = dr[k];
  T arm0[3] = {pos[0] - c.xpos0[0], pos[1] - c.xpos0[1], pos[2] - c.xpos0[2]};
  T m0[3];
  cross3(arm0, dr, m0);
  for (int i = 0; i < 3; ++i)
    col[3 + i] = c.R0[i] * m0[0] + c.R0[3 + i] * m0[1] + c.R0[6 + i] * m0[2];
  for (int d = 6; d < NV; ++d) {
    if (!dof_active(c.mdl, body, d)) {
      col[d] = T(0);
      continue;
    }
    T arm[3] = {pos[0] - c.dof_p[d][0], pos[1] - c.dof_p[d][1], pos[2] - c.dof_p[d][2]};
    T mh[3];
    cross3(arm, dr, mh);
    col[d] = dot3(c.dof_u[d], mh);
  }
}

// the 4 pyramid rows (+t1, -t1, +t2, -t2) of candidate `cand`
template <typename T>
__device__ void emit_rows(const RowCtx<T>& c, int cand, T dist, const T* n, const T* t1,
                          const T* t2, const T* pos, int body) {
  const T* mdl = c.mdl;
  T jn[NV], jt[2][NV];
  jrow(c, body, pos, n, jn);
  jrow(c, body, pos, t1, jt[0]);
  jrow(c, body, pos, t2, jt[1]);
  const T violation = dist - mdl[M_MARGIN2];
  const T active = dist < mdl[M_MARGIN2] ? T(1) : T(0);
  const T imp = impedance(mdl, violation);
  T vel_n = T(0);
  for (int d = 0; d < NV; ++d) vel_n = vel_n + c.qv[d] * jn[d];
  const T kd = mdl[M_K] * imp * violation;
  const T rc = (T(1) - imp) / imp * (mdl[M_PYR] * mdl[M_BODY_INVW + body]);
  const T mu = mdl[M_MU];
  const size_t B = c.B;
  for (int tk = 0; tk < 2; ++tk) {
    T vel_t = T(0);
    for (int d = 0; d < NV; ++d) vel_t = vel_t + c.qv[d] * jt[tk][d];
    for (int sg = 0; sg < 2; ++sg) {
      const T smu = sg ? -mu : mu;
      const int row = NLIM + 4 * cand + 2 * tk + sg;
      for (int k = c.row_ptr[row]; k < c.row_ptr[row + 1]; ++k) {
        const int d = c.row_dof[k];
        c.vals[k * B + c.e] = jn[d] + smu * jt[tk][d];
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

template <typename T>
__global__ void ant_rows_kernel(int B, int n_slots, const T* __restrict__ mdl,
                                const int* __restrict__ tables, int ne,
                                const T* __restrict__ skin, const T* __restrict__ qpos,
                                const T* __restrict__ qvel, T* __restrict__ vals,
                                T* __restrict__ aref, T* __restrict__ r, T* __restrict__ active) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B) return;
  RowCtx<T> c;
  c.mdl = mdl;
  c.row_ptr = tables;
  c.row_dof = tables + ne + 1;
  c.B = B;
  c.e = e;
  c.vals = vals;
  c.aref = aref;
  c.r = r;
  c.active = active;
  const size_t Bs = B;
  for (int i = 0; i < 3; ++i) c.xpos0[i] = skin[(SK_XPOS + i) * Bs + e];
  for (int i = 0; i < 9; ++i) c.R0[i] = skin[(SK_XMAT + i) * Bs + e];
  for (int d = 0; d < NV; ++d)
    for (int i = 0; i < 3; ++i) {
      c.dof_u[d][i] = skin[(SK_DOFU + 3 * d + i) * Bs + e];
      c.dof_p[d][i] = skin[(SK_DOFP + 3 * d + i) * Bs + e];
    }
  for (int d = 0; d < NV; ++d) c.qv[d] = qvel[(size_t)e * NV + d];

  // ---- joint-limit rows: the nearer bound of each hinge
  const T K = mdl[M_K], Bd = mdl[M_B];
  for (int j = 0; j < NJ; ++j) {
    const T qj = qpos[(size_t)e * NQ + as_int(mdl[M_JNT_QPOS + j])];
    const T d_lo = qj - mdl[M_JNT_RANGE + 2 * j], d_hi = mdl[M_JNT_RANGE + 2 * j + 1] - qj;
    const bool lower = d_lo <= d_hi;
    const T pos_lim = lower ? d_lo : d_hi, sign = lower ? T(1) : T(-1);
    const T imp = impedance(mdl, pos_lim);
    const int dof = as_int(mdl[M_JNT_DOF + j]);
    vals[c.row_ptr[j] * Bs + e] = sign;
    aref[j * Bs + e] = -Bd * (sign * c.qv[dof]) - K * imp * pos_lim;
    r[j * Bs + e] = (T(1) - imp) / imp * mdl[M_DOF_INVW + dof];
    active[j * Bs + e] = pos_lim < T(0) ? T(1) : T(0);
  }

  // ---- the collision spheres and capsules in the world frame
  T center[NG][3], axis_w[NCAP][3], p0[NCAP][3], p1[NCAP][3];
  for (int g = 0; g < NG; ++g) {
    const int b = as_int(mdl[M_GEOM_BODY + g]);
    T R[9], xp[3], off[3];
    for (int i = 0; i < 9; ++i) R[i] = skin[(SK_XMAT + 9 * b + i) * Bs + e];
    for (int i = 0; i < 3; ++i) xp[i] = skin[(SK_XPOS + 3 * b + i) * Bs + e];
    mat_vec(R, mdl + M_GEOM_POS + 3 * g, off);
    for (int i = 0; i < 3; ++i) center[g][i] = xp[i] + off[i];
    if (g == 0) continue;
    mat_vec(R, mdl + M_GEOM_AXIS + 3 * g, axis_w[g - 1]);
    const T h = mdl[M_GEOM_H + g];
    for (int i = 0; i < 3; ++i) {
      p0[g - 1][i] = center[g][i] - h * axis_w[g - 1][i];
      p1[g - 1][i] = center[g][i] + h * axis_w[g - 1][i];
    }
  }

  // ---- floor (z = 0) candidates: the torso sphere, both ends of each
  // capsule
  const T nz[3] = {T(0), T(0), T(1)};
  {
    const T rr = mdl[M_GEOM_R + 0];
    const T dist = center[0][2] - rr;
    const T pos[3] = {center[0][0], center[0][1], center[0][2] - (rr + T(0.5) * dist)};
    const T t1[3] = {T(0), T(1), T(0)}, t2[3] = {T(-1), T(0), T(0)};
    emit_rows(c, 0, dist, nz, t1, t2, pos, as_int(mdl[M_GEOM_BODY + 0]));
  }
  for (int i = 0; i < NCAP; ++i) {
    const int g = 1 + i, body = as_int(mdl[M_GEOM_BODY + g]);
    const T rr = mdl[M_GEOM_R + g];
    // _capsule_floor_frame: t1 = -normalize(the axis on the plane)
    const T px = axis_w[i][0], py = axis_w[i][1];
    const T nrm = tsqrt(px * px + py * py);
    T t1[3], t2[3];
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
    for (int end = 0; end < 2; ++end) {
      const T* cc = end ? p1[i] : p0[i];
      const T dist = cc[2] - rr;
      const T pos[3] = {cc[0], cc[1], cc[2] - (rr + T(0.5) * dist)};
      emit_rows(c, 1 + 2 * i + end, dist, nz, t1, t2, pos, body);
    }
  }

  // ---- wall slots: the torso sphere-box, then each capsule's three slots
  for (int s = 0; s < n_slots; ++s) {
    const T* slot = mdl + M_SLOTS + NSLOTW * s;
    const int base = NFLOOR + NSLOT_CAND * s;
    T t1[3], t2[3];
    {
      const T* box = slot_box(slot, center[0]);
      Geo<T> geo;
      sphere_box(center[0], mdl[M_GEOM_R + 0], box, box + 3, geo);
      make_frame(geo.n, t1, t2);
      emit_rows(c, base, geo.dist, geo.n, t1, t2, geo.pos, as_int(mdl[M_GEOM_BODY + 0]));
    }
    for (int i = 0; i < NCAP; ++i) {
      const int g = 1 + i;
      const T mid[3] = {T(0.5) * (p0[i][0] + p1[i][0]), T(0.5) * (p0[i][1] + p1[i][1]),
                        T(0.5) * (p0[i][2] + p1[i][2])};
      const T* box = slot_box(slot, mid);
      Geo<T> geo[3];
      capsule_box(p0[i], p1[i], mdl[M_GEOM_R + g], box, box + 3, geo);
      for (int k = 0; k < 3; ++k) {
        make_frame(geo[k].n, t1, t2);
        emit_rows(c, base + 1 + 3 * i + k, geo[k].dist, geo[k].n, t1, t2, geo[k].pos,
                  as_int(mdl[M_GEOM_BODY + g]));
      }
    }
  }
}

// ---------------------------------------------------------------- newton

// out = M x over M's static support (m_rows: a bitmask of each row's
// structurally nonzero columns)
template <typename T>
__device__ __forceinline__ void m_mul(const T* M, const int* m_rows, const T* x, T* out) {
  for (int d = 0; d < NV; ++d) {
    const int mask = m_rows[d];
    T acc = T(0);
    for (int x2 = 0; x2 < NV; ++x2)
      if ((mask >> x2) & 1) acc = acc + M[d * NV + x2] * x[x2];
    out[d] = acc;
  }
}

template <typename T>
__global__ void ant_newton_kernel(int B, int ne, int iters, int ls_iters,
                                  const int* __restrict__ tables, const T* __restrict__ M_in,
                                  const T* __restrict__ qs_in, const T* __restrict__ vals,
                                  const T* __restrict__ aref, const T* __restrict__ rr,
                                  const T* __restrict__ act, const T* __restrict__ warm,
                                  T* __restrict__ qacc_out, T* __restrict__ warm_out,
                                  int* __restrict__ s_idx, T* __restrict__ s_D,
                                  T* __restrict__ s_slack, T* __restrict__ s_jdq) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B) return;
  const size_t Bs = B;
  const int* row_ptr = tables;
  const int* row_dof = tables + ne + 1;
  const int nnz = row_ptr[ne];
  const int* m_rows = row_dof + nnz;

  T M[NV * NV], H[NV * NV];
  for (int k = 0; k < NV * NV; ++k) M[k] = M_in[k * Bs + e];
  T qs[NV], q[NV];
  for (int d = 0; d < NV; ++d) {
    qs[d] = qs_in[d * Bs + e];
    q[d] = warm ? qs[d] + warm[(size_t)e * NV + d] : qs[d];
  }
  // the active rows (D = 1 / R > 0): the others add exact zeros
  int na = 0;
  for (int row = 0; row < ne; ++row) {
    if (act[row * Bs + e] != T(0)) {
      s_idx[na * Bs + e] = row;
      s_D[na * Bs + e] = T(1) / tmax(rr[row * Bs + e], T(1e-12));
      ++na;
    }
  }

  T mq[NV], grad[NV], dq[NV], tmp[NV];
  for (int it = 0; it < iters; ++it) {
    for (int d = 0; d < NV; ++d) tmp[d] = q[d] - qs[d];
    m_mul(M, m_rows, tmp, mq);
    for (int d = 0; d < NV; ++d) grad[d] = mq[d];
    for (int k = 0; k < NV * NV; ++k) H[k] = M[k];
    for (int a = 0; a < na; ++a) {
      const int row = s_idx[a * Bs + e];
      const int k0 = row_ptr[row], k1 = row_ptr[row + 1];
      T jq = T(0);
      for (int k = k0; k < k1; ++k) jq = jq + vals[k * Bs + e] * q[row_dof[k]];
      const T slack = jq - aref[row * Bs + e];
      s_slack[a * Bs + e] = slack;
      if (slack < T(0)) {
        const T D = s_D[a * Bs + e];
        const T f = -D * slack;  // the row's force, -D min(slack, 0)
        for (int k = k0; k < k1; ++k) {
          const int d = row_dof[k];
          const T cd = vals[k * Bs + e];
          grad[d] = grad[d] - cd * f;
          const T acd = D * cd;
          for (int k2 = k; k2 < k1; ++k2) {
            const int x2 = row_dof[k2];  // x2 >= d: the supports are sorted
            H[x2 * NV + d] = H[x2 * NV + d] + acd * vals[k2 * Bs + e];
          }
        }
      }
    }
    chol_factor(H);
    for (int d = 0; d < NV; ++d) dq[d] = -grad[d];
    chol_backsub(H, dq);

    // exact line search: bisect phi'(alpha) on [0, 2]
    m_mul(M, m_rows, dq, tmp);
    T g0 = T(0), gq = T(0);
    for (int d = 0; d < NV; ++d) {
      g0 = g0 + dq[d] * mq[d];
      gq = gq + dq[d] * tmp[d];
    }
    for (int a = 0; a < na; ++a) {
      const int row = s_idx[a * Bs + e];
      T jd = T(0);
      for (int k = row_ptr[row]; k < row_ptr[row + 1]; ++k)
        jd = jd + vals[k * Bs + e] * dq[row_dof[k]];
      s_jdq[a * Bs + e] = jd;
    }
    T lo = T(0), hi = T(2);
    for (int l = 0; l < ls_iters; ++l) {
      const T mid = T(0.5) * (lo + hi);
      T acc = g0 + mid * gq;
      for (int a = 0; a < na; ++a) {
        const T jd = s_jdq[a * Bs + e];
        const T s = s_slack[a * Bs + e] + mid * jd;
        if (s < T(0)) acc = acc + jd * s_D[a * Bs + e] * s;
      }
      if (acc > T(0))
        hi = mid;
      else
        lo = mid;
    }
    const T alpha = T(0.5) * (lo + hi);
    for (int d = 0; d < NV; ++d) q[d] = q[d] + alpha * dq[d];
  }
  for (int d = 0; d < NV; ++d) {
    qacc_out[(size_t)e * NV + d] = q[d];
    warm_out[(size_t)e * NV + d] = q[d] - qs[d];
  }
}

}  // namespace ant

// ---------------------------------------------------------------- launchers
// Each returns cudaGetLastError() after its launch on `stream`; dtype 0 is
// float32, 1 float64.  Mirrored by ops/ant_forward.py.

namespace {
constexpr int kThreads = 32;  // one warp a block: at B = 4,096, 128 blocks over 132 SMs

int blocks_for(int B) { return (B + kThreads - 1) / kThreads; }
}  // namespace

extern "C" int ant_forward_model_len(int n_slots) { return ant::M_SLOTS + ant::NSLOTW * n_slots; }

extern "C" int ant_smooth_launch(int dtype, int B, const void* mdl, const void* qpos,
                                 const void* qvel, const void* ctrl, void* M, void* qs,
                                 void* skin, void* stream) {
  if (B <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    ant::ant_smooth_kernel<float><<<blocks_for(B), kThreads, 0, st>>>(
        B, (const float*)mdl, (const float*)qpos, (const float*)qvel, (const float*)ctrl,
        (float*)M, (float*)qs, (float*)skin);
  else if (dtype == 1)
    ant::ant_smooth_kernel<double><<<blocks_for(B), kThreads, 0, st>>>(
        B, (const double*)mdl, (const double*)qpos, (const double*)qvel, (const double*)ctrl,
        (double*)M, (double*)qs, (double*)skin);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int ant_rows_launch(int dtype, int B, int n_slots, int ne, const void* mdl,
                               const void* tables, const void* skin, const void* qpos,
                               const void* qvel, void* vals, void* aref, void* r, void* active,
                               void* stream) {
  if (B <= 0 || n_slots < 0 || ne != ant::NLIM + 4 * (ant::NFLOOR + ant::NSLOT_CAND * n_slots))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    ant::ant_rows_kernel<float><<<blocks_for(B), kThreads, 0, st>>>(
        B, n_slots, (const float*)mdl, (const int*)tables, ne, (const float*)skin,
        (const float*)qpos, (const float*)qvel, (float*)vals, (float*)aref, (float*)r,
        (float*)active);
  else if (dtype == 1)
    ant::ant_rows_kernel<double><<<blocks_for(B), kThreads, 0, st>>>(
        B, n_slots, (const double*)mdl, (const int*)tables, ne, (const double*)skin,
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
                                 void* warm_out, void* s_idx, void* s_D, void* s_slack,
                                 void* s_jdq, void* stream) {
  if (B <= 0 || ne <= 0 || iters < 0 || ls_iters < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    ant::ant_newton_kernel<float><<<blocks_for(B), kThreads, 0, st>>>(
        B, ne, iters, ls_iters, (const int*)tables, (const float*)M, (const float*)qs,
        (const float*)vals, (const float*)aref, (const float*)r, (const float*)active,
        (const float*)warm, (float*)qacc, (float*)warm_out, (int*)s_idx, (float*)s_D,
        (float*)s_slack, (float*)s_jdq);
  else if (dtype == 1)
    ant::ant_newton_kernel<double><<<blocks_for(B), kThreads, 0, st>>>(
        B, ne, iters, ls_iters, (const int*)tables, (const double*)M, (const double*)qs,
        (const double*)vals, (const double*)aref, (const double*)r, (const double*)active,
        (const double*)warm, (double*)qacc, (double*)warm_out, (int*)s_idx, (double*)s_D,
        (double*)s_slack, (double*)s_jdq);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
