// Fused tabular Q-learning on continuous-state rooms (CRooms) for Hopper
// (sm_90a): the whole trainer, K steps of acting, stepping and updating, in
// one launch.
//
// Replaces the TPU kernel
// gym_po_tpu/ops/fused_q_crooms.py::make_fused_q_trainer_crooms (one Pallas
// program over [R, 128] VMEM tiles of f32 positions and velocities, the Q
// banks in VMEM, every table lookup a lane shuffle per 128-lane row and the
// update an MXU mask scatter).  Epsilon-greedy acting on the Q of the
// agent's discretized cell, the discrete-action CRooms physics (failure
// resample of the commanded action, per-component Box-Muller action noise,
// position clip, wall test, in-cell resample of a wall hit), the TD target
// from the position before the respawn, and Q[obs, a] += lr * td summed or
// averaged over duplicates, every step.  The plain PyTorch twin is
// gym_po_tpu_torch/ops/fused_q_crooms.py.
//
// What bounds it on this card: the step-to-step dependence, as in the other
// trainers (fused_qlearning.cu's note): every step reads the table that all
// B envs updated in the step before.  So this is one persistent cooperative
// launch over a table of at most 4,096 entries, on the one step protocol of
// the other one-step trainers (tabular.cuh, BlockSums<1>): each step's
// terms are summed per block in a shared-memory slab at the compact index
// a * slab_stride(n_obs) + obs, the block adds each word it touched to the
// step's global accumulator once, one grid.sync(), and every block applies
// the step's sums to its own copy of the table; the three accumulators
// rotate, and the table reaches q_out once, after the last step.  Where the
// slab does not fit beside a launch that takes the batch (the largest
// observation counts at B = 2^20), the terms go straight into the step's
// global accumulator, under the same rotation, barrier and apply;
// grid_out[2] says which.  The apply maps a compact index back to the
// table by an invariant divisor (gpt::UDiv), so the step loop divides no
// integer at run time.
//
// The per-env work is larger than ROOMS' (the float step and Box-Muller
// normals), and most of it is rare: a step needs Philox blocks 0 and 1 and
// the action's two normals, a wall hit (about one env-step in eleven at the
// registry's defaults) also block 2 and the resample's two normals, and an
// episode's end with a random agent block 3 and the spawn.  So the kernel
// draws through gpt::LazyRNG and branches plainly on the hit and the reset,
// as the rollout fused_crooms.cu does; a warp in which no env hits skips
// the resample.
//
// Design: the state is four floats per env (position and velocity), where
// fused_q_kernel in fused_qlearning.cu carries one int, so this is a kernel
// of its own over the same pieces: tabular.cuh's lookups, first argmax,
// fixed-point update sums (kernel = twin bit for bit, whatever the order of
// the atomics), BlockSums and cooperative geometry, and crooms_step.cuh's
// step parts, shared with the rollout.  Each block keeps the flat table, the
// slab, the padded observation and wall banks, the walkable cells and the A
// displacements in shared memory.  Each thread owns up to kMaxEnvsPerThread
// envs for all K steps.  The float arithmetic is __fmul_rn/__fadd_rn/
// __fsub_rn/__fdiv_rn, never contracted into an FMA, so it rounds as the
// twin does; the division by a power-of-two cell size is a multiply that
// rounds the same (crooms_step.cuh, over_cs), and the respawn reduces its
// draw by invariant divisors.
//
// Draw sites per step, in body order: explore r24, random action rbits(A),
// failure coin r24() < int(p * 2^24), alternative action rbits(A - 1), the
// ay and ax normals (two draws each) (sites 0-7, blocks 0 and 1, every
// step), the wall-resample normals ry and rx (two each, sites 8-11, block
// 2, where the env hits a wall), agent respawn (random agent only, site 12,
// block 3, where the episode ends).  The twin draws every site every step;
// the draws skipped here are ones it discards.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "crooms_step.cuh"
#include "kernel_rng.cuh"
#include "rooms_step.cuh"
#include "tabular.cuh"

namespace cg = cooperative_groups;

// Mirrored field for field by _QCRoomsParams in ops/fused_q_crooms.py.
struct QCRoomsParams {
  int32_t num_envs, num_steps, rows_per_tile, n_sites;
  int32_t W, nbank, n_valid, n_act, use_vel, rand_agent, time_limit;
  int32_t nsp;  // stride between actions in the flat table (nsb * 128)
  int32_t nq;   // entries of the flat table
  int32_t average, pfail24;
  uint32_t key0, key1;
  float cs, half, pos_hi_y, pos_hi_x, thr2, r_step, r_wall, r_goal;
  float std, power, goal_y, goal_x, agent_y, agent_x;  // fixed goal and agent
  float gamma, lr, eps;
  float inv_cs;  // 2^-k where cs = 2^k, else 0 (crooms_step.cuh, over_cs)
  gpt::UDiv valid_div, col_div;  // n_valid and W, for the respawn
  int32_t n_obs;  // values of the Q index
  gpt::UDiv stride_div;  // slab_stride(n_obs): the update sums' row stride
};

namespace {

constexpr int kMaxEnvs = gpt::kMaxEnvsPerThread;

// the state tiles in and out, the tables (wall bank, walkable cells,
// observation bank, the actions' dy and dx), by value
struct QCRoomsPtrs {
  const float* in[4];
  float* out[5];  // py, px, vy, vx, reward sums
  const uint8_t* wall;
  const int32_t *valid, *obs;
  const float *dy, *dx;
};

// The K steps of one trainer launch.  on_chip: the update sums' slab is in
// shared memory.  At most 64 registers (the launch bounds), so that
// B = 2^20 launches.
template <int A, bool kVel, bool kRandAgent>
__global__ void __launch_bounds__(gpt::kTrainerThreads, gpt::kMinBlocksPerSM)
fused_q_crooms_kernel(QCRoomsParams P, int envs_per_thread, int on_chip,
                      QCRoomsPtrs p, const float* __restrict__ q_in,
                      float* q_out, long long* acc, int* cnt,
                      const int32_t* __restrict__ tape) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  float* s_q = smem;
  // the table is read from the block's own copy until the end: every entry
  // takes its "+ 0" here (-0 becomes +0), as each step's whole-table add
  // does in the twin
  for (int i = threadIdx.x; i < P.nq; i += blockDim.x)
    s_q[i] = P.num_steps ? __fadd_rn(q_in[i], 0.f) : q_in[i];
  const int no = gpt::slab_stride(P.n_obs);
  const gpt::BlockSums<1> sums(s_q + P.nq, acc, cnt, A * no, on_chip != 0);
  float* s_dy = static_cast<float*>(sums.end());
  float* s_dx = s_dy + A;
  int32_t* s_obs = reinterpret_cast<int32_t*>(s_dx + A);
  int32_t* s_valid = s_obs + P.nbank;
  uint8_t* s_wall = reinterpret_cast<uint8_t*>(s_valid + P.n_valid);
  for (int i = threadIdx.x; i < A; i += blockDim.x) {
    s_dy[i] = p.dy[i];
    s_dx[i] = p.dx[i];
  }
  for (int i = threadIdx.x; i < P.nbank; i += blockDim.x) {
    s_obs[i] = p.obs[i];
    s_wall[i] = p.wall[i];
  }
  for (int i = threadIdx.x; i < P.n_valid; i += blockDim.x) s_valid[i] = p.valid[i];
  __syncthreads();

  const int B = P.num_envs;
  const int nthreads = gridDim.x * blockDim.x;
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  const bool average = P.average != 0;
  const int eps24 = __float2int_rz(__fmul_rn(P.eps, 16777216.0f));
  // table index of compact index c = a * no + obs: a * nsp + obs
  const int row_gap = P.nsp - no;
  const gpt::CRoomsMap M = {P.W, P.nbank, P.time_limit, P.cs, P.half,
                            P.pos_hi_y, P.pos_hi_x, P.thr2, P.r_step, P.r_wall,
                            P.r_goal, P.inv_cs};

  float py_l[kMaxEnvs], px_l[kMaxEnvs], vy_l[kMaxEnvs], vx_l[kMaxEnvs];
  float racc_l[kMaxEnvs];
  int el_l[kMaxEnvs];
  for (int i = 0; i < envs_per_thread; ++i) {
    const long long e = gtid + (long long)i * nthreads;
    if (e >= B) break;
    py_l[i] = p.in[0][e];
    px_l[i] = p.in[1][e];
    vy_l[i] = p.in[2][e];
    vx_l[i] = p.in[3][e];
    el_l[i] = 0;
    racc_l[i] = 0.f;
  }

  for (int t = 0; t < P.num_steps; ++t) {
    for (int i = 0; i < envs_per_thread; ++i) {
      const long long e = gtid + (long long)i * nthreads;
      if (e >= B) break;
      // the batch is one tape tile: env e's tape offset is e
      gpt::LazyRNG rng(tape, e, P.key0, P.key1, e, P.num_steps, P.rows_per_tile);
      rng.begin_step(t);
      const gpt::U32x4 b0 = rng.block(0), b1 = rng.block(1);
      const float py = py_l[i], px = px_l[i];
      // --- act ---
      const int qidx = gpt::bank_at(s_obs, P.nbank, gpt::crooms_cell(M, py, px));
      float v[A], best_v;
      gpt::lookup<A>(s_q, qidx, P.nsp, v);
      const int greedy = gpt::first_argmax<A>(v, best_v);
      const bool explore = gpt::r24(rng.draw(0, b0)) < eps24;
      const int ra = gpt::rbits(rng.draw(1, b0), A);
      const int a = explore ? ra : greedy;
      const float q_taken = gpt::pick<A>(v, a);
      // --- env step: the executed action's displacement plus noise ---
      const bool fail = gpt::r24(rng.draw(2, b0)) < P.pfail24;
      const int alt = gpt::rbits(rng.draw(3, b0), A - 1);
      const int ex = gpt::rooms_executed(fail, alt, a);
      const float ay = gpt::crooms_disp_action(
          s_dy[ex], gpt::rnormal(rng.draw(4, b1), rng.draw(5, b1)), P.std, P.power);
      const float ax = gpt::crooms_disp_action(
          s_dx[ex], gpt::rnormal(rng.draw(6, b1), rng.draw(7, b1)), P.std, P.power);
      const gpt::CRoomsTry tr =
          gpt::crooms_try<kVel>(M, py, px, vy_l[i], vx_l[i], ay, ax);
      const bool oob =
          gpt::bank_at(s_wall, M.nbank, gpt::crooms_cell(M, tr.ny, tr.nx)) == 1;
      float ny = tr.ny, nx = tr.nx;
      if (oob) {
        // a wall hit: block 2 and the resample's two normals
        const gpt::U32x4 b2 = rng.block(2);
        const float nry = gpt::rnormal(rng.draw(8, b2), rng.draw(9, b2));
        const float nrx = gpt::rnormal(rng.draw(10, b2), rng.draw(11, b2));
        gpt::crooms_resample(M, py, px, nry, nrx, ny, nx);
      }
      int elapsed = el_l[i];
      const gpt::CRoomsMove mv =
          gpt::crooms_finish(M, oob, ny, nx, oob ? 0.0f : tr.vy,
                             oob ? 0.0f : tr.vx, P.goal_y, P.goal_x, elapsed);
      // --- TD target from the position before the respawn ---
      const int qidx2 = gpt::bank_at(s_obs, P.nbank, gpt::crooms_cell(M, mv.py, mv.px));
      float v2[A], next_v;
      gpt::lookup<A>(s_q, qidx2, P.nsp, v2);
      gpt::first_argmax<A>(v2, next_v);
      const float target = __fadd_rn(
          mv.rew, __fmul_rn(__fmul_rn(P.gamma, next_v), mv.done ? 0.0f : 1.0f));
      const float wd = __fmul_rn(P.lr, __fsub_rn(target, q_taken));
      sums.term(t, a * no + qidx, wd);
      // --- respawn ---
      float npy = mv.py, npx = mv.px, nvy = mv.vy, nvx = mv.vx;
      if (mv.reset) {
        npy = P.agent_y;
        npx = P.agent_x;
        if (kRandAgent) {
          const gpt::U32x4 b3 = rng.block(3);
          gpt::crooms_spawn(s_valid, P.valid_div, P.col_div, rng.draw(12, b3),
                            npy, npx);
        }
        nvy = 0.f;
        nvx = 0.f;
      }
      py_l[i] = npy;
      px_l[i] = npx;
      vy_l[i] = nvy;
      vx_l[i] = nvx;
      el_l[i] = elapsed;
      racc_l[i] = __fadd_rn(racc_l[i], mv.rew);
    }

    // --- the block's sums out, one barrier, every block applies them ---
    __syncthreads();
    sums.flush(t);
    grid.sync();
    sums.apply(t, [&](int c, int k, long long sum) {
      const int a = (int)gpt::udiv((uint32_t)c, P.stride_div);
      float& q = s_q[c + a * row_gap];
      q = __fadd_rn(q, gpt::fix_delta(sum, k, average));
    });
    sums.clear_ahead(t);
    __syncthreads();
  }
  // every block holds the same table (not unrolled: a trip count would
  // divide by nthreads)
#pragma unroll 1
  for (int i = gtid; i < P.nq; i += nthreads) q_out[i] = s_q[i];

  for (int i = 0; i < envs_per_thread; ++i) {
    const long long e = gtid + (long long)i * nthreads;
    if (e >= B) break;
    p.out[0][e] = py_l[i];
    p.out[1][e] = px_l[i];
    p.out[2][e] = vy_l[i];
    p.out[3][e] = vx_l[i];
    p.out[4][e] = racc_l[i];
  }
}

template <int A, bool kVel, bool kRandAgent>
int launch(const QCRoomsParams* P, const QCRoomsPtrs& ptrs, const void* q_in,
           void* q_out, void* acc, void* cnt, const void* tape, int* grid_out,
           void* stream) {
  auto kern = fused_q_crooms_kernel<A, kVel, kRandAgent>;
  const size_t base = sizeof(float) * (P->nq + 2 * A) +
                      sizeof(int32_t) * (P->nbank + P->n_valid) +
                      ((P->nbank + 3) / 4) * 4;
  const size_t slab = gpt::BlockSums<1>::smem_bytes(A * gpt::slab_stride(P->n_obs));
  size_t smem = 0;
  int blocks = 0, ept = 0, on_chip = 1;
  // the slab where a launch with it takes the batch
  cudaError_t err = gpt::coop_geometry_room(kern, base, slab, gpt::kMaxEnvsPerThread,
                                            P->num_envs, &blocks, &ept, &on_chip,
                                            &smem);
  if (err != cudaSuccess) return (int)err;
  grid_out[0] = blocks;
  grid_out[1] = ept;
  grid_out[2] = on_chip;
  QCRoomsParams p = *P;
  QCRoomsPtrs pp = ptrs;
  void* args[] = {&p, &ept, &on_chip, &pp, (void*)&q_in, &q_out, &acc, &cnt,
                  (void*)&tape};
  err = cudaLaunchCooperativeKernel((const void*)kern, dim3(blocks),
                                    dim3(gpt::kTrainerThreads), args, smem,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int A>
int launch_a(const QCRoomsParams* P, const QCRoomsPtrs& ptrs, const void* q_in,
             void* q_out, void* acc, void* cnt, const void* tape, int* grid_out,
             void* stream) {
  if (P->use_vel)
    return P->rand_agent
               ? launch<A, true, true>(P, ptrs, q_in, q_out, acc, cnt, tape, grid_out, stream)
               : launch<A, true, false>(P, ptrs, q_in, q_out, acc, cnt, tape, grid_out, stream);
  return P->rand_agent
             ? launch<A, false, true>(P, ptrs, q_in, q_out, acc, cnt, tape, grid_out, stream)
             : launch<A, false, false>(P, ptrs, q_in, q_out, acc, cnt, tape, grid_out, stream);
}

}  // namespace

// in: py, px, vy, vx; out: py', px', vy', vx', reward sums; tab: wall bank,
// walkable cells, observation bank, dy, dx.  acc (int64) and cnt (int32)
// are 3 * n_act * slab_stride(n_obs) words each, the first two thirds
// zeroed; grid_out gets (blocks, envs per thread, whether the update sums'
// slab is in shared memory).
extern "C" int fused_q_crooms_launch(const QCRoomsParams* P, const void* const* in,
                                     void* const* out, const void* q_in,
                                     void* q_out, void* acc, void* cnt,
                                     const void* const* tab, const void* tape,
                                     int* grid_out, void* stream) {
  // sites 0-12 in four blocks; the batch one tape tile; an observation
  // within the stride between actions
  if (P->n_sites != 12 + P->rand_agent ||
      (long long)P->rows_per_tile * 128 != P->num_envs || P->n_obs < 1 ||
      P->n_obs > P->nsp || P->stride_div.n != (uint32_t)gpt::slab_stride(P->n_obs))
    return (int)cudaErrorInvalidValue;
  QCRoomsPtrs ptrs;
  for (int i = 0; i < 4; ++i) ptrs.in[i] = static_cast<const float*>(in[i]);
  for (int i = 0; i < 5; ++i) ptrs.out[i] = static_cast<float*>(out[i]);
  ptrs.wall = static_cast<const uint8_t*>(tab[0]);
  ptrs.valid = static_cast<const int32_t*>(tab[1]);
  ptrs.obs = static_cast<const int32_t*>(tab[2]);
  ptrs.dy = static_cast<const float*>(tab[3]);
  ptrs.dx = static_cast<const float*>(tab[4]);
  if (P->n_act == 8)
    return launch_a<8>(P, ptrs, q_in, q_out, acc, cnt, tape, grid_out, stream);
  if (P->n_act == 4)
    return launch_a<4>(P, ptrs, q_in, q_out, acc, cnt, tape, grid_out, stream);
  return (int)cudaErrorInvalidValue;
}
