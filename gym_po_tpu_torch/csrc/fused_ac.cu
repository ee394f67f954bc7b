// Fused tabular actor-critic on ROOMS for Hopper (sm_90a): the whole
// trainer, K steps of sampling, stepping and updating, in one launch.
//
// Replaces the TPU kernel gym_po_tpu/ops/fused_ac.py::make_fused_ac_trainer_rooms:
// one-step actor-critic (Sutton & Barto ch. 13) with a softmax policy over
// logits theta[obs, a] and a value table v[obs], a fixed goal, and the
// observation index of each cell from a per-cell table.  Per env and step:
//
//   a     = argmax_a' (theta[obs, a'] + Gumbel)      (Gumbel-max sampling)
//   delta = r + gamma * v[obs'] * (1 - done) - v[obs]
//   v[obs]        += alpha_v  * delta
//   theta[obs, a'] += alpha_pi * delta * (1[a' = a] - pi(a' | obs))  for all a'
//
// each of the A + 1 updates averaged over the envs that visited obs in the
// step.  The plain PyTorch twin is gym_po_tpu_torch/ops/fused_ac.py.
//
// What bounds it on this card: as for the Q trainers (fused_qlearning.cu),
// the step-to-step dependence.  It is one persistent cooperative launch
// with one grid.sync() per step.  Each env adds A + 1 int64 fixed-point
// terms and one count per step (the count of an observation is the count of
// every one of its A + 1 entries, so one word serves them all) onto the
// A + 1 entries of its observation: at A = 8, 10 adds per env-step onto at
// most 9 * n_obs entries.  The per-env work is three Philox blocks (11 draw
// sites), A Gumbel draws of two logf each and A expf.  The bytes are tiny.
//
// Design:
//  * Geometry, lookups and fixed-point sums from tabular.cuh; the ROOMS
//    step from rooms_step.cuh.  Each block keeps theta's A * 512 used
//    entries and v's 512 (banks 0..3) in shared memory, and reads them
//    there for the whole call.
//  * The updates go through gpt::BlockSums<A + 1>: each block sums its
//    envs' terms in shared memory, one count word per observation and its
//    A + 1 sums at j * slab_stride(n_obs) + obs (theta's action j, v at
//    j = A); one thread per observation then adds them to the step's global
//    accumulator, once per block.  After the step's one grid barrier every
//    block applies the sums to its own theta and v, one thread per
//    observation, and theta and v reach th_out and v_out once, after the
//    last step.
//  * The Gumbel uniform is (r24 + 0.5) * 2^-24, strictly inside (0, 1);
//    the transcendentals are logf and expf, not the fast intrinsics, and
//    the build has no --use_fast_math; every other float operation is a
//    __fadd_rn/__fsub_rn/__fmul_rn/__fdiv_rn, rounded as the twin rounds.
//
// Draw sites per step, in body order, every step whatever the masks say:
// A Gumbel r24, the failure coin r24() < int(p * 2^24), the alternative
// action rbits(A - 1), the agent respawn (random agent only).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_rng.cuh"
#include "rooms_step.cuh"
#include "tabular.cuh"

namespace cg = cooperative_groups;

// Mirrored field for field by _ACParams in ops/fused_ac.py.
struct ACParams {
  int32_t num_envs, num_steps, rows_per_tile, n_sites;
  int32_t ncells, n_valid, n_act, time_limit;
  int32_t nsp;  // stride between actions in the flat tables (512)
  int32_t nq;   // entries of each banked table
  int32_t goal, fixed_agent, pfail24;
  uint32_t key0, key1;
  float r_step, r_wall, r_goal, gamma, alpha_pi, alpha_v;
  int32_t n_obs;  // observations (at most nsp)
};

namespace {

template <int NBLK, int A>
__global__ void __launch_bounds__(gpt::kTrainerThreads, gpt::kMinBlocksPerSM)
fused_ac_kernel(ACParams P, int envs_per_thread,
                const int32_t* __restrict__ agent_in,
                int32_t* __restrict__ agent_out, float* __restrict__ rew_out,
                const float* __restrict__ th_in, const float* __restrict__ v_in,
                float* th_out, float* v_out, long long* acc, int* cnt,
                const uint8_t* __restrict__ wall,
                const int32_t* __restrict__ valid,
                const int32_t* __restrict__ disp,
                const int32_t* __restrict__ obs_t,
                const int32_t* __restrict__ tape) {
  cg::grid_group grid = cg::this_grid();
  const int nsp = P.nsp, nth = A * nsp, nc = P.ncells;
  const int no = gpt::slab_stride(P.n_obs);
  extern __shared__ float smem[];
  float* s_th = smem;
  float* s_v = s_th + nth;
  // theta and v are read from the block's copy until the end: every entry
  // takes its "+ 0" here (-0 becomes +0), as each step's whole-table add
  // does in the twin
  for (int i = threadIdx.x; i < nth; i += blockDim.x)
    s_th[i] = P.num_steps ? __fadd_rn(th_in[i], 0.f) : th_in[i];
  for (int i = threadIdx.x; i < nsp; i += blockDim.x)
    s_v[i] = P.num_steps ? __fadd_rn(v_in[i], 0.f) : v_in[i];
  // sums j * no + obs: theta's action j < A, v at j = A
  const gpt::BlockSums<A + 1> sums(s_v + nsp, acc, cnt, no);
  int32_t* s_obs = static_cast<int32_t*>(sums.end());
  int32_t* s_valid = s_obs + nc;
  int32_t* s_disp = s_valid + P.n_valid;
  uint8_t* s_wall = reinterpret_cast<uint8_t*>(s_disp + A);
  for (int i = threadIdx.x; i < nc; i += blockDim.x) {
    s_obs[i] = obs_t[i];
    s_wall[i] = wall[i];
  }
  for (int i = threadIdx.x; i < P.n_valid; i += blockDim.x) s_valid[i] = valid[i];
  for (int i = threadIdx.x; i < A; i += blockDim.x) s_disp[i] = disp[i];
  __syncthreads();

  const int B = P.num_envs;
  const int nthreads = gridDim.x * blockDim.x;
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  const gpt::RoomsMap M = {nc, P.n_valid, P.time_limit,
                           P.r_step, P.r_wall, P.r_goal};

  // the entries no update reaches (theta past A actions, v past bank 3)
  // come out as in + 0, as in the JAX kernel's whole-table adds
  for (int i = gtid; i < P.nq; i += nthreads) {
    if (i >= nth) th_out[i] = P.num_steps ? __fadd_rn(th_in[i], 0.f) : th_in[i];
    if (i >= nsp) v_out[i] = P.num_steps ? __fadd_rn(v_in[i], 0.f) : v_in[i];
  }

  // per-env state; an agent outside the grid is inactive (agent' = -1,
  // NaN reward sum), as in the twin
  int s_l[gpt::kMaxEnvsPerThread], el_l[gpt::kMaxEnvsPerThread];
  float racc_l[gpt::kMaxEnvsPerThread];
  for (int i = 0; i < envs_per_thread; ++i) {
    const long long e = gtid + (long long)i * nthreads;
    const int s = e < B ? agent_in[e] : -1;
    s_l[i] = (unsigned)s < (unsigned)nc ? s : -1;
    el_l[i] = 0;
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
      const int qidx = s_obs[s];
      float lg[A];
      gpt::lookup<A>(s_th, qidx, nsp, lg);
      // Gumbel-max sampling from the softmax policy
      float pert[A];
#pragma unroll
      for (int a = 0; a < A; ++a) {
        const float u = __fmul_rn(
            __fadd_rn(__int2float_rn(gpt::r24(rng.draw(a))), 0.5f),
            5.9604644775390625e-08f);  // 2^-24
        pert[a] = __fadd_rn(lg[a], -logf(-logf(u)));
      }
      float unused, mx;
      const int a_cmd = gpt::first_argmax<A>(pert, unused);
      gpt::first_argmax<A>(lg, mx);
      // softmax probabilities, the max subtracted
      float ex[A];
#pragma unroll
      for (int a = 0; a < A; ++a) ex[a] = expf(__fsub_rn(lg[a], mx));
      float z = ex[0];
#pragma unroll
      for (int a = 1; a < A; ++a) z = __fadd_rn(z, ex[a]);

      // --- env step ---
      const bool fail = gpt::r24(rng.draw(A)) < P.pfail24;
      const int alt = gpt::rbits(rng.draw(A + 1), A - 1);
      int elapsed = el_l[i];
      const gpt::RoomsMove mv =
          gpt::rooms_move(M, s_wall, s_disp, s, P.goal,
                          gpt::rooms_executed(fail, alt, a_cmd), elapsed);
      const int spawn = P.fixed_agent >= 0
                            ? P.fixed_agent
                            : gpt::rooms_spawn(s_valid, P.n_valid, rng.draw(A + 2));

      // --- one-step TD error from the state before the respawn ---
      const float v_next = s_v[s_obs[mv.agent]];
      const float delta = __fsub_rn(
          __fadd_rn(mv.rew, __fmul_rn(__fmul_rn(P.gamma, v_next),
                                      mv.done ? 0.0f : 1.0f)),
          s_v[qidx]);
      bool ok = sums.add(A, qidx, __fmul_rn(P.alpha_v, delta));
      const float ad = __fmul_rn(P.alpha_pi, delta);
#pragma unroll
      for (int a = 0; a < A; ++a) {
        const float grad = __fsub_rn(a == a_cmd ? 1.0f : 0.0f, __fdiv_rn(ex[a], z));
        ok &= sums.add(a, qidx, __fmul_rn(ad, grad));
      }
      sums.count(qidx);
      if (!ok) sums.flag(t, qidx);

      s_l[i] = mv.reset ? spawn : mv.agent;
      el_l[i] = elapsed;
      racc_l[i] = racc_l[i] + mv.rew;
    }

    // --- the block's sums out, one barrier, every block applies them ---
    __syncthreads();
    sums.flush(t);
    grid.sync();
    sums.apply(t, [&](int o, int k, const long long* g) {
      s_v[o] = __fadd_rn(s_v[o], gpt::fix_delta(__ldcg(g + A * no + o), k, true));
#pragma unroll
      for (int a = 0; a < A; ++a) {
        float& th = s_th[a * nsp + o];
        th = __fadd_rn(th, gpt::fix_delta(__ldcg(g + a * no + o), k, true));
      }
    });
    sums.clear_ahead(t);
    __syncthreads();
  }
  // every block holds the same tables
  for (int i = gtid; i < nth || i < nsp; i += nthreads) {
    if (i < nth) th_out[i] = s_th[i];
    if (i < nsp) v_out[i] = s_v[i];
  }

  for (int i = 0; i < envs_per_thread; ++i) {
    const long long e = gtid + (long long)i * nthreads;
    if (e >= B) break;
    agent_out[e] = s_l[i];
    rew_out[e] = s_l[i] < 0 ? __int_as_float(0x7fc00000) : racc_l[i];
  }
}

template <int NBLK, int A>
int launch(const ACParams* P, const void* agent_in, void* agent_out,
           void* rew_out, const void* th_in, const void* v_in, void* th_out,
           void* v_out, void* acc, void* cnt, const void* wall,
           const void* valid, const void* disp, const void* obs_t,
           const void* tape, int* grid_out, void* stream) {
  if (P->n_sites > 4 * NBLK || P->nq < A * P->nsp || P->n_obs < 1 ||
      gpt::slab_stride(P->n_obs) > P->nsp)
    return (int)cudaErrorInvalidValue;
  auto kern = fused_ac_kernel<NBLK, A>;
  const size_t smem = sizeof(float) * (A + 1) * P->nsp +
                      gpt::BlockSums<A + 1>::smem_bytes(gpt::slab_stride(P->n_obs)) +
                      sizeof(int32_t) * (P->ncells + P->n_valid + A) +
                      ((P->ncells + 3) / 4) * 4;
  int blocks = 0, ept = 0;
  cudaError_t err = gpt::coop_geometry(kern, smem, P->num_envs, &blocks, &ept);
  if (err != cudaSuccess) return (int)err;
  grid_out[0] = blocks;
  grid_out[1] = ept;
  ACParams p = *P;
  void* args[] = {&p, &ept, (void*)&agent_in, &agent_out, &rew_out,
                  (void*)&th_in, (void*)&v_in, &th_out, &v_out, &acc, &cnt,
                  (void*)&wall, (void*)&valid, (void*)&disp, (void*)&obs_t,
                  (void*)&tape};
  err = cudaLaunchCooperativeKernel((const void*)kern, dim3(blocks),
                                    dim3(gpt::kTrainerThreads), args, smem,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// acc: 3 x (A + 1) * slab_stride(n_obs) int64 and cnt: 3 x slab_stride(n_obs)
// int32 scratch, buffers 0 and 1 zero
extern "C" int fused_ac_launch(const ACParams* P, const void* agent_in,
                               void* agent_out, void* rew_out,
                               const void* th_in, const void* v_in,
                               void* th_out, void* v_out, void* acc, void* cnt,
                               const void* wall, const void* valid,
                               const void* disp, const void* obs_t,
                               const void* tape, int* grid_out, void* stream) {
  // A Gumbel draws + failure coin + alternative + respawn: 11 sites at
  // A = 8 (three Philox blocks), 7 at A = 4 (two)
  if (P->n_act == 8)
    return launch<3, 8>(P, agent_in, agent_out, rew_out, th_in, v_in, th_out,
                        v_out, acc, cnt, wall, valid, disp, obs_t, tape,
                        grid_out, stream);
  if (P->n_act == 4)
    return launch<2, 4>(P, agent_in, agent_out, rew_out, th_in, v_in, th_out,
                        v_out, acc, cnt, wall, valid, disp, obs_t, tape,
                        grid_out, stream);
  return (int)cudaErrorInvalidValue;
}
