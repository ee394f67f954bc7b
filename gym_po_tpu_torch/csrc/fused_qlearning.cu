// Fused tabular Q-learning for Hopper (sm_90a): the whole trainer, K steps
// of acting, stepping and updating, in one launch.
//
// Replaces five TPU kernels:
//  * gym_po_tpu/ops/fused_qlearning.py::make_fused_q_trainer: epsilon-greedy
//    Q-learning on Taxi's classic and extended maps, Q indexed by state or
//    by Hansen obs, optional Expected-SARSA target, optional Watkins/Peng
//    Q(lambda) over a ring of the last L table addresses (entry point
//    fused_q_launch);
//  * gym_po_tpu/ops/fused_double_q.py::make_fused_double_q_trainer: double
//    Q-learning on the classic map, a per-env coin picking which of two
//    stacked tables is updated (entry point fused_double_q_launch);
//  * gym_po_tpu/ops/fused_qlearning.py::make_fused_q_trainer_rooms and
//    gym_po_tpu/ops/fused_qlambda.py::make_fused_qlambda_trainer_rooms:
//    one-step Q and Watkins/Peng Q(lambda) on ROOMS with a fixed goal, Q
//    indexed through a per-cell observation table, the update on the
//    commanded action (entry point fused_q_rooms_launch; lambda = 0 is the
//    one-step trainer, bit for bit);
//  * gym_po_tpu/ops/fused_qlearning.py::make_fused_q_trainer_msrooms:
//    one-step Q on MultistoryFourRooms with a fixed goal, over flat zyx
//    cells with the stair transit, Q indexed like ROOMS (entry point
//    fused_q_msrooms_launch).
// All are one kernel templated over the env (its step, its observation
// index and its action count).  The plain PyTorch twins are
// gym_po_tpu_torch/ops/fused_qlearning.py, ops/fused_double_q.py and
// ops/fused_qlambda.py.
//
// What bounds it on this card: the step-to-step dependence, not bytes or
// arithmetic.  Every step reads the Q table that all B envs updated in the
// step before, so the TPU kernel is one program over the whole batch (grid
// of 1).  Here it is one persistent cooperative launch with grid-wide
// barriers between the steps, and every env's update terms (L per env-step
// with a trace) are summed across the grid each step into a table of at
// most 7,168 entries.  The per-env work (two Philox blocks, a few div/mod,
// a dozen shared-memory lookups) is small beside that.  The bytes are tiny:
// 4 B of state in and out per env per call, and the table of at most 28 KB.
// The other way to order the steps, one launch per step, measured 1.7x
// slower per step replayed from a CUDA graph (PERF.md).
//
// One step protocol for every instance (gpt::BlockSums): the update terms
// (one per env-step, or L with a trace, which land on the entries along the
// env's recent path and pile onto the greedy actions') are summed per block
// in shared memory, and the block adds each entry it touched to the step's
// global accumulator once; one grid.sync() per step, after which every
// block applies the step's sums to its own copy of the table, and the three
// accumulators rotate so that none needs clearing between the barriers.
// The table reaches q_out once, after the last step.
//  * One-step (Q, double Q, E-SARSA): the slab (12 B per entry) sits beside
//    the table where a launch with it still takes the batch; otherwise (a
//    large table at a large batch: double Q at B = 2^20) each term goes
//    straight into the step's global accumulator, under the same rotation,
//    barrier and apply.  grid_out[2] says which.
//  * With a trace (Watkins/Peng Q(lambda)): the slab always; the ring of
//    the last L addresses of each env lives in shared memory
//    ([L][slots][threads]) when it fits beside the table and the sums with
//    one env per thread, and in the [L, B] scratch buffer otherwise (large
//    B).  grid_out[2] says which.
//
// Design:
//  * The grid is sized from the occupancy API to what is co-resident, and
//    each thread owns the envs gtid + i*nthreads for all K steps; their
//    state, counters, trace age and reward sum stay in thread-local arrays.
//  * Each block keeps a copy of the flat Q table in shared memory for the
//    lookups, beside the env's tables.  Entry (obs, a) sits at flat index
//    a*nsp + obs; the TPU's [nb, 128] lane banks and MXU mask scatter are
//    not carried over.  The trace's ring and the sums index the entries
//    compactly, a * slab_stride(n_obs) + obs, double Q's table B after
//    table A's kA * slab_stride(n_obs) words.
//  * The update sums are the int64 fixed point of tabular.cuh.  Tabular Q
//    from zeros is full of exact ties among actions, and a one-ulp
//    difference would flip an argmax.
//  * The env steps are taxi_step.cuh, rooms_step.cuh and msrooms_step.cuh,
//    shared with the rollouts.
//  * Float arithmetic that the twin rounds per operation (the TD target, the
//    Expected-SARSA blend, the trace weights) uses __fmul_rn/__fadd_rn/
//    __fsub_rn, which nvcc never contracts into an FMA.
//
// Draw sites per step, in body order, every step whatever the masks say:
// explore r24, random action rbits(A), [double Q: table coin rbits(2)],
// then the env's: Taxi's task pn, task d0, full-reset cell (rbits(rows) then
// rbits(cols) when every cell is valid, else one rbits(n_valid)), reset pr,
// reset dr0; ROOMS' failure coin r24() < int(p * 2^24), alternative action
// rbits(A - 1), agent respawn (random agent only); MultistoryFourRooms' the
// same three, the respawn from the ground-floor bank always drawn and taken,
// even where the env has a fixed agent (as the JAX kernel does).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_rng.cuh"
#include "msrooms_step.cuh"
#include "rooms_step.cuh"
#include "tabular.cuh"
#include "taxi_step.cuh"

namespace cg = cooperative_groups;

constexpr int kMaxTrace = 64;

// Mirrored field for field by _QParams in ops/fused_qlearning.py.  Outside
// the anonymous namespace: the extern "C" entry points take it, and a type
// with internal linkage would give them internal linkage too.  ROOMS reads
// rows x cols cells, r_goal, r_bad (a wall bump) and r_any (any other step);
// MultistoryFourRooms the same, with rows = Z * H, cols = W and the three
// stair fields.
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
  // ROOMS: actions, fixed goal and agent (flat cells; -1: drawn), and the
  // failure threshold int(p * 2^24)
  int32_t n_act, goal, fixed_agent, pfail24;
  // MultistoryFourRooms: cells per floor, and the in-floor cells that going
  // up and going down land on
  int32_t floor_cells, up_to, down_to;
  int32_t n_obs;  // values of the Q index (obs, or state for double Q)
  // MultistoryFourRooms: floor_cells as the step's invariant divisor (last,
  // so that the fields above keep the layout of the struct without it)
  gpt::UDiv floor_div;
};

namespace {

// What the trainer needs of one env step.
struct QStep {
  int s_td;    // the state the TD target bootstraps from (before a reset)
  int s_next;  // the next state, after a reset
  float rew;
  bool done;   // cuts the bootstrap
  bool reset;  // the episode ended: the trace dies
};

// Taxi: tab = cell_move [nc*4], loc_at [nc], hansen_cell [nc], valid cells.
struct TaxiQ {
  static constexpr int kA = 5;
  static size_t smem_tables(const QParams& P) {
    return sizeof(int32_t) * (P.rows * P.cols * 6 + P.n_valid);
  }
  gpt::TaxiMap M;
  const int32_t *cm, *la, *hc, *vc;
  int pd, nlocs, ns;
  bool hansen;

  __device__ TaxiQ(const QParams& P, int32_t* smem, const void* const* tab)
      : M{P.nlocs, P.rows, P.cols, P.n_valid, P.all_valid, P.n_pass,
          P.time_limit, P.r_goal, P.r_bad, P.r_any} {
    const int nc = P.rows * P.cols;
    int32_t* s_cm = smem;
    int32_t* s_la = s_cm + nc * 4;
    int32_t* s_hc = s_la + nc;
    int32_t* s_vc = s_hc + nc;
    const int32_t* t0 = static_cast<const int32_t*>(tab[0]);
    const int32_t* t1 = static_cast<const int32_t*>(tab[1]);
    const int32_t* t2 = static_cast<const int32_t*>(tab[2]);
    const int32_t* t3 = static_cast<const int32_t*>(tab[3]);
    for (int i = threadIdx.x; i < nc * 4; i += blockDim.x) s_cm[i] = t0[i];
    for (int i = threadIdx.x; i < nc; i += blockDim.x) {
      s_la[i] = t1[i];
      s_hc[i] = t2[i];
    }
    for (int i = threadIdx.x; i < P.n_valid; i += blockDim.x) s_vc[i] = t3[i];
    cm = s_cm;
    la = s_la;
    hc = s_hc;
    vc = s_vc;
    nlocs = P.nlocs;
    pd = (nlocs + 1) * nlocs;
    ns = nc * pd;
    hansen = P.hansen != 0;
  }
  __device__ bool in_range(int s) const { return (unsigned)s < (unsigned)ns; }
  __device__ int obs(int s) const {
    if (!hansen) return s;
    const int rc = s / pd, rem = s - (s / pd) * pd;
    return (hc[rc] * (nlocs + 1) + rem / nlocs) * nlocs + rem % nlocs;
  }
  template <class RNG>
  __device__ QStep step(const RNG& rng, int j, int s, int a, int& completed,
                        int& elapsed) const {
    const gpt::TaxiStep st =
        gpt::taxi_step(M, cm, la, vc, rng, j, s, a, completed, elapsed);
    return {st.s_mid, st.s_next, st.rew, st.done, st.reset};
  }
};

// ROOMS, A actions: tab = wall bytes [ncells], valid cells, flat
// displacements [A], observation index per cell [ncells].
template <int A>
struct RoomsQ {
  static constexpr int kA = A;
  static size_t smem_tables(const QParams& P) {
    const int nc = P.rows * P.cols;
    return sizeof(int32_t) * (nc + P.n_valid + A) + ((nc + 3) / 4) * 4;
  }
  gpt::RoomsMap M;
  const int32_t *obs_t, *valid, *disp;
  const uint8_t* wall;
  int goal, fixed_agent, pfail24;

  __device__ RoomsQ(const QParams& P, int32_t* smem, const void* const* tab)
      : M{P.rows * P.cols, P.n_valid, P.time_limit, P.r_any, P.r_bad,
          P.r_goal},
        goal(P.goal), fixed_agent(P.fixed_agent), pfail24(P.pfail24) {
    const int nc = M.ncells;
    int32_t* s_obs = smem;
    int32_t* s_valid = s_obs + nc;
    int32_t* s_disp = s_valid + P.n_valid;
    uint8_t* s_wall = reinterpret_cast<uint8_t*>(s_disp + A);
    const uint8_t* t0 = static_cast<const uint8_t*>(tab[0]);
    const int32_t* t1 = static_cast<const int32_t*>(tab[1]);
    const int32_t* t2 = static_cast<const int32_t*>(tab[2]);
    const int32_t* t3 = static_cast<const int32_t*>(tab[3]);
    for (int i = threadIdx.x; i < nc; i += blockDim.x) {
      s_wall[i] = t0[i];
      s_obs[i] = t3[i];
    }
    for (int i = threadIdx.x; i < P.n_valid; i += blockDim.x) s_valid[i] = t1[i];
    for (int i = threadIdx.x; i < A; i += blockDim.x) s_disp[i] = t2[i];
    obs_t = s_obs;
    valid = s_valid;
    disp = s_disp;
    wall = s_wall;
  }
  __device__ bool in_range(int s) const {
    return (unsigned)s < (unsigned)M.ncells;
  }
  __device__ int obs(int s) const { return obs_t[s]; }
  template <class RNG>
  __device__ QStep step(const RNG& rng, int j, int s, int a, int& /*completed*/,
                        int& elapsed) const {
    const bool fail = gpt::r24(rng.draw(j)) < pfail24;
    const int alt = gpt::rbits(rng.draw(j + 1), A - 1);
    const gpt::RoomsMove mv = gpt::rooms_move(
        M, wall, disp, s, goal, gpt::rooms_executed(fail, alt, a), elapsed);
    const int spawn = fixed_agent >= 0
                          ? fixed_agent
                          : gpt::rooms_spawn(valid, M.n_valid, rng.draw(j + 2));
    return {mv.agent, mv.reset ? spawn : mv.agent, mv.rew, mv.done, mv.reset};
  }
};

// MultistoryFourRooms, A actions: tab = cell codes [ncells], ground-floor
// cells (the agent's spawn bank), flat displacements [A], observation index
// per cell [ncells].
template <int A>
struct MSRoomsQ {
  static constexpr int kA = A;
  static size_t smem_tables(const QParams& P) {
    const int nc = P.rows * P.cols;
    return sizeof(int32_t) * (nc + P.n_valid + A) + ((nc + 3) / 4) * 4;
  }
  gpt::MSRoomsMap M;
  const int32_t *obs_t, *bank, *disp;
  const uint8_t* cell;
  int n_bank, goal, pfail24;

  __device__ MSRoomsQ(const QParams& P, int32_t* smem, const void* const* tab)
      : M{P.rows * P.cols, P.floor_div, P.up_to, P.down_to, P.time_limit,
          P.r_any, P.r_bad, P.r_goal},
        n_bank(P.n_valid), goal(P.goal), pfail24(P.pfail24) {
    const int nc = M.ncells;
    int32_t* s_obs = smem;
    int32_t* s_bank = s_obs + nc;
    int32_t* s_disp = s_bank + P.n_valid;
    uint8_t* s_cell = reinterpret_cast<uint8_t*>(s_disp + A);
    const uint8_t* t0 = static_cast<const uint8_t*>(tab[0]);
    const int32_t* t1 = static_cast<const int32_t*>(tab[1]);
    const int32_t* t2 = static_cast<const int32_t*>(tab[2]);
    const int32_t* t3 = static_cast<const int32_t*>(tab[3]);
    for (int i = threadIdx.x; i < nc; i += blockDim.x) {
      s_cell[i] = t0[i];
      s_obs[i] = t3[i];
    }
    for (int i = threadIdx.x; i < P.n_valid; i += blockDim.x) s_bank[i] = t1[i];
    for (int i = threadIdx.x; i < A; i += blockDim.x) s_disp[i] = t2[i];
    obs_t = s_obs;
    bank = s_bank;
    disp = s_disp;
    cell = s_cell;
  }
  __device__ bool in_range(int s) const {
    return (unsigned)s < (unsigned)M.ncells;
  }
  __device__ int obs(int s) const { return obs_t[s]; }
  template <class RNG>
  __device__ QStep step(const RNG& rng, int j, int s, int a, int& /*completed*/,
                        int& elapsed) const {
    const bool fail = gpt::r24(rng.draw(j)) < pfail24;
    const int alt = gpt::rbits(rng.draw(j + 1), A - 1);
    const gpt::RoomsMove mv = gpt::msrooms_move(
        M, cell, disp, s, goal, gpt::rooms_executed(fail, alt, a), elapsed);
    const int spawn = bank[gpt::rbits(rng.draw(j + 2), n_bank)];
    return {mv.agent, mv.reset ? spawn : mv.agent, mv.rew, mv.done, mv.reset};
  }
};

// Words of the update sums: kA * slab_stride(n_obs) entries a table.
template <int kA, bool kDouble>
__host__ __device__ int sum_words(const QParams& P) {
  return (kDouble ? 2 : 1) * kA * gpt::slab_stride(P.n_obs);
}

#define Q_KERNEL_ARGS                                                         \
  QParams P, int envs_per_thread, int on_chip, int ring_slots,                \
      const int32_t *__restrict__ s_in, int32_t *__restrict__ s_out,          \
      float *__restrict__ rew_out, const float *__restrict__ q_in,            \
      float *q_out, long long *acc, int *cnt, int *ring, const void *tab0,    \
      const void *tab1, const void *tab2, const void *tab3,                   \
      const int32_t *__restrict__ tape

// The K steps of one trainer launch.  on_chip: the update sums' slab is in
// shared memory (always with a trace); ring_slots: the trace ring is.
// At most 64 registers (the launch bounds), so that B = 2^20 launches.
template <int NBLK, bool kDouble, bool kTrace, class Env>
__global__ void __launch_bounds__(gpt::kTrainerThreads, gpt::kMinBlocksPerSM)
fused_q_kernel(Q_KERNEL_ARGS) {
  constexpr int kA = Env::kA;
  static_assert(!(kTrace && kDouble), "the trace is single-table");
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  float* s_q = smem;
  // the table is read from the block's own copy until the end: every entry
  // takes its "+ 0" here (-0 becomes +0), as each step's whole-table add
  // does in the twin
  for (int i = threadIdx.x; i < P.nq; i += blockDim.x)
    s_q[i] = P.num_steps ? __fadd_rn(q_in[i], 0.f) : q_in[i];
  const int no = gpt::slab_stride(P.n_obs);
  const gpt::BlockSums<1> sums(s_q + P.nq, acc, cnt, sum_words<kA, kDouble>(P),
                               kTrace || on_chip);
  int* s_ring = static_cast<int*>(sums.end());
  const int L = P.trace_len;
  const void* const tab[4] = {tab0, tab1, tab2, tab3};
  const Env env(P, s_ring + (kTrace ? ring_slots * L * blockDim.x : 0), tab);
  __syncthreads();

  const int B = P.num_envs;
  const int nthreads = gridDim.x * blockDim.x;
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  const int nsp = P.nsp;
  const bool average = P.average != 0;
  // the trace ring: L compact addresses per env, [L][slots][threads] in
  // shared memory, or [L, B] in global memory
  int* const ring_base = ring_slots ? s_ring : ring;
  const long long ring_stride =
      ring_slots ? (long long)ring_slots * blockDim.x : (long long)B;
  const int eps24 = __float2int_rz(__fmul_rn(P.eps, 16777216.0f));
  const int nq1 = P.nq / 2;  // double Q: table B starts here

  // per-env state; an env whose input state is out of range is inactive:
  // it draws nothing that matters, updates nothing, and comes out as
  // s' = -1 with a NaN reward sum, as in the twin
  int s_l[gpt::kMaxEnvsPerThread], comp_l[gpt::kMaxEnvsPerThread];
  int el_l[gpt::kMaxEnvsPerThread], age_l[gpt::kMaxEnvsPerThread];
  float racc_l[gpt::kMaxEnvsPerThread];
  for (int i = 0; i < envs_per_thread; ++i) {
    const long long e = gtid + (long long)i * nthreads;
    const int s = e < B ? s_in[e] : -1;
    s_l[i] = env.in_range(s) ? s : -1;
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
      const int qidx = kDouble ? s : env.obs(s);  // double Q: by state
      float va[kA], vb[kA];
      gpt::lookup<kA>(s_q, qidx, nsp, va);
      float best_v;
      int greedy;
      if (kDouble) {
        gpt::lookup<kA>(s_q + nq1, qidx, nsp, vb);
        float vs[kA];
#pragma unroll
        for (int a = 0; a < kA; ++a) vs[a] = __fadd_rn(va[a], vb[a]);
        greedy = gpt::first_argmax<kA>(vs, best_v);
      } else {
        greedy = gpt::first_argmax<kA>(va, best_v);
      }
      const bool explore = gpt::r24(rng.draw(j++)) < eps24;
      const int ra = gpt::rbits(rng.draw(j++), kA);
      const int a = explore ? ra : greedy;
      const int coin = kDouble ? gpt::rbits(rng.draw(j++), 2) : 0;
      const float q_taken =
          (kDouble && coin) ? gpt::pick<kA>(vb, a) : gpt::pick<kA>(va, a);
      int age = age_l[i];
      // Watkins cut before the update (argmax ties count as greedy)
      if (kTrace && P.watkins_cut && q_taken < best_v) age = 0;

      // --- env step ---
      int completed = comp_l[i], elapsed = el_l[i];
      const QStep st = env.step(rng, j, s, a, completed, elapsed);

      // --- TD target from the state before the reset ---
      const int qidx2 = kDouble ? st.s_td : env.obs(st.s_td);
      float va2[kA];
      gpt::lookup<kA>(s_q, qidx2, nsp, va2);
      float next_v;
      if (kDouble) {
        // select with the updating table, evaluate with the other one
        float vb2[kA], mx;
        gpt::lookup<kA>(s_q + nq1, qidx2, nsp, vb2);
        const int sel_a = gpt::first_argmax<kA>(va2, mx);
        const int sel_b = gpt::first_argmax<kA>(vb2, mx);
        next_v = coin == 0 ? gpt::pick<kA>(vb2, sel_a) : gpt::pick<kA>(va2, sel_b);
      } else {
        float next_max;
        gpt::first_argmax<kA>(va2, next_max);
        next_v = next_max;
        if (P.expected_sarsa) {  // Taxi only: 0.2 = 1/5 actions
          float sum = va2[0];
#pragma unroll
          for (int k = 1; k < kA; ++k) sum = __fadd_rn(sum, va2[k]);
          next_v = __fadd_rn(__fmul_rn(__fsub_rn(1.0f, P.eps), next_max),
                             __fmul_rn(__fmul_rn(P.eps, 0.2f), sum));
        }
      }
      const float target = __fadd_rn(
          st.rew, __fmul_rn(__fmul_rn(P.gamma, next_v), st.done ? 0.0f : 1.0f));
      const float wd = __fmul_rn(P.lr, __fsub_rn(target, q_taken));
      if constexpr (kTrace) {
        int* const my_ring =
            ring_base + (ring_slots ? i * blockDim.x + threadIdx.x : e);
        my_ring[(t % L) * ring_stride] = a * no + qidx;
        age = min(age + 1, L);
        for (int k = 0; k < age; ++k) {
          const int slot = (t - k + L) % L;
          sums.term(t, my_ring[slot * ring_stride], __fmul_rn(P.coefs[k], wd));
        }
      } else {
        sums.term(t, (coin * kA + a) * no + qidx, wd);
      }
      if (st.reset) age = 0;  // the trace dies at resets, not Taxi's task ones
      s_l[i] = st.s_next;
      comp_l[i] = completed;
      el_l[i] = elapsed;
      age_l[i] = age;
      racc_l[i] = racc_l[i] + st.rew;
    }

    // --- the block's sums out, one barrier, every block applies them ---
    __syncthreads();
    sums.flush(t);
    grid.sync();
    sums.apply(t, [&](int c, int k, long long sum) {
      const int row = c / no;  // coin * kA + a
      float& q = s_q[(row / kA) * nq1 + (row % kA) * nsp + c % no];
      q = __fadd_rn(q, gpt::fix_delta(sum, k, average));
    });
    sums.clear_ahead(t);
    __syncthreads();
  }
  // every block holds the same table
  for (int i = gtid; i < P.nq; i += nthreads) q_out[i] = s_q[i];

  for (int i = 0; i < envs_per_thread; ++i) {
    const long long e = gtid + (long long)i * nthreads;
    if (e >= B) break;
    s_out[e] = s_l[i];
    rew_out[e] = s_l[i] < 0 ? __int_as_float(0x7fc00000) : racc_l[i];
  }
}

template <int NBLK, bool kDouble, bool kTrace, class Env>
int launch(const QParams* P, const void* s_in, void* s_out, void* rew_out,
           const void* q_in, void* q_out, void* acc, void* cnt, void* ring,
           const void* tab0, const void* tab1, const void* tab2,
           const void* tab3, const void* tape, int* grid_out, void* stream) {
  // the sums' words (3 buffers of them in acc and cnt) fit in the table's
  // 3 * nq, and an observation fits in the stride between actions
  if (P->n_sites > 4 * NBLK || P->trace_len > kMaxTrace || P->trace_len < 1 ||
      kTrace != (P->trace_len > 1) || P->n_obs < 1 || P->n_obs > P->nsp ||
      sum_words<Env::kA, kDouble>(*P) > P->nq)
    return (int)cudaErrorInvalidValue;
  auto kern = fused_q_kernel<NBLK, kDouble, kTrace, Env>;
  const size_t base = sizeof(float) * P->nq + Env::smem_tables(*P);
  const size_t slab = gpt::BlockSums<1>::smem_bytes(sum_words<Env::kA, kDouble>(*P));
  size_t smem = 0;
  int blocks = 0, ept = 0, on_chip = 1, slots = 0;
  // with a trace the slab always, and the ring beside it where each thread
  // owns one env; one-step, the slab where a launch with it takes the batch
  cudaError_t err =
      kTrace ? gpt::coop_geometry_room(
                   kern, base + slab,
                   sizeof(int) * (size_t)P->trace_len * gpt::kTrainerThreads, 1,
                   P->num_envs, &blocks, &ept, &slots, &smem)
             : gpt::coop_geometry_room(kern, base, slab, gpt::kMaxEnvsPerThread,
                                       P->num_envs, &blocks, &ept, &on_chip,
                                       &smem);
  if (err != cudaSuccess) return (int)err;
  if (kTrace && !slots && !ring) return (int)cudaErrorInvalidValue;
  grid_out[0] = blocks;
  grid_out[1] = ept;
  grid_out[2] = kTrace ? slots : on_chip;
  QParams p = *P;
  void* args[] = {&p, &ept, &on_chip, &slots, (void*)&s_in, &s_out, &rew_out,
                  &q_in, &q_out, &acc, &cnt, &ring, (void*)&tab0, (void*)&tab1,
                  (void*)&tab2, (void*)&tab3, (void*)&tape};
  err = cudaLaunchCooperativeKernel((const void*)kern, dim3(blocks),
                                    dim3(gpt::kTrainerThreads), args, smem,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

#define Q_LAUNCH_ARGS                                                         \
  const QParams *P, const void *s_in, void *s_out, void *rew_out,             \
      const void *q_in, void *q_out, void *acc, void *cnt, void *ring,        \
      const void *tab0, const void *tab1, const void *tab2, const void *tab3, \
      const void *tape, int *grid_out, void *stream
#define Q_LAUNCH_PASS                                                   \
  P, s_in, s_out, rew_out, q_in, q_out, acc, cnt, ring, tab0, tab1, tab2, \
      tab3, tape, grid_out, stream

// grid_out: blocks, envs per thread, and with a trace the ring's env slots
// per thread in shared memory (0: the ring is in global memory), one-step
// whether the update sums' slab is in shared memory (1) or not (0)
extern "C" int fused_q_launch(Q_LAUNCH_ARGS) {
  if (P->trace_len > 1) return launch<2, false, true, TaxiQ>(Q_LAUNCH_PASS);
  return launch<2, false, false, TaxiQ>(Q_LAUNCH_PASS);
}

extern "C" int fused_double_q_launch(Q_LAUNCH_ARGS) {
  return launch<3, true, false, TaxiQ>(Q_LAUNCH_PASS);
}

extern "C" int fused_q_rooms_launch(Q_LAUNCH_ARGS) {
  const bool trace = P->trace_len > 1;
  if (P->n_act == 8)
    return trace ? launch<2, false, true, RoomsQ<8>>(Q_LAUNCH_PASS)
                 : launch<2, false, false, RoomsQ<8>>(Q_LAUNCH_PASS);
  if (P->n_act == 4)
    return trace ? launch<2, false, true, RoomsQ<4>>(Q_LAUNCH_PASS)
                 : launch<2, false, false, RoomsQ<4>>(Q_LAUNCH_PASS);
  return (int)cudaErrorInvalidValue;
}

extern "C" int fused_q_msrooms_launch(Q_LAUNCH_ARGS) {
  if (P->trace_len != 1 || P->floor_div.n != (uint32_t)P->floor_cells)
    return (int)cudaErrorInvalidValue;
  if (P->n_act == 4) return launch<2, false, false, MSRoomsQ<4>>(Q_LAUNCH_PASS);
  if (P->n_act == 8) return launch<2, false, false, MSRoomsQ<8>>(Q_LAUNCH_PASS);
  return (int)cudaErrorInvalidValue;
}
