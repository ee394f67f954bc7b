// Pieces shared by the rollout kernels whose env state is a tuple of tiles
// (fused_crooms.cu, fused_tag.cu): the header of their params structs and
// the per-env episode statistics.  The Python side is
// gym_po_tpu_torch/ops/state_rollout.py (Header, make_state_rollout).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gpt {

// Mirrored field for field by Header in ops/state_rollout.py; every state
// rollout's params struct starts with it.
struct RolloutHeader {
  int32_t num_envs, num_steps, rows_per_tile, n_sites, time_limit, episode_stats;
  uint32_t key0, key1;
};

// completed-episode return, length and count, summed in the order of the
// twin's torch ops (the in-kernel RecordEpisodeStatistics of the JAX kernels)
struct EpisodeStats {
  float cur_ret = 0.f, ep_ret = 0.f, ep_len = 0.f, ep_cnt = 0.f;
  __device__ __forceinline__ void add(float rew, bool reset, int length) {
    cur_ret = __fadd_rn(cur_ret, rew);
    if (reset) {
      ep_ret = __fadd_rn(ep_ret, cur_ret);
      ep_len = __fadd_rn(ep_len, (float)length);
      ep_cnt = __fadd_rn(ep_cnt, 1.f);
      cur_ret = 0.f;
    }
  }
  // into out[first], out[first + 1], out[first + 2]
  template <class Ptrs>
  __device__ __forceinline__ void store(const Ptrs& p, int first, long long e) const {
    p.out_f(first, e, ep_ret);
    p.out_f(first + 1, e, ep_len);
    p.out_f(first + 2, e, ep_cnt);
  }
};

constexpr int kRolloutThreads = 256;

// The state tiles in and out (out: the state, the reward sums, then ep_ret,
// ep_len and ep_cnt, null without episode stats), passed to the kernel by
// value from the launcher's pointer arrays.
template <int NSTATE>
struct StatePtrs {
  const void* in[NSTATE];
  void* out[NSTATE + 4];
  StatePtrs(const void* const* in_, void* const* out_) {
    for (int i = 0; i < NSTATE; ++i) in[i] = in_[i];
    for (int i = 0; i < NSTATE + 4; ++i) out[i] = out_[i];
  }
  __device__ __forceinline__ float in_f(int i, long long e) const {
    return static_cast<const float*>(in[i])[e];
  }
  __device__ __forceinline__ int in_i(int i, long long e) const {
    return static_cast<const int32_t*>(in[i])[e];
  }
  __device__ __forceinline__ void out_f(int i, long long e, float v) const {
    static_cast<float*>(out[i])[e] = v;
  }
  __device__ __forceinline__ void out_i(int i, long long e, int v) const {
    static_cast<int32_t*>(out[i])[e] = v;
  }
};

}  // namespace gpt
