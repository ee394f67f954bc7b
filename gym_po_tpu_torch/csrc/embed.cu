// The backward of the discrete first layer, for Hopper (sm_90a).
//
// It replaces no Pallas kernel: the JAX package's first layer over a
// Discrete observation is a one-hot product that XLA lowers
// (gym_po_tpu/agents/networks.py), and the port computes it as an index into
// the weight's columns (gym_po_tpu_torch/agents/networks.py::embed_discrete).
// That index's autograd backward is PyTorch's index_put_(accumulate=True): a
// radix sort of the rows' observations, then one warp a run of equal
// observations that sums the run serially.  A policy visits fewer and fewer
// of its observations as it learns, so the runs grow to thousands of rows
// and the sum runs far below the card's bandwidth.  This kernel computes
// the same sums in a fixed order, balanced over the rows whatever the
// observations are.
//
// Given g [N, H] (the layer's output gradient, float32 or bfloat16) and the
// observations idx [N] (int32) in [0, n), it writes
//   gw[c][o] = sum of g[r][c] over the rows r with idx[r] == o  ([H, n], the
//              Linear weight's layout, float32)
//   gb[c]    = sum of g[r][c] over all rows                     ([H], float32)
// summed in float32 and, for a bfloat16 g, rounded once to bfloat16.
//
// What bounds it: bytes.  Each gradient byte is read once (33.5 MB at
// N = 131,072, H = 64 in float32, about 10 us at 3.35 TB/s); the indices,
// the partial sums and the outputs are small beside it.
//
// Pass 1, embed_grad_rows, grid (P, T, CG): block (p, t, cg) owns the p-th
// contiguous slice of the rows, the t-th tile of the observations and the
// cg-th group of CW (<= 64) columns.  Its rows are cut into RH parts, and
// each part has a table of tile x CW float32 sums in shared memory (taxi's
// 320 x 64: two tables of 80 KB, one block an SM).  A warp owns WCOLS = 8
// columns of a part (two 16 B loads of a float32 row) and walks the part's
// rows in order, a lane a row, U sets of 32 rows loaded at once.  Lanes that
// hold the same observation are found by __match_any_sync and summed by a
// tree over their ranks (pointer doubling over the group's members, by
// shuffles), so one lane, the group's first, adds the group's sum to the
// table: no atomics, and the order of every sum depends only on the data.
// Rows outside the block's tile are skipped after their index is read.  At
// the end the warps add the parts' tables in part order and write the sums,
// transposed, to part[p][c][o], and the lanes' sums of all their rows (the
// bias's partial for the tile) to part[p][c][n + t].
//
// Pass 2, embed_grad_sum, grid (ceil((n + 1) / 32), H): each output sums
// the P partials in p order (8 warps take P/8 each, combined in warp
// order), then rounds once for a bfloat16 g, and is written in the [H, n]
// layout.
//
// The plain twin is gym_po_tpu_torch/ops/embed.py::embed_grad_twin.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace embed {

constexpr unsigned FULL = 0xffffffffu;
constexpr int QC = 4;                  // columns a load: 16 B in float32
constexpr int LQ = 2;                  // loads a lane a row
constexpr int WCOLS = QC * LQ;         // columns a warp owns
constexpr int MAX_CW = 64;             // columns a block owns
constexpr int RH = 2;                  // parts of a block's rows, a table each
constexpr int TABLE_BYTES = 96 * 1024; // a part's table: a block's two fit an SM
constexpr int MAX_THREADS = 32 * MAX_CW / WCOLS * RH;
constexpr int MIN_ROWS = 256;          // rows a block at least
constexpr int U = 4;                   // sets of 32 rows a warp loads at once
constexpr int SUM_WARPS = 8;           // pass 2: warps splitting the partials

__device__ __forceinline__ void load4(const float* __restrict__ g, long long off, int valid,
                                      bool vec, float v[QC]) {
  if (vec) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(g + off));
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else {
#pragma unroll
    for (int c = 0; c < QC; ++c) v[c] = c < valid ? __ldg(g + off + c) : 0.0f;
  }
}

__device__ __forceinline__ void load4(const __nv_bfloat16* __restrict__ g, long long off,
                                      int valid, bool vec, float v[QC]) {
  if (vec) {
    const uint2 a = __ldg(reinterpret_cast<const uint2*>(g + off));
    v[0] = __uint_as_float(a.x << 16);
    v[1] = __uint_as_float(a.x & 0xffff0000u);
    v[2] = __uint_as_float(a.y << 16);
    v[3] = __uint_as_float(a.y & 0xffff0000u);
  } else {
#pragma unroll
    for (int c = 0; c < QC; ++c) v[c] = c < valid ? __bfloat162float(g[off + c]) : 0.0f;
  }
}

// Add a set of 32 rows, a lane a row, to the warp's table (and each lane's
// row to its bias sums): key is the row's observation in the tile, or
// -1 - lane, alone, for a row outside it (whose v is 0).  The lanes of one
// key are summed by a tree over their ranks, and the first of them adds the
// sum to the key's entry.
__device__ __forceinline__ void add(int key, float (&v)[WCOLS], float4* mine,
                                    float (&bias)[WCOLS], int lane) {
#pragma unroll
  for (int c = 0; c < WCOLS; ++c) bias[c] += v[c];
  const unsigned m = __match_any_sync(FULL, key);
  const int rank = __popc(m & ((1u << lane) - 1)), size = __popc(m);
  const unsigned after = m & ~((2u << lane) - 1);
  int nxt = after ? __ffs(after) - 1 : 32;  // my next member, 32 for none
  // at step s the ranks that are multiples of 2s add the sum held by the
  // rank s above them; the pointer doubles to the member 2s above
  for (int s = 1; __any_sync(FULL, size > s); s <<= 1) {
    const int src = nxt & 31;
    const bool take = (rank & (2 * s - 1)) == 0 && nxt < 32;
#pragma unroll
    for (int c = 0; c < WCOLS; ++c) {
      const float o = __shfl_sync(FULL, v[c], src);
      if (take) v[c] += o;
    }
    const int n2 = __shfl_sync(FULL, nxt, src);
    nxt = nxt < 32 ? n2 : 32;
  }
  if (key >= 0 && rank == 0) {
#pragma unroll
    for (int q = 0; q < LQ; ++q) {
      float4 x = mine[LQ * key + q];
      x.x += v[QC * q]; x.y += v[QC * q + 1]; x.z += v[QC * q + 2]; x.w += v[QC * q + 3];
      mine[LQ * key + q] = x;
    }
  }
  __syncwarp();
}

// Pass 1.  Block (p, t, cg), threads (lane, cw, h): warp (cw, h) sums the
// h-th of the RH parts of the block's rows, in its WCOLS columns, into its own
// table of the tile in shared memory, 32 rows at a time.  At the end all
// warps add the parts' tables, in part order, and write the sums.
template <typename G>
__global__ void __launch_bounds__(MAX_THREADS) embed_grad_rows(const G* __restrict__ g,
                                                               const int* __restrict__ idx,
                                                               long long N, int n, int H,
                                                               int tn, int vec,
                                                               float* __restrict__ part) {
  extern __shared__ float4 table[];
  __shared__ float bias_s[RH][MAX_CW];
  const int lane = threadIdx.x, cw = threadIdx.y, cws = blockDim.y, h = threadIdx.z;
  const int P = gridDim.x, p = blockIdx.x, t = blockIdx.y, T = gridDim.y;
  const int c0 = (blockIdx.z * cws + cw) * WCOLS;  // this warp's first column
  const int valid = max(0, min(WCOLS, H - c0));
  const int o0 = t * tn, tcount = min(tn, n - o0);
  const long long E = n + T;  // entries of a column in part
  const int threads = 32 * cws * RH, tid = lane + 32 * (cw + cws * h);
  const int entries = LQ * tn;  // float4s of a warp's table
  for (int i = tid; i < RH * cws * entries; i += threads)
    table[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  float4* mine = table + (h * cws + cw) * entries;
  const bool all_in = T == 1, vec_ok = vec != 0;
  const long long b0 = N * p / P, b1 = N * (p + 1) / P;  // the block's rows
  const long long r0 = b0 + (b1 - b0) * h / RH, r1 = b0 + (b1 - b0) * (h + 1) / RH;
  __syncthreads();  // the tables are zeroed

  float bias[WCOLS];
#pragma unroll
  for (int c = 0; c < WCOLS; ++c) bias[c] = 0.f;
  for (long long r = r0; r < r1; r += 32 * U) {
    int key[U];
    float v[U][WCOLS];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long j = r + 32 * u + lane;
      const int o = j < r1 ? idx[j] - o0 : -1;
      const bool in = o >= 0 && o < tcount;
      key[u] = in ? o : -1 - lane;
      // with one tile every row is in it: the load need not wait for o
      const bool row = j < r1 && (all_in || in);
#pragma unroll
      for (int q = 0; q < LQ; ++q) {
        if (row && QC * q < valid) {
          load4(g, j * H + c0 + QC * q, valid - QC * q, vec_ok, v[u] + QC * q);
        } else {
#pragma unroll
          for (int c = 0; c < QC; ++c) v[u][QC * q + c] = 0.f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) add(key[u], v[u], mine, bias, lane);
  }

  // each lane's sums of its rows, over the warp by a fixed butterfly: lane
  // 0 holds the warp's, the bias's partial of this part, slice and tile
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1)
#pragma unroll
    for (int c = 0; c < WCOLS; ++c) bias[c] += __shfl_xor_sync(FULL, bias[c], off);
  if (lane == 0)
#pragma unroll
    for (int c = 0; c < WCOLS; ++c) bias_s[h][cw * WCOLS + c] = bias[c];
  __syncthreads();
  // the parts' tables added in part order and written, transposed, lanes
  // along the observations: the warps of part h take every RH-th run of 32
  float* out = part + ((long long)p * H + c0) * E;
  if (h == 0 && lane < valid) {
    float s = bias_s[0][cw * WCOLS + lane];
    for (int k = 1; k < RH; ++k) s += bias_s[k][cw * WCOLS + lane];
    out[lane * E + n + t] = s;
  }
  const float4* own = table + cw * entries;  // part 0's table of these columns
  for (int o = lane + 32 * h; o < tcount; o += 32 * RH) {
#pragma unroll
    for (int q = 0; q < LQ; ++q) {
      float4 x = own[LQ * o + q];
      for (int k = 1; k < RH; ++k) {
        const float4 y = own[k * cws * entries + LQ * o + q];
        x.x += y.x; x.y += y.y; x.z += y.z; x.w += y.w;
      }
      const float s[QC] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int c = 0; c < QC; ++c)
        if (QC * q + c < valid) out[(QC * q + c) * E + o0 + o] = s[c];
    }
  }
}

__global__ void __launch_bounds__(32 * SUM_WARPS) embed_grad_sum(const float* __restrict__ part,
                                                                 int P, int n, int H, int T,
                                                                 int round_bf16,
                                                                 float* __restrict__ gw,
                                                                 float* __restrict__ gb) {
  __shared__ float sums[SUM_WARPS][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int e = blockIdx.x * 32 + lane, c = blockIdx.y;
  const long long E = n + T;
  const int p0 = P * w / SUM_WARPS, p1 = P * (w + 1) / SUM_WARPS;
  const float* col = part + (long long)c * E;
  float s = 0.f;
  if (e < n) {
#pragma unroll 8
    for (int p = p0; p < p1; ++p) s += col[(long long)p * H * E + e];
  } else if (e == n) {
    for (int p = p0; p < p1; ++p)
      for (int t = 0; t < T; ++t) s += col[(long long)p * H * E + n + t];
  }
  sums[w][lane] = s;
  __syncthreads();
  if (w != 0 || e > n) return;
  float tot = sums[0][lane];
#pragma unroll
  for (int k = 1; k < SUM_WARPS; ++k) tot += sums[k][lane];
  if (round_bf16) tot = __bfloat162float(__float2bfloat16_rn(tot));
  if (e < n)
    gw[(long long)c * n + e] = tot;
  else
    gb[c] = tot;
}

// ---------------------------------------------------------------- launchers

struct Geometry {
  int CW, CG, cws;  // a block's columns, the column groups, its column warps
};

inline Geometry geometry(int H) {
  Geometry ge;
  ge.CW = min(MAX_CW, (H + WCOLS - 1) / WCOLS * WCOLS);
  ge.CG = (H + ge.CW - 1) / ge.CW;
  ge.cws = ge.CW / WCOLS;
  return ge;
}

// the parts' tables
inline size_t smem_bytes(const Geometry& ge, int tn) {
  return (size_t)RH * tn * ge.CW * sizeof(float);
}

// Pass 1's dynamic shared memory: above 48 KB a kernel must opt in on each
// device, to the most any of its launches there takes (an opt-in to less
// would refuse a larger table's launch); the launch runs on the current
// device.  Internal linkage: each library built from this source keeps its
// own record.
namespace {
constexpr int kMaxDevices = 64;

template <typename G>
cudaError_t opt_in(size_t smem, int* dev) {
  static size_t opted[kMaxDevices];  // 0: the default 48 KB
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return err;
  if (*dev < 0 || *dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && smem > opted[*dev]) {
    err = cudaFuncSetAttribute(embed_grad_rows<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    opted[*dev] = smem;
  }
  return cudaSuccess;
}
}  // namespace

// The launch's shape: plan[0] = P row slices, plan[1] = T observation tiles,
// plan[2] = the tile.
template <typename G>
cudaError_t plan_for(long long N, int n, int H, int* plan) {
  const Geometry ge = geometry(H);
  const int tn_max = TABLE_BYTES / (ge.CW * (int)sizeof(float));
  const int T = (n + tn_max - 1) / tn_max, tn = (n + T - 1) / T;
  const size_t smem = smem_bytes(ge, tn);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = opt_in<G>(smem, &dev);
  if (err != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, embed_grad_rows<G>,
                                                           32 * ge.cws * RH, smem)) !=
      cudaSuccess)
    return err;
  // as many row slices as fill the card once, none under MIN_ROWS rows,
  // and the partials no larger than the gradient
  long long P = (long long)sms * max(per_sm, 1) / ((long long)T * ge.CG);
  P = min(P, (N + MIN_ROWS - 1) / MIN_ROWS);
  P = min(P, N * (long long)sizeof(G) / (4LL * (n + T)));
  plan[0] = (int)max(P, 1LL);
  plan[1] = T;
  plan[2] = tn;
  return cudaSuccess;
}

template <typename G>
int launch(long long N, int n, int H, int P, int T, int tn, const void* g, const void* idx,
           void* part, void* gw, void* gb, cudaStream_t st) {
  const Geometry ge = geometry(H);
  const size_t smem = smem_bytes(ge, tn);
  int dev = 0;
  cudaError_t err = opt_in<G>(smem, &dev);
  if (err != cudaSuccess) return (int)err;
  const int vec = (H % QC == 0) && ((uintptr_t)g % 16 == 0);
  embed_grad_rows<G><<<dim3(P, T, ge.CG), dim3(32, ge.cws, RH), smem, st>>>(
      (const G*)g, (const int*)idx, N, n, H, tn, vec, (float*)part);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  embed_grad_sum<<<dim3((n + 1 + 31) / 32, H), 32 * SUM_WARPS, 0, st>>>(
      (const float*)part, P, n, H, T, sizeof(G) == 2, (float*)gw, (float*)gb);
  return (int)cudaGetLastError();
}

}  // namespace embed

// g_dtype 0 is float32, 1 bfloat16; the observations are int32.  Mirrored
// by ops/embed.py.  Each returns a cudaError_t, 0 for success.

// The plan of a launch (plan_for): part holds plan[0] * H * (n + plan[1])
// floats.
extern "C" int embed_grad_plan(int g_dtype, long long N, int n, int H, int* plan) {
  return (int)(g_dtype == 0 ? embed::plan_for<float>(N, n, H, plan)
                            : embed::plan_for<__nv_bfloat16>(N, n, H, plan));
}

// Both passes on `stream`, with the plan that embed_grad_plan gave for these
// shapes; returns cudaGetLastError() after them.
extern "C" int embed_grad_launch(int g_dtype, long long N, int n, int H, int P, int T, int tn,
                                 const void* g, const void* idx, void* part, void* gw, void* gb,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return g_dtype == 0
             ? embed::launch<float>(N, n, H, P, T, tn, g, idx, part, gw, gb, st)
             : embed::launch<__nv_bfloat16>(N, n, H, P, T, tn, g, idx, part, gw, gb, st);
}
