"""The discrete first layer's backward kernel (``csrc/embed.cu``) run on the
CPU, against its plain twin.

The kernel runs only on the card, where ``tests/test_torch_cuda.py`` holds
it to the twin at the taxi cell's shape.  Here its device code (the source
above its launchers) is compiled by the host C++ compiler under a small
shim that runs every GPU thread of a block as a ``std::thread``:
``__syncwarp`` and ``__syncthreads`` are barriers, a shuffle, a vote or a
match goes through a per-warp slot array between two barriers, shared
memory is one buffer a block (filled with garbage first).  Both passes run
as written, with the launch shapes (``P`` row slices, ``T`` observation
tiles) given here: several slices, parts of many sets of rows, a part of a
block with no row, tiles whose rows a block skips, a width past one
block's columns and one not a multiple of 4 (the scalar loads), bfloat16.
The
float64 sums are the reference: float32 within ``TOL`` of each entry's sum
of absolute values, bfloat16 the float32 sum rounded once (2^-8 relative
besides); two runs equal bit for bit.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from gym_po_tpu_torch.ops import embed

SRC = Path(embed.__file__).resolve().parent.parent / "csrc" / "embed.cu"
TOL = 2.0 ** -17  # as the card test's EMBED_KERNEL_TOL

SHIM = r"""
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <stdint.h>
#include <thread>
#include <vector>
using std::max;
using std::min;
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct float4 { float x, y, z, w; };
struct uint2 { unsigned x, y; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
struct __nv_bfloat16 { uint16_t bits; };
inline float __bfloat162float(__nv_bfloat16 b) {
  uint32_t u = (uint32_t)b.bits << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  u += 0x7fffu + ((u >> 16) & 1u);  // round to nearest even (finite inputs)
  return {(uint16_t)(u >> 16)};
}
inline float __uint_as_float(unsigned u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
template <class T>
T __ldg(const T* p) { return *p; }
inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
struct WarpCtx {
  std::barrier<> bar{32};
  uint64_t slots[32];
};
struct BlockCtx {
  std::unique_ptr<std::barrier<>> bar;
  unsigned char* smem;
  unsigned char* statics;
};
inline thread_local WarpCtx* g_warp = nullptr;
inline thread_local BlockCtx* g_block = nullptr;
inline unsigned char* shim_smem() { return g_block->smem; }
inline unsigned char* shim_static() { return g_block->statics; }
inline void __syncwarp(unsigned = 0xffffffffu) { g_warp->bar.arrive_and_wait(); }
inline void __syncthreads() { g_block->bar->arrive_and_wait(); }
inline int shim_lane() { return threadIdx.x & 31; }
template <class T>
T __shfl_sync(unsigned, T v, int src) {
  uint64_t u = 0;
  std::memcpy(&u, &v, sizeof(T));
  g_warp->slots[shim_lane()] = u;
  __syncwarp();
  const uint64_t r = g_warp->slots[src & 31];
  __syncwarp();
  T out;
  std::memcpy(&out, &r, sizeof(T));
  return out;
}
template <class T>
T __shfl_xor_sync(unsigned m, T v, int o) { return __shfl_sync(m, v, shim_lane() ^ o); }
inline unsigned __ballot_sync(unsigned, int pred) {
  g_warp->slots[shim_lane()] = pred ? 1 : 0;
  __syncwarp();
  unsigned b = 0;
  for (int i = 0; i < 32; ++i) b |= (g_warp->slots[i] ? 1u : 0u) << i;
  __syncwarp();
  return b;
}
inline int __any_sync(unsigned m, int pred) { return __ballot_sync(m, pred) != 0; }
inline unsigned __match_any_sync(unsigned, int key) {
  g_warp->slots[shim_lane()] = (uint32_t)key;
  __syncwarp();
  unsigned b = 0;
  for (int i = 0; i < 32; ++i) b |= (g_warp->slots[i] == (uint32_t)key ? 1u : 0u) << i;
  __syncwarp();
  return b;
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
// a grid of blocks one after another, a std::thread per thread of a block
template <class F>
void shim_launch(dim3 grid, dim3 block, size_t smem, F fn) {
  const unsigned n = block.x * block.y * block.z;
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        BlockCtx blk;
        blk.bar.reset(new std::barrier<>(n));
        std::vector<unsigned char> mem(smem + 16, 0xCD), statics(4096, 0xCD);
        blk.smem = mem.data();
        blk.statics = statics.data();
        std::vector<std::unique_ptr<WarpCtx>> warps;
        for (unsigned w = 0; w < (n + 31) / 32; ++w) warps.emplace_back(new WarpCtx());
        std::vector<std::thread> ts;
        for (unsigned t = 0; t < n; ++t)
          ts.emplace_back([&, t] {
            threadIdx = dim3(t % block.x, t / block.x % block.y, t / (block.x * block.y));
            blockIdx = dim3(bx, by, bz);
            blockDim = block;
            gridDim = grid;
            g_block = &blk;
            g_warp = warps[t / 32].get();
            fn();
          });
        for (auto& th : ts) th.join();
      }
}
"""

LAUNCH = r"""
template <typename G>
static void run(long long N, int n, int H, int P, int T, int tn, const void* g, const void* idx,
                void* part, void* gw, void* gb) {
  const embed::Geometry ge = embed::geometry(H);
  const int vec = H % embed::QC == 0;
  shim_launch(dim3(P, T, ge.CG), dim3(32, ge.cws, embed::RH), embed::smem_bytes(ge, tn), [&] {
    embed::embed_grad_rows<G>((const G*)g, (const int*)idx, N, n, H, tn, vec, (float*)part);
  });
  shim_launch(dim3((n + 1 + 31) / 32, H), dim3(32 * embed::SUM_WARPS), 0, [&] {
    embed::embed_grad_sum((const float*)part, P, n, H, T, sizeof(G) == 2, (float*)gw,
                          (float*)gb);
  });
}
extern "C" void host_embed_grad(int g_dtype, long long N, int n, int H, int P, int T, int tn,
                                const void* g, const void* idx, void* part, void* gw,
                                void* gb) {
  if (g_dtype == 0)
    run<float>(N, n, H, P, T, tn, g, idx, part, gw, gb);
  else
    run<__nv_bfloat16>(N, n, H, P, T, tn, g, idx, part, gw, gb);
}
"""


def host_source() -> str:
    """The kernel's device code (the source above its launchers and the
    launchers' shapes, Geometry and smem_bytes) between the shim and the
    host launcher."""
    text = SRC.read_text()
    device = text[:text.index("// " + "-" * 64 + " launchers")]
    shapes = text[text.index("struct Geometry {"):text.index("// Pass 1's dynamic shared memory")]
    device = device.replace("#include <cuda_bf16.h>\n", "").replace(
        "#include <cuda_runtime.h>\n", "")
    for shared, shim in (
            ("extern __shared__ float4 table[];", "float4* table = (float4*)shim_smem();"),
            ("__shared__ float bias_s[RH][MAX_CW];",
             "auto bias_s = (float(*)[MAX_CW])shim_static();"),
            ("__shared__ float sums[SUM_WARPS][32];",
             "auto sums = (float(*)[32])shim_static();")):
        assert device.count(shared) == 1, shared
        device = device.replace(shared, shim)
    return SHIM + device + shapes + "}  // namespace embed\n" + LAUNCH


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to build the kernel's device code for the host")
    d = tmp_path_factory.mktemp("embed_host")
    (d / "embed_host.cpp").write_text(host_source())
    subprocess.run([cxx, "-std=c++20", "-O2", "-fPIC", "-shared", "-pthread", "-o",
                    str(d / "embed_host.so"), str(d / "embed_host.cpp")], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(d / "embed_host.so"))
    i, p = ctypes.c_int, ctypes.c_void_p
    lib.host_embed_grad.argtypes = [i, ctypes.c_longlong] + [i] * 5 + [p] * 5
    return lib


def host_embed_grad(lib, g, idx, n, P, T):
    """Both passes of the kernel on the host, with ``P`` row slices and
    ``T`` observation tiles."""
    H = g.shape[-1]
    tn = -(-n // T)
    part = torch.full((P * H * (n + T),), float("nan"))
    gw = torch.full((H, n), float("nan"))
    gb = torch.full((H,), float("nan"))
    lib.host_embed_grad(int(g.dtype == torch.bfloat16), idx.numel(), n, H, P, T, tn,
                        g.data_ptr(), idx.data_ptr(),
                        part.data_ptr(), gw.data_ptr(), gb.data_ptr())
    return gw, gb


CASES = {  # rows, observations, width, gradient, law, P, T
    "slices": (1000, 20, 16, torch.float32, "uniform", 3, 1),
    "many_sets": (5000, 20, 16, torch.float32, "uniform", 2, 1),
    "one_observation": (700, 20, 16, torch.float32, "one", 2, 1),
    "concentrated": (900, 40, 8, torch.float32, "few", 2, 1),
    "tiles": (800, 50, 16, torch.float32, "uniform", 2, 3),
    "part_with_no_row": (5, 9, 8, torch.float32, "uniform", 3, 1),
    "two_column_groups": (300, 11, 72, torch.float32, "uniform", 2, 1),
    "ragged_width": (500, 13, 18, torch.float32, "uniform", 2, 2),
    "bf16": (1000, 20, 16, torch.bfloat16, "uniform", 3, 1),
    "bf16_one_observation": (600, 20, 16, torch.bfloat16, "one", 2, 1),
}


def _inputs(rows, n, H, dtype, law, seed=0):
    gen = torch.Generator().manual_seed(seed)
    g = torch.randn(rows, H, generator=gen).to(dtype)
    if law == "one":
        idx = torch.full((rows,), n // 3)
    elif law == "few":
        idx = torch.randint(0, 3, (rows,), generator=gen) * (n // 3)
    else:
        idx = torch.randint(0, n, (rows,), generator=gen)
    return g, idx.to(torch.int32)


@pytest.mark.parametrize("case", list(CASES))
def test_host_kernel_equals_float64_sums_and_twin(host_lib, case):
    rows, n, H, dtype, law, P, T = CASES[case]
    g, idx = _inputs(rows, n, H, dtype, law)
    gw, gb = host_embed_grad(host_lib, g, idx, n, P, T)
    again = host_embed_grad(host_lib, g, idx, n, P, T)
    assert torch.equal(gw, again[0]) and torch.equal(gb, again[1])
    tw, tb = embed.embed_grad_twin(g, idx, n)
    g64, i = g.double(), idx.long()
    for got, twin, x in ((gw, tw, g64), (gb, tb, None)):
        if x is None:
            want, mag = g64.sum(0), g64.abs().sum(0)
        else:
            want = torch.zeros(n, H, dtype=torch.float64).index_add_(0, i, g64).t()
            mag = torch.zeros(n, H, dtype=torch.float64).index_add_(0, i, g64.abs()).t()
        rounding = 0.0 if dtype == torch.float32 else 2.0 ** -8 * want.abs()
        assert not torch.isnan(got).any()
        assert ((got.double() - want).abs() <= TOL * mag + rounding).all()
        ulp = 0.0 if dtype == torch.float32 else 2.0 ** -7 * twin.double().abs()
        assert ((got.double() - twin.double()).abs() <= 2 * TOL * mag + ulp).all()
