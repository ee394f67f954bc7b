"""The ant kernels' CUDA source run on the CPU, against their plain twins.

``csrc/ant_forward.cu`` runs only on the card, where ``tests/test_torch_cuda.py``
holds it to the twins.  Here its device code (everything above the
launchers) is compiled by the host C++ compiler under a small shim that
runs every GPU thread of a block as a ``std::thread``: ``__syncwarp`` and
``__syncthreads`` are barriers, a shuffle or a ballot goes through a
per-warp slot array between two barriers, shared memory is one buffer a
block (filled with garbage first).  So the warp-per-env smooth dynamics
(FK a tree level at a time, the mass matrix a lane per packed entry, the
warp Cholesky), the warp-per-env Newton solve, its compaction, chunking
and butterfly sums, and the thread-per-(unit, env) rows run as written,
each on the kernels' own outputs (smooth -> rows -> newton), with the
twins' tolerances: f64 within 1e-9 relative to max(1, |x|) (Newton after
16 iterations), f32 within ``chip_smoke.ant_f32_errs``' gates.
``-ffp-contract=fast -mfma`` makes the host fuse multiply-adds as the
card does.  Batches of 20 envs leave the last smooth and Newton block (8
envs at f32, 4 at f64) part empty; a forced test makes every row active,
so each pass takes the rows chunk by chunk.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

import chip_smoke as cs
from gym_po_tpu_torch.ops import ant_forward as af

SRC = Path(af.__file__).resolve().parent.parent / "csrc" / "ant_forward.cu"

SHIM = r"""
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <math.h>
#include <memory>
#include <stdint.h>
#include <thread>
#include <vector>
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(x)
struct WarpCtx {
  std::barrier<> bar{32};
  uint64_t slots[32];
};
struct BlockCtx {
  std::unique_ptr<std::barrier<>> bar;
  unsigned char* smem;
};
inline thread_local WarpCtx* g_warp = nullptr;
inline thread_local BlockCtx* g_block = nullptr;
inline unsigned char* shim_smem() { return g_block->smem; }
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
inline unsigned __reduce_add_sync(unsigned, unsigned v) {
  g_warp->slots[shim_lane()] = v;
  __syncwarp();
  unsigned s = 0;
  for (int i = 0; i < 32; ++i) s += (unsigned)g_warp->slots[i];
  __syncwarp();
  return s;
}
inline unsigned long long atomicAdd(unsigned long long* p, unsigned long long v) {
  return __atomic_fetch_add(p, v, __ATOMIC_RELAXED);
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
inline void sincospif(float x, float* s, float* c) {
  *s = (float)std::sin(M_PI * x);
  *c = (float)std::cos(M_PI * x);
}
inline void sincospi(double x, double* s, double* c) {
  *s = std::sin(M_PI * x);
  *c = std::cos(M_PI * x);
}
// a grid of blocks one after another, a std::thread per thread of a block
template <class F>
void shim_launch(dim3 grid, dim3 block, size_t smem, F fn) {
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      BlockCtx blk;
      blk.bar.reset(new std::barrier<>(block.x));
      std::vector<unsigned char> mem(smem + 16, 0xCD);
      blk.smem = mem.data();
      std::vector<std::unique_ptr<WarpCtx>> warps;
      for (unsigned w = 0; w < (block.x + 31) / 32; ++w) warps.emplace_back(new WarpCtx());
      std::vector<std::thread> ts;
      for (unsigned t = 0; t < block.x; ++t)
        ts.emplace_back([&, t] {
          threadIdx = dim3(t);
          blockIdx = dim3(bx, by);
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
template <typename T>
static void smooth(int B, const void* mdl, const void* tab, const void* qpos, const void* qvel,
                   const void* ctrl, void* M, void* qs, void* skin) {
  constexpr int W = ant::WarpEnvs<T>::value;
  const size_t smem = W * ant::SE_SIZE * sizeof(T) + ant::ST_LEN * sizeof(int);
  shim_launch(dim3((B + W - 1) / W), dim3(32 * W), smem, [&] {
    ant::ant_smooth_kernel<T, W>(B, (const T*)mdl, (const int*)tab, (const T*)qpos,
                                 (const T*)qvel, (const T*)ctrl, (T*)M, (T*)qs, (T*)skin);
  });
}
extern "C" void host_smooth(int dtype, int B, const void* mdl, const void* tab,
                            const void* qpos, const void* qvel, const void* ctrl, void* M,
                            void* qs, void* skin) {
  if (dtype == 0)
    smooth<float>(B, mdl, tab, qpos, qvel, ctrl, M, qs, skin);
  else
    smooth<double>(B, mdl, tab, qpos, qvel, ctrl, M, qs, skin);
}
template <typename T>
static void rows(int B, int ne, int n_units, const void* mdl, const void* tables,
                 const void* units, const void* skin, const void* qpos, const void* qvel,
                 void* vals, void* aref, void* r, void* active) {
  shim_launch(dim3((B + 127) / 128, n_units), dim3(128), 0, [&] {
    ant::ant_rows_kernel<T>(B, (const T*)mdl, (const int*)tables, ne, (const int*)units,
                            (const T*)skin, (const T*)qpos, (const T*)qvel, (T*)vals, (T*)aref,
                            (T*)r, (T*)active);
  });
}
extern "C" void host_rows(int dtype, int B, int ne, int n_units, const void* mdl,
                          const void* tables, const void* units, const void* skin,
                          const void* qpos, const void* qvel, void* vals, void* aref, void* r,
                          void* active) {
  if (dtype == 0)
    rows<float>(B, ne, n_units, mdl, tables, units, skin, qpos, qvel, vals, aref, r, active);
  else
    rows<double>(B, ne, n_units, mdl, tables, units, skin, qpos, qvel, vals, aref, r, active);
}
template <typename T>
static void newton(int B, int ne, int iters, int ls, const void* tables, const void* M,
                   const void* qs, const void* vals, const void* aref, const void* r,
                   const void* active, const void* warm, void* qacc, void* warm_out,
                   void* count) {
  constexpr int W = ant::WarpEnvs<T>::value;
  // the dynamic shared memory, then the static rows_part[W]
  auto kernel = count ? ant::ant_newton_kernel<T, W, true> : ant::ant_newton_kernel<T, W, false>;
  shim_launch(dim3((B + W - 1) / W), dim3(32 * W),
              W * ant::newton_env_bytes<T>(ne) + W * sizeof(unsigned), [&] {
    kernel(B, ne, iters, ls, (const int*)tables, (const T*)M, (const T*)qs, (const T*)vals,
           (const T*)aref, (const T*)r, (const T*)active, (const T*)warm, (T*)qacc,
           (T*)warm_out, (unsigned long long*)count);
  });
}
extern "C" void host_newton(int dtype, int B, int ne, int iters, int ls, const void* tables,
                            const void* M, const void* qs, const void* vals, const void* aref,
                            const void* r, const void* active, const void* warm, void* qacc,
                            void* warm_out, void* count) {
  if (dtype == 0)
    newton<float>(B, ne, iters, ls, tables, M, qs, vals, aref, r, active, warm, qacc, warm_out,
                  count);
  else
    newton<double>(B, ne, iters, ls, tables, M, qs, vals, aref, r, active, warm, qacc, warm_out,
                   count);
}
"""


def host_source() -> str:
    """The kernels' device code (the source above its launchers) between
    the shim and the host launchers."""
    text = SRC.read_text()
    device = text[:text.index("// " + "-" * 64 + " launchers")]
    device = device.replace("#include <cuda_runtime.h>\n", "")
    for shared, shim in (
            ("extern __shared__ __align__(16) unsigned char ant_smem[];",
             "unsigned char* ant_smem = shim_smem();"),
            ("__shared__ unsigned rows_part[W];",
             "unsigned* rows_part = (unsigned*)(shim_smem() + W * newton_env_bytes<T>(ne));"),
            ("__shared__ T sm[W * SE_SIZE];", "T* sm = (T*)shim_smem();"),
            ("__shared__ int stab[ST_LEN];",
             "int* stab = (int*)(shim_smem() + W * SE_SIZE * sizeof(T));")):
        assert device.count(shared) == 1, shared
        device = device.replace(shared, shim)
    return SHIM + device + LAUNCH


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to build the kernels' device code for the host")
    d = tmp_path_factory.mktemp("ant_host")
    (d / "ant_host.cpp").write_text(host_source())
    subprocess.run([cxx, "-std=c++20", "-O2", "-mfma", "-ffp-contract=fast", "-fPIC",
                    "-shared", "-pthread", "-o", str(d / "ant_host.so"),
                    str(d / "ant_host.cpp")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(d / "ant_host.so"))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.host_smooth.argtypes = [i] * 2 + [p] * 8
    lib.host_rows.argtypes = [i] * 4 + [p] * 10
    lib.host_newton.argtypes = [i] * 5 + [p] * 11
    return lib


def _ptr(x):
    return None if x is None else x.data_ptr()


def _host_smooth(lib, model, qpos, qvel, ctrl) -> af.Smooth:
    p = af._plan(model, qpos.dtype, "cpu")
    B = qpos.shape[0]
    out = af.Smooth(*(torch.full((n, B), float("nan"), dtype=qpos.dtype)
                      for n in (af.NV * af.NV, af.NV, af.SKIN)))
    lib.host_smooth(int(qpos.dtype == torch.float64), B, _ptr(p.model),
                    _ptr(p.smooth_table), _ptr(qpos), _ptr(qvel), _ptr(ctrl),
                    *map(_ptr, out))
    return out


def _host_rows(lib, model, skin, qpos, qvel) -> af.Rows:
    p = af._plan(model, qpos.dtype, "cpu")
    B = qpos.shape[0]
    out = af.Rows(*(torch.full((n, B), float("nan"), dtype=qpos.dtype)
                    for n in (p.nnz, p.ne, p.ne, p.ne)))
    lib.host_rows(int(qpos.dtype == torch.float64), B, p.ne, len(p.units), _ptr(p.model),
                  _ptr(p.tables), _ptr(p.units), _ptr(skin), _ptr(qpos), _ptr(qvel),
                  *map(_ptr, out))
    return out


def _host_newton(lib, model, sm, rows, warm, iters, count=None):
    p = af._plan(model, sm.M.dtype, "cpu")
    B = sm.M.shape[1]
    qacc = torch.full((B, af.NV), float("nan"), dtype=sm.M.dtype)
    warm_out = torch.full_like(qacc, float("nan"))
    lib.host_newton(int(sm.M.dtype == torch.float64), B, p.ne, iters, 10, _ptr(p.tables),
                    _ptr(sm.M), _ptr(sm.qacc_smooth), *map(_ptr, rows), _ptr(warm),
                    _ptr(qacc), _ptr(warm_out), _ptr(count))
    return qacc, warm_out


def _inputs(dtype, n, seed):
    return [torch.as_tensor(x, dtype=dtype)
            for x in cs.ant_contact_states(n, seed, walls=True)]


def _rel(a, b):
    return ((a - b).abs() / b.abs().clamp_min(1.0)).max().item()


@pytest.mark.parametrize("B", [20, 21])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("env_id", cs.ANT_IDS)
def test_host_smooth_equals_twin(host_lib, env_id, dtype, B):
    """The warp-per-env ant_smooth against smooth_twin: M, qacc_smooth
    and the kinematics at f64 within 1e-9 relative to max(1, |x|); at f32
    within ``ANT_F32_TOL["ant_smooth"]``.  M is symmetric, zero off
    ``mass_support`` exactly.  The last block is part empty (B = 21: one
    env in it at f64)."""
    model = cs._ant_models()[env_id]
    q, v, c = (x[:B] for x in _inputs(dtype, 22, 7)[:3])
    sm = _host_smooth(host_lib, model, q, v, c)
    tw = af.smooth_twin(model, q, v, c)
    tol = 1e-9 if dtype == torch.float64 else cs.ANT_F32_TOL["ant_smooth"]
    for name, g, t in zip(af.Smooth._fields, sm, tw):
        assert torch.isfinite(g).all() and _rel(g, t) <= tol, name
    M = af._batch_mass(sm.M)
    assert torch.equal(M, M.mT)
    off = torch.as_tensor(~af.mass_support(model))
    assert (M[:, off] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("env_id", cs.ANT_IDS)
def test_host_rows_and_newton_equal_twins(host_lib, env_id, dtype):
    """The host chain, smooth -> rows -> newton, each kernel on the
    kernels' own outputs, against the twins: f32 through
    ``chip_smoke.ant_f32_errs``' gates, f64 within 1e-9."""
    model = cs._ant_models()[env_id]
    q, v, c, w = _inputs(dtype, 20, 7)
    sm = _host_smooth(host_lib, model, q, v, c)
    rows = _host_rows(host_lib, model, sm.skin, q, v)
    assert rows.active[af.NJ:].sum() > 0
    if dtype == torch.float32:
        got = _host_newton(host_lib, model, sm, rows, w, 8)
        cs.ant_f32_errs(model, torch.device("cpu"), q, v, c, w, sm, rows, got)
        return
    rt = af.rows_twin(model, sm.skin, q, v)
    full = af._contact.constraint_rows(model, af._skin_kinematics(model, sm.skin), q, v)
    assert _rel(af.dense_rows(model, rows).jac, full.jac) <= 1e-9
    for name in ("aref", "r"):
        assert _rel(getattr(rows, name), getattr(rt, name)) <= 1e-9, name
    assert torch.equal(rows.active, rt.active)
    got = _host_newton(host_lib, model, sm, rows, w, 16)
    want = af.newton_twin(model, sm, rows, w, iters=16)
    for g, t in zip(got, want):
        assert _rel(g, t) <= 1e-9


@pytest.mark.parametrize("env_id", cs.ANT_IDS)
def test_host_newton_every_row_active_equals_twin(host_lib, env_id):
    """Every row active: ne rows an env (404, 848), past the rows the
    kernel keeps in shared memory, at f64 within 1e-9 after 16
    iterations."""
    model = cs._ant_models()[env_id]
    q, v, c, w = _inputs(torch.float64, 10, 5)
    sm = af.ant_smooth(model, q, v, c)
    rows = af.ant_rows(model, sm.skin, q, v)
    rows = rows._replace(active=torch.ones_like(rows.active))
    got = _host_newton(host_lib, model, sm, rows, w, 16)
    want = af.newton_twin(model, sm, rows, w, iters=16)
    for g, t in zip(got, want):
        assert _rel(g, t) <= 1e-9


@pytest.mark.parametrize("env_id,dtype,every_row", [
    (cs.ANT_IDS[0], dtype, every_row)
    for dtype in (torch.float64, torch.float32) for every_row in (False, True)]
    + [(cs.ANT_IDS[1], torch.float64, False)])
def test_host_newton_counts_active_rows(host_lib, env_id, dtype, every_row):
    """With a counter, the Newton solve adds every env's active rows to it
    (a warp sum, one atomic add a block; the last block part empty) and
    solves bit for bit as with none."""
    model = cs._ant_models()[env_id]
    q, v, c, w = _inputs(dtype, 20, 7)
    sm = _host_smooth(host_lib, model, q, v, c)
    rows = _host_rows(host_lib, model, sm.skin, q, v)
    if every_row:
        rows = rows._replace(active=torch.ones_like(rows.active))
    count = torch.full((), 5, dtype=torch.int64)
    got = _host_newton(host_lib, model, sm, rows, w, 2, count)
    want = _host_newton(host_lib, model, sm, rows, w, 2)
    assert int(count) == 5 + int((rows.active != 0).sum()) > 5
    for g, t in zip(got, want):
        assert torch.equal(g, t)
