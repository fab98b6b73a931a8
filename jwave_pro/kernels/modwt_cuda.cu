// Fused MODWT cascade kernels for NVIDIA Hopper (sm_90a), called from JAX
// through the XLA foreign function interface.  Built and registered by
// jwave_pro/kernels/modwt_cuda.py, which also holds the plan (tile, halo,
// shared-memory size) and a jnp rendering of the same block program that
// the CPU tests run.
//
// One thread block owns one (row, tile) window of the signal.  The window
// carries the circular context the level chain consumes: `halo` samples on
// the left for the analysis cascade, on the right for the synthesis cascade
// (both, for denoise).  `halo` is (M-1)(2^L-1) rounded up to 32 samples, so
// window index p and signal position share their alignment and every warp's
// global load and store covers whole 128-byte lines.  The circular wrap and
// arbitrary N are handled by each block's own indexed loads (position mod
// N); nothing carries over between blocks.
//
// All levels run inside the block, out of shared memory, one level at a
// time with a barrier between levels.  Inputs and outputs are f32 or bf16;
// arithmetic is f32 FMA (no tensor cores, so TF32 never enters).
//
// Semantics match jwave_pro/ops/modwt.py's direct path:
//   forward  W_j[n] = sum_k h[k] V_{j-1}[n - k 2^{j-1}],  V_j likewise with g
//   inverse  V_{j-1}[n] = sum_k g[k] V_j[n + k 2^{j-1}] + h[k] W_j[n + k 2^{j-1}]
// (MODWTTransform.java:677-716 on upsampled filters).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <string>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTaps = 64;

// Filter taps ride in the kernel's parameter space: with a compile-time tap
// count the unrolled FMAs read them as constant-bank operands.
struct Taps {
  float g[kMaxTaps];
  float h[kMaxTaps];
  int m;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// dst[i] = src[(start + i) mod n] for i in [lo, hi).
template <typename T>
__device__ void load_window(float* dst, const T* __restrict__ src,
                            int64_t start, int64_t n, int lo, int hi) {
  if (start + lo >= 0 && start + hi <= n) {
    for (int i = lo + threadIdx.x; i < hi; i += blockDim.x)
      dst[i] = to_f32(src[start + i]);
  } else {
    for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) {
      int64_t q = (start + i) % n;
      dst[i] = to_f32(src[q < 0 ? q + n : q]);
    }
  }
}

// Sum over the block; the result is valid in thread 0.
__device__ float block_sum(float s) {
  __shared__ float part[kThreads / 32];
  for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = s;
  __syncthreads();
  float t = 0.f;
  if (threadIdx.x < 32) {
    t = threadIdx.x < kThreads / 32 ? part[threadIdx.x] : 0.f;
    for (int o = 16; o > 0; o >>= 1) t += __shfl_down_sync(0xffffffffu, t, o);
  }
  __syncthreads();
  return t;
}

// One analysis level over window indices [lo & ~31, width): V goes to `nxt`
// (from `lo` on, where all taps read valid samples); each computed W value
// is handed to `emit(p, w)`.
template <int M, typename Emit>
__device__ __forceinline__ void analysis_level(const float* cur, float* nxt,
                                               int lo, int width, int d,
                                               const Taps& taps, Emit emit) {
  const int m = M > 0 ? M : taps.m;
  for (int p = (lo & ~31) + threadIdx.x; p < width; p += blockDim.x) {
    if (p < lo) continue;
    float v = 0.f, w = 0.f;
#pragma unroll
    for (int k = 0; k < m; ++k) {
      const float s = cur[p - k * d];
      v = fmaf(taps.g[k], s, v);
      w = fmaf(taps.h[k], s, w);
    }
    nxt[p] = v;
    emit(p, w);
  }
}

// One synthesis level: nv[q] = sum_k g[k] v[q + k d] + h[k] w[q + k d] for
// q in [0, end).
template <int M>
__device__ __forceinline__ void synthesis_level(const float* v, const float* w,
                                                float* nv, int end, int d,
                                                const Taps& taps) {
  const int m = M > 0 ? M : taps.m;
  for (int q = threadIdx.x; q < end; q += blockDim.x) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < m; ++k) {
      acc = fmaf(taps.g[k], v[q + k * d], acc);
      acc = fmaf(taps.h[k], w[q + k * d], acc);
    }
    nv[q] = acc;
  }
}

// Forward: x (rows, n) -> out (level+1, rows, n) = W_1..W_L, V_L.
// Shared memory: 2 * (tile + halo) floats.
template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
    modwt_fwd_kernel(const T* __restrict__ x, T* __restrict__ out, int64_t n,
                     int64_t rows, int level, int tile, int halo, Taps taps) {
  extern __shared__ float smem[];
  const int m = M > 0 ? M : taps.m;
  const int width = tile + halo;
  const int64_t ntiles = (n + tile - 1) / tile;
  const int64_t row = blockIdx.x / ntiles;
  const int64_t t0 = (blockIdx.x % ntiles) * tile;
  const int64_t plane = rows * n;
  float* cur = smem;
  float* nxt = smem + width;

  load_window(cur, x + row * n, t0 - halo, n, 0, width);
  __syncthreads();
  int off = 0;  // cur is valid on [off, width)
  for (int j = 1; j <= level; ++j) {
    const int d = 1 << (j - 1);
    const int lo = off + (m - 1) * d;
    T* wrow = out + (j - 1) * plane + row * n;
    analysis_level<M>(cur, nxt, lo, width, d, taps, [&](int p, float w) {
      const int64_t pos = t0 + p - halo;
      if (p >= halo && pos < n) wrow[pos] = from_f32<T>(w);
    });
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
    off = lo;
  }
  T* vrow = out + level * plane + row * n;
  for (int p = halo + threadIdx.x; p < width; p += blockDim.x) {
    const int64_t pos = t0 + p - halo;
    if (pos < n) vrow[pos] = from_f32<T>(cur[p]);
  }
}

// Inverse: c (level+1, rows, n) -> out (rows, n).
// Shared memory: 3 * (tile + halo) floats.
template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
    modwt_inv_kernel(const T* __restrict__ c, T* __restrict__ out, int64_t n,
                     int64_t rows, int level, int tile, int halo, Taps taps) {
  extern __shared__ float smem[];
  const int m = M > 0 ? M : taps.m;
  const int width = tile + halo;
  const int64_t ntiles = (n + tile - 1) / tile;
  const int64_t row = blockIdx.x / ntiles;
  const int64_t t0 = (blockIdx.x % ntiles) * tile;
  const int64_t plane = rows * n;
  float* v = smem;
  float* w = smem + width;
  float* nv = smem + 2 * width;

  load_window(v, c + level * plane + row * n, t0, n, 0, width);
  int end = width;  // v is valid on [0, end)
  for (int j = level; j >= 1; --j) {
    const int d = 1 << (j - 1);
    load_window(w, c + (j - 1) * plane + row * n, t0, n, 0, end);
    __syncthreads();
    end -= (m - 1) * d;
    synthesis_level<M>(v, w, nv, end, d, taps);
    __syncthreads();
    float* t = v;
    v = nv;
    nv = t;
  }
  T* orow = out + row * n;
  for (int p = threadIdx.x; p < tile; p += blockDim.x) {
    const int64_t pos = t0 + p;
    if (pos < n) orow[pos] = from_f32<T>(v[p]);
  }
}

// Denoise: x (rows, n), thr (level, rows) -> out (rows, n): analysis,
// soft (mode 0) or hard (mode 1) shrinkage of W_1..W_L, synthesis.
// Window [t0 - halo, t0 + tile + halo).  Shared memory:
// 2 * (tile + 2 halo) + level * (tile + halo) floats.
template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
    modwt_denoise_kernel(const T* __restrict__ x, const float* __restrict__ thr,
                         T* __restrict__ out, int64_t n, int64_t rows,
                         int level, int tile, int halo, int mode, Taps taps) {
  extern __shared__ float smem[];
  const int m = M > 0 ? M : taps.m;
  const int width = tile + 2 * halo;
  const int span = tile + halo;  // detail rows keep window [halo, width)
  const int64_t ntiles = (n + tile - 1) / tile;
  const int64_t row = blockIdx.x / ntiles;
  const int64_t t0 = (blockIdx.x % ntiles) * tile;
  float* cur = smem;
  float* nxt = smem + width;
  float* det = smem + 2 * width;

  load_window(cur, x + row * n, t0 - halo, n, 0, width);
  __syncthreads();
  int off = 0;
  for (int j = 1; j <= level; ++j) {
    const int d = 1 << (j - 1);
    const int lo = off + (m - 1) * d;
    const float t = thr[(j - 1) * rows + row];
    float* drow = det + (j - 1) * span;
    analysis_level<M>(cur, nxt, lo, width, d, taps, [&](int p, float w) {
      if (p >= halo) {
        drow[p - halo] = mode == 0
            ? copysignf(fmaxf(fabsf(w) - t, 0.f), w)
            : (fabsf(w) > t ? w : 0.f);
      }
    });
    __syncthreads();
    float* s = cur;
    cur = nxt;
    nxt = s;
    off = lo;
  }
  // Synthesis on window indices shifted by halo: q = p - halo.
  float* v = cur + halo;
  float* nv = nxt;
  int end = span;
  for (int j = level; j >= 1; --j) {
    const int d = 1 << (j - 1);
    end -= (m - 1) * d;
    synthesis_level<M>(v, det + (j - 1) * span, nv, end, d, taps);
    __syncthreads();
    float* s = v;
    v = nv;
    nv = s;
  }
  T* orow = out + row * n;
  for (int p = threadIdx.x; p < tile; p += blockDim.x) {
    const int64_t pos = t0 + p;
    if (pos < n) orow[pos] = from_f32<T>(v[p]);
  }
}

// Variance: x (rows, n) -> partial (rows, ntiles, level+1) f32 sums of
// W_1^2..W_L^2, V_L^2 over the block's tile.  Shared memory as the forward.
template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
    modwt_var_kernel(const T* __restrict__ x, float* __restrict__ partial,
                     int64_t n, int level, int tile, int halo, Taps taps) {
  extern __shared__ float smem[];
  const int m = M > 0 ? M : taps.m;
  const int width = tile + halo;
  const int64_t ntiles = (n + tile - 1) / tile;
  const int64_t row = blockIdx.x / ntiles;
  const int64_t t0 = (blockIdx.x % ntiles) * tile;
  float* cur = smem;
  float* nxt = smem + width;
  float* dst = partial + static_cast<int64_t>(blockIdx.x) * (level + 1);

  load_window(cur, x + row * n, t0 - halo, n, 0, width);
  __syncthreads();
  int off = 0;
  for (int j = 1; j <= level; ++j) {
    const int d = 1 << (j - 1);
    const int lo = off + (m - 1) * d;
    float s = 0.f;
    analysis_level<M>(cur, nxt, lo, width, d, taps, [&](int p, float w) {
      if (p >= halo && t0 + p - halo < n) s = fmaf(w, w, s);
    });
    s = block_sum(s);  // its barriers also order nxt's writes
    if (threadIdx.x == 0) dst[j - 1] = s;
    float* t = cur;
    cur = nxt;
    nxt = t;
    off = lo;
  }
  float s = 0.f;
  for (int p = halo + threadIdx.x; p < width; p += blockDim.x)
    if (t0 + p - halo < n) s = fmaf(cur[p], cur[p], s);
  s = block_sum(s);
  if (threadIdx.x == 0) dst[level] = s;
}

// ---------------------------------------------------------------------------
// Host side: launch configuration and FFI handlers.
// ---------------------------------------------------------------------------

ffi::Error check(cudaError_t err, const char* what) {
  if (err != cudaSuccess)
    return ffi::Error::Internal(std::string(what) + ": " +
                                cudaGetErrorString(err));
  return ffi::Error::Success();
}

ffi::Error make_taps(ffi::Span<const float> g, ffi::Span<const float> h,
                     Taps* taps) {
  if (g.size() != h.size() || g.size() < 1 || g.size() > kMaxTaps)
    return ffi::Error::InvalidArgument("filter banks must have 1..64 taps");
  for (size_t k = 0; k < g.size(); ++k) {
    taps->g[k] = g[k];
    taps->h[k] = h[k];
  }
  taps->m = static_cast<int>(g.size());
  return ffi::Error::Success();
}

// Everything a launch needs besides the kernel's own template arguments.
struct Args {
  cudaStream_t stream;
  const void* in;
  const float* thr;
  void* out;
  int64_t rows, n;
  int level, tile, halo, mode;
  size_t smem;
  Taps taps;
  int64_t blocks() const { return rows * ((n + tile - 1) / tile); }
};

// Opting in above 48 KiB of dynamic shared memory is per kernel; the
// attribute is cheap to set on every call.
template <typename K>
ffi::Error allow_smem(K kernel, size_t smem) {
  return check(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)),
      "shared memory opt-in");
}

struct Fwd {
  template <typename T, int M>
  static ffi::Error run(const Args& a) {
    auto kernel = modwt_fwd_kernel<T, M>;
    ffi::Error e = allow_smem(kernel, a.smem);
    if (e.failure()) return e;
    kernel<<<a.blocks(), kThreads, a.smem, a.stream>>>(
        static_cast<const T*>(a.in), static_cast<T*>(a.out), a.n, a.rows,
        a.level, a.tile, a.halo, a.taps);
    return check(cudaGetLastError(), "modwt forward launch");
  }
};

struct Inv {
  template <typename T, int M>
  static ffi::Error run(const Args& a) {
    auto kernel = modwt_inv_kernel<T, M>;
    ffi::Error e = allow_smem(kernel, a.smem);
    if (e.failure()) return e;
    kernel<<<a.blocks(), kThreads, a.smem, a.stream>>>(
        static_cast<const T*>(a.in), static_cast<T*>(a.out), a.n, a.rows,
        a.level, a.tile, a.halo, a.taps);
    return check(cudaGetLastError(), "modwt inverse launch");
  }
};

struct Denoise {
  template <typename T, int M>
  static ffi::Error run(const Args& a) {
    auto kernel = modwt_denoise_kernel<T, M>;
    ffi::Error e = allow_smem(kernel, a.smem);
    if (e.failure()) return e;
    kernel<<<a.blocks(), kThreads, a.smem, a.stream>>>(
        static_cast<const T*>(a.in), a.thr, static_cast<T*>(a.out), a.n,
        a.rows, a.level, a.tile, a.halo, a.mode, a.taps);
    return check(cudaGetLastError(), "modwt denoise launch");
  }
};

struct Var {
  template <typename T, int M>
  static ffi::Error run(const Args& a) {
    auto kernel = modwt_var_kernel<T, M>;
    ffi::Error e = allow_smem(kernel, a.smem);
    if (e.failure()) return e;
    kernel<<<a.blocks(), kThreads, a.smem, a.stream>>>(
        static_cast<const T*>(a.in), static_cast<float*>(a.out), a.n,
        a.level, a.tile, a.halo, a.taps);
    return check(cudaGetLastError(), "modwt variance launch");
  }
};

// Instantiates K::run for the element type and the compile-time tap count
// (0: a runtime count, for filter lengths not instantiated here).
template <typename K, typename T>
ffi::Error by_taps(const Args& a) {
  switch (a.taps.m) {
    case 2: return K::template run<T, 2>(a);
    case 4: return K::template run<T, 4>(a);
    case 6: return K::template run<T, 6>(a);
    case 8: return K::template run<T, 8>(a);
    case 12: return K::template run<T, 12>(a);
    case 16: return K::template run<T, 16>(a);
    case 20: return K::template run<T, 20>(a);
    default: return K::template run<T, 0>(a);
  }
}

template <typename K>
ffi::Error dispatch(ffi::DataType dtype, const Args& a) {
  if (a.blocks() > 0x7fffffff)
    return ffi::Error::InvalidArgument("too many tiles for one launch");
  if (dtype == ffi::DataType::F32) return by_taps<K, float>(a);
  if (dtype == ffi::DataType::BF16) return by_taps<K, __nv_bfloat16>(a);
  return ffi::Error::InvalidArgument("expected float32 or bfloat16 data");
}

ffi::Error FwdImpl(cudaStream_t stream, ffi::AnyBuffer x,
                   ffi::Result<ffi::AnyBuffer> out, int32_t level,
                   int32_t tile, int32_t halo, ffi::Span<const float> g,
                   ffi::Span<const float> h) {
  Args a{};
  ffi::Error e = make_taps(g, h, &a.taps);
  if (e.failure()) return e;
  auto dims = x.dimensions();
  if (dims.size() != 2) return ffi::Error::InvalidArgument("x must be 2-D");
  a.stream = stream;
  a.in = x.untyped_data();
  a.out = out->untyped_data();
  a.rows = dims[0];
  a.n = dims[1];
  a.level = level;
  a.tile = tile;
  a.halo = halo;
  a.smem = 2 * static_cast<size_t>(tile + halo) * sizeof(float);
  return dispatch<Fwd>(x.element_type(), a);
}

ffi::Error InvImpl(cudaStream_t stream, ffi::AnyBuffer c,
                   ffi::Result<ffi::AnyBuffer> out, int32_t tile, int32_t halo,
                   ffi::Span<const float> g, ffi::Span<const float> h) {
  Args a{};
  ffi::Error e = make_taps(g, h, &a.taps);
  if (e.failure()) return e;
  auto dims = c.dimensions();
  if (dims.size() != 3) return ffi::Error::InvalidArgument("c must be 3-D");
  a.stream = stream;
  a.in = c.untyped_data();
  a.out = out->untyped_data();
  a.level = static_cast<int>(dims[0]) - 1;
  a.rows = dims[1];
  a.n = dims[2];
  a.tile = tile;
  a.halo = halo;
  a.smem = 3 * static_cast<size_t>(tile + halo) * sizeof(float);
  return dispatch<Inv>(c.element_type(), a);
}

ffi::Error DenoiseImpl(cudaStream_t stream, ffi::AnyBuffer x,
                       ffi::Buffer<ffi::F32> thr,
                       ffi::Result<ffi::AnyBuffer> out, int32_t level,
                       int32_t tile, int32_t halo, int32_t mode,
                       ffi::Span<const float> g, ffi::Span<const float> h) {
  Args a{};
  ffi::Error e = make_taps(g, h, &a.taps);
  if (e.failure()) return e;
  auto dims = x.dimensions();
  if (dims.size() != 2) return ffi::Error::InvalidArgument("x must be 2-D");
  a.stream = stream;
  a.in = x.untyped_data();
  a.thr = thr.typed_data();
  a.out = out->untyped_data();
  a.rows = dims[0];
  a.n = dims[1];
  a.level = level;
  a.tile = tile;
  a.halo = halo;
  a.mode = mode;
  a.smem = (2 * static_cast<size_t>(tile + 2 * halo) +
            static_cast<size_t>(level) * (tile + halo)) * sizeof(float);
  return dispatch<Denoise>(x.element_type(), a);
}

ffi::Error VarImpl(cudaStream_t stream, ffi::AnyBuffer x,
                   ffi::Result<ffi::Buffer<ffi::F32>> partial, int32_t level,
                   int32_t tile, int32_t halo, ffi::Span<const float> g,
                   ffi::Span<const float> h) {
  Args a{};
  ffi::Error e = make_taps(g, h, &a.taps);
  if (e.failure()) return e;
  auto dims = x.dimensions();
  if (dims.size() != 2) return ffi::Error::InvalidArgument("x must be 2-D");
  a.stream = stream;
  a.in = x.untyped_data();
  a.out = partial->typed_data();
  a.rows = dims[0];
  a.n = dims[1];
  a.level = level;
  a.tile = tile;
  a.halo = halo;
  a.smem = 2 * static_cast<size_t>(tile + halo) * sizeof(float);
  return dispatch<Var>(x.element_type(), a);
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    JwaveModwtFwd, FwdImpl,
    ffi::Ffi::Bind()
        .Ctx<ffi::PlatformStream<cudaStream_t>>()
        .Arg<ffi::AnyBuffer>()
        .Ret<ffi::AnyBuffer>()
        .Attr<int32_t>("level")
        .Attr<int32_t>("tile")
        .Attr<int32_t>("halo")
        .Attr<ffi::Span<const float>>("g")
        .Attr<ffi::Span<const float>>("h"));

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    JwaveModwtInv, InvImpl,
    ffi::Ffi::Bind()
        .Ctx<ffi::PlatformStream<cudaStream_t>>()
        .Arg<ffi::AnyBuffer>()
        .Ret<ffi::AnyBuffer>()
        .Attr<int32_t>("tile")
        .Attr<int32_t>("halo")
        .Attr<ffi::Span<const float>>("g")
        .Attr<ffi::Span<const float>>("h"));

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    JwaveModwtDenoise, DenoiseImpl,
    ffi::Ffi::Bind()
        .Ctx<ffi::PlatformStream<cudaStream_t>>()
        .Arg<ffi::AnyBuffer>()
        .Arg<ffi::Buffer<ffi::F32>>()
        .Ret<ffi::AnyBuffer>()
        .Attr<int32_t>("level")
        .Attr<int32_t>("tile")
        .Attr<int32_t>("halo")
        .Attr<int32_t>("mode")
        .Attr<ffi::Span<const float>>("g")
        .Attr<ffi::Span<const float>>("h"));

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    JwaveModwtVar, VarImpl,
    ffi::Ffi::Bind()
        .Ctx<ffi::PlatformStream<cudaStream_t>>()
        .Arg<ffi::AnyBuffer>()
        .Ret<ffi::Buffer<ffi::F32>>()
        .Attr<int32_t>("level")
        .Attr<int32_t>("tile")
        .Attr<int32_t>("halo")
        .Attr<ffi::Span<const float>>("g")
        .Attr<ffi::Span<const float>>("h"));
