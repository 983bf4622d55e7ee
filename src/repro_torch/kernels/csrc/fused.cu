// Fused pointwise passes between a dense block's matrix products, for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves this work to XLA, which
// fuses each gap between two dots into one loop of its own. In eager
// PyTorch (and in a CUDA graph captured from it) each ATen op of that work
// is a kernel of its own that reads and writes its operands in f32 or bf16:
// about 60 small launches a layer. These three kernels do each gap's work
// in one pass, in the same arithmetic as the plain ops of
// src/repro_torch/kernels/ref.py, which they are held to:
//
//   add_rms_norm_kernel      s = x + r rounded to x's type (the residual
//                            stream), then rms_norm(s) * (1 + w); without
//                            r, rms_norm(x). One block a row: f32 sum of
//                            squares by warp shuffles and one shared-memory
//                            step, then the row read again (from L1/L2)
//                            and scaled.
//   rope_cache_write_kernel  q, k (+ their biases, rounded as an add in the
//                            working type rounds) rotated over split halves
//                            in f32 and rounded; q written out, k and v
//                            (+ its bias) written into the (B, Smax, Hkv, D)
//                            caches at clamp(write_pos, 0, Smax - S) + s,
//                            in the cache's type: the working type, or
//                            e4m3 under the JAX package's rule (|x| > 464
//                            or NaN: NaN with x's sign; else round to
//                            nearest even, which stays within +-448).
//   gated_act_kernel         act(g) rounded, times u, rounded: SiLU
//                            x / (1 + exp(-x)) or tanh-GELU, in ATen's own
//                            expressions, so the result is ATen's bit for
//                            bit.
//
// Bound on this card: the bytes, and at decode (16 rows) the launch itself.
// The passes do no tiling and hold no intermediate in device memory: each
// thread moves 16-byte vectors (8 bf16 or 4 f32; scalars where a width is
// not a multiple of that), products and sums are f32 with rounding only
// where the plain ops round, and every multiply and add is written with
// its rounding intrinsic so the compiler cannot contract it into an FMA
// the plain ops do not make.
//
// dtype codes: 0 = f32, 1 = bf16 (the working type of x, q, k, v, g, u);
// the cache code: 0 = the working type, 1 = e4m3.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "activation.cuh"

namespace {

template <typename T>
struct Num;

template <>
struct Num<float> {
  static __device__ __forceinline__ float to_f(float x) { return x; }
  static __device__ __forceinline__ float from_f(float x) { return x; }
};

template <>
struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
  static __device__ __forceinline__ __nv_bfloat16 from_f(float x) { return __float2bfloat16_rn(x); }
};

// V consecutive elements, loaded and stored as one access.
template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Vec<T, V> load(const T* p) {
  return *reinterpret_cast<const Vec<T, V>*>(p);
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const Vec<T, V>& x) {
  *reinterpret_cast<Vec<T, V>*>(p) = x;
}

// x rounded to the working type and back to f32: what a tensor op whose
// output is in that type leaves.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return Num<T>::to_f(Num<T>::from_f(x));
}

constexpr float kE4m3Overflow = 464.0f;

__device__ __forceinline__ uint8_t to_e4m3(float x) {
  const uint8_t sign = static_cast<uint8_t>((__float_as_uint(x) >> 24) & 0x80u);
  if (isnan(x) || fabsf(x) > kE4m3Overflow) return sign | 0x7Fu;
  return static_cast<uint8_t>(__nv_cvt_float_to_fp8(x, __NV_SATFINITE, __NV_E4M3));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// ---------------------------------------------------------------------------
// residual add + RMSNorm
// ---------------------------------------------------------------------------

template <typename T, int V>
__global__ void add_rms_norm_kernel(const T* __restrict__ x, const T* __restrict__ r,
                                    const T* __restrict__ w, T* __restrict__ sum_out,
                                    T* __restrict__ out, int d, float eps) {
  __shared__ float partial[32];
  const size_t base = static_cast<size_t>(blockIdx.x) * d;
  const int nvec = d / V;
  float ss = 0.0f;
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    Vec<T, V> a = load<T, V>(x + base + i * V);
    if (r != nullptr) {
      const Vec<T, V> b = load<T, V>(r + base + i * V);
#pragma unroll
      for (int e = 0; e < V; ++e)
        a.v[e] = Num<T>::from_f(__fadd_rn(Num<T>::to_f(a.v[e]), Num<T>::to_f(b.v[e])));
      store<T, V>(sum_out + base + i * V, a);
    }
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float f = Num<T>::to_f(a.v[e]);
      ss = __fadd_rn(ss, __fmul_rn(f, f));
    }
  }
  ss = warp_sum(ss);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    const int nwarps = (blockDim.x + 31) >> 5;
    float t = lane < nwarps ? partial[lane] : 0.0f;
    t = warp_sum(t);
    if (lane == 0) partial[0] = t;
  }
  __syncthreads();
  // mean as ATen takes it (the sum times 1/d), then rsqrt(var + eps)
  const float var = __fmul_rn(partial[0], 1.0f / static_cast<float>(d));
  const float inv = rsqrtf(__fadd_rn(var, eps));
  // the row again (from L1/L2), its sum formed again as above
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    Vec<T, V> a = load<T, V>(x + base + i * V);
    if (r != nullptr) {
      const Vec<T, V> b = load<T, V>(r + base + i * V);
#pragma unroll
      for (int e = 0; e < V; ++e)
        a.v[e] = Num<T>::from_f(__fadd_rn(Num<T>::to_f(a.v[e]), Num<T>::to_f(b.v[e])));
    }
    const Vec<T, V> s = load<T, V>(w + i * V);
    Vec<T, V> o;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float n = __fmul_rn(Num<T>::to_f(a.v[e]), inv);
      o.v[e] = Num<T>::from_f(__fmul_rn(n, __fadd_rn(1.0f, Num<T>::to_f(s.v[e]))));
    }
    store<T, V>(out + base + i * V, o);
  }
}

template <typename T, int V>
cudaError_t launch_norm(const void* x, const void* r, const void* w, void* sum, void* out, int rows,
                        int d, float eps, cudaStream_t stream) {
  const int nvec = d / V;
  int threads = ((nvec + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 512 ? 512 : threads);
  add_rms_norm_kernel<T, V><<<rows, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(r), static_cast<const T*>(w),
      static_cast<T*>(sum), static_cast<T*>(out), d, eps);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bias + rope on q and k, K/V into the cache
// ---------------------------------------------------------------------------

template <typename T, int V>
__device__ __forceinline__ Vec<T, V> add_bias(Vec<T, V> a, const T* bias) {
  if (bias == nullptr) return a;
  const Vec<T, V> b = load<T, V>(bias);
#pragma unroll
  for (int e = 0; e < V; ++e)
    a.v[e] = Num<T>::from_f(__fadd_rn(Num<T>::to_f(a.v[e]), Num<T>::to_f(b.v[e])));
  return a;
}

template <typename T, int V>
__device__ __forceinline__ void rotate(Vec<T, V>& x1, Vec<T, V>& x2, const float* cos,
                                       const float* sin) {
  const Vec<float, V> c = load<float, V>(cos);
  const Vec<float, V> s = load<float, V>(sin);
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const float a = Num<T>::to_f(x1.v[e]), b = Num<T>::to_f(x2.v[e]);
    x1.v[e] = Num<T>::from_f(__fsub_rn(__fmul_rn(a, c.v[e]), __fmul_rn(b, s.v[e])));
    x2.v[e] = Num<T>::from_f(__fadd_rn(__fmul_rn(b, c.v[e]), __fmul_rn(a, s.v[e])));
  }
}

template <typename T, typename C, int V>
struct CacheStore {
  static __device__ __forceinline__ void put(C* p, const Vec<T, V>& x) {
    store<T, V>(p, x);
  }
};

template <typename T, int V>
struct CacheStore<T, uint8_t, V> {
  static __device__ __forceinline__ void put(uint8_t* p, const Vec<T, V>& x) {
    Vec<uint8_t, V> b;
#pragma unroll
    for (int e = 0; e < V; ++e) b.v[e] = to_e4m3(Num<T>::to_f(x.v[e]));
    store<uint8_t, V>(p, b);
  }
};

// Grid (B*S rows, chunks of the row's items). A row's items, in order: the
// q pairs (Hq * D/2 / V), the k pairs (Hkv * D/2 / V), the v vectors
// (Hkv * D / V). A pair is V elements of a head's first half and the V at
// the same offset in its second half.
template <typename T, typename C, int V>
__global__ void rope_cache_write_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ cos, const float* __restrict__ sin, const T* __restrict__ bq,
    const T* __restrict__ bk, const T* __restrict__ bv, T* __restrict__ q_out,
    C* __restrict__ k_cache, C* __restrict__ v_cache, const int* __restrict__ write_pos, int s,
    int hq, int hkv, int d, int smax) {
  const int row = blockIdx.x;
  const int half = d / 2, hv = half / V, dv = d / V;
  const int n_q = hq * hv, n_k = hkv * hv, n_v = hkv * dv;
  const int item = blockIdx.y * blockDim.x + threadIdx.x;
  if (item >= n_q + n_k + n_v) return;
  const float* cr = cos + static_cast<size_t>(row) * half;
  const float* sr = sin + static_cast<size_t>(row) * half;
  const int b = row / s, t = row % s;
  int start = write_pos[b];
  start = start < 0 ? 0 : (start > smax - s ? smax - s : start);
  const size_t cache_row = (static_cast<size_t>(b) * smax + start + t) * hkv;
  if (item < n_q) {
    const int h = item / hv, j = (item % hv) * V;
    const size_t o = (static_cast<size_t>(row) * hq + h) * d + j;
    Vec<T, V> x1 = add_bias<T, V>(load<T, V>(q + o), bq ? bq + h * d + j : nullptr);
    Vec<T, V> x2 = add_bias<T, V>(load<T, V>(q + o + half), bq ? bq + h * d + j + half : nullptr);
    rotate<T, V>(x1, x2, cr + j, sr + j);
    store<T, V>(q_out + o, x1);
    store<T, V>(q_out + o + half, x2);
  } else if (item < n_q + n_k) {
    const int i = item - n_q, h = i / hv, j = (i % hv) * V;
    const size_t o = (static_cast<size_t>(row) * hkv + h) * d + j;
    Vec<T, V> x1 = add_bias<T, V>(load<T, V>(k + o), bk ? bk + h * d + j : nullptr);
    Vec<T, V> x2 = add_bias<T, V>(load<T, V>(k + o + half), bk ? bk + h * d + j + half : nullptr);
    rotate<T, V>(x1, x2, cr + j, sr + j);
    C* dst = k_cache + (cache_row + h) * d + j;
    CacheStore<T, C, V>::put(dst, x1);
    CacheStore<T, C, V>::put(dst + half, x2);
  } else {
    const int i = item - n_q - n_k, h = i / dv, j = (i % dv) * V;
    const size_t o = (static_cast<size_t>(row) * hkv + h) * d + j;
    const Vec<T, V> x = add_bias<T, V>(load<T, V>(v + o), bv ? bv + h * d + j : nullptr);
    CacheStore<T, C, V>::put(v_cache + (cache_row + h) * d + j, x);
  }
}

template <typename T, typename C, int V>
cudaError_t launch_rope(const void* q, const void* k, const void* v, const void* cos,
                        const void* sin, const void* bq, const void* bk, const void* bv,
                        void* q_out, void* k_cache, void* v_cache, const void* write_pos, int b,
                        int s, int hq, int hkv, int d, int smax, cudaStream_t stream) {
  const int items = (hq + hkv) * (d / 2 / V) + hkv * (d / V);
  const int threads = items < 256 ? ((items + 31) / 32) * 32 : 256;
  const dim3 grid(b * s, (items + threads - 1) / threads);
  rope_cache_write_kernel<T, C, V><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(cos), static_cast<const float*>(sin),
      static_cast<const T*>(bq), static_cast<const T*>(bk), static_cast<const T*>(bv),
      static_cast<T*>(q_out), static_cast<C*>(k_cache), static_cast<C*>(v_cache),
      static_cast<const int*>(write_pos), s, hq, hkv, d, smax);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t dispatch_rope_cache(int kv_e4m3, const void* q, const void* k, const void* v,
                                const void* cos, const void* sin, const void* bq, const void* bk,
                                const void* bv, void* q_out, void* k_cache, void* v_cache,
                                const void* write_pos, int b, int s, int hq, int hkv, int d,
                                int smax, cudaStream_t stream) {
  return kv_e4m3
      ? launch_rope<T, uint8_t, V>(q, k, v, cos, sin, bq, bk, bv, q_out, k_cache, v_cache,
                                   write_pos, b, s, hq, hkv, d, smax, stream)
      : launch_rope<T, T, V>(q, k, v, cos, sin, bq, bk, bv, q_out, k_cache, v_cache, write_pos,
                             b, s, hq, hkv, d, smax, stream);
}

// ---------------------------------------------------------------------------
// gated activation
// ---------------------------------------------------------------------------

template <typename T, int V, int kGelu>
__global__ void gated_act_kernel(const T* __restrict__ g, const T* __restrict__ u,
                                 T* __restrict__ out, long long n) {
  const long long nvec = n / V;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < nvec;
       i += stride) {
    const Vec<T, V> a = load<T, V>(g + i * V);
    const Vec<T, V> b = load<T, V>(u + i * V);
    Vec<T, V> o;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float x = Num<T>::to_f(a.v[e]);
      const float act = round_to<T>(kGelu ? rt::gelu_tanh(x) : rt::silu(x));
      o.v[e] = Num<T>::from_f(__fmul_rn(act, Num<T>::to_f(b.v[e])));
    }
    store<T, V>(out + i * V, o);
  }
}

template <typename T, int V>
cudaError_t launch_gated(const void* g, const void* u, void* out, long long n, int gelu,
                         cudaStream_t stream) {
  const long long nvec = n / V;
  long long blocks = (nvec + 255) / 256;
  blocks = blocks < 1 ? 1 : (blocks > 132 * 16 ? 132 * 16 : blocks);
  auto kernel = gelu ? gated_act_kernel<T, V, 1> : gated_act_kernel<T, V, 0>;
  kernel<<<static_cast<int>(blocks), 256, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(u), static_cast<T*>(out), n);
  return cudaGetLastError();
}

// Whether a width of n elements splits into 16-byte vectors of T.
template <typename T>
bool vector_fits(long long n) {
  return n % (16 / static_cast<long long>(sizeof(T))) == 0;
}

}  // namespace

extern "C" {

// rows rows of d; r may be null (plain RMSNorm, sum unused). Returns the
// cudaError_t of the launch.
int add_rms_norm_launch(const void* x, const void* r, const void* w, void* sum, void* out,
                        int rows, int d, float eps, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1)
    err = vector_fits<__nv_bfloat16>(d)
              ? launch_norm<__nv_bfloat16, 8>(x, r, w, sum, out, rows, d, eps, st)
              : launch_norm<__nv_bfloat16, 1>(x, r, w, sum, out, rows, d, eps, st);
  else
    err = vector_fits<float>(d) ? launch_norm<float, 4>(x, r, w, sum, out, rows, d, eps, st)
                                  : launch_norm<float, 1>(x, r, w, sum, out, rows, d, eps, st);
  return static_cast<int>(err);
}

// q (B*S, Hq, D), k and v (B*S, Hkv, D), cos and sin (B*S, D/2) f32, the
// biases (H, D) or null, caches (B, Smax, Hkv, D), write_pos (B,) int32.
int rope_cache_write_launch(const void* q, const void* k, const void* v, const void* cos,
                            const void* sin, const void* bq, const void* bk, const void* bv,
                            void* q_out, void* k_cache, void* v_cache, const void* write_pos,
                            int b, int s, int hq, int hkv, int d, int smax, int dtype, int kv_e4m3,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1)
    err = vector_fits<__nv_bfloat16>(d / 2)
              ? dispatch_rope_cache<__nv_bfloat16, 8>(kv_e4m3, q, k, v, cos, sin, bq, bk, bv,
                                                      q_out, k_cache, v_cache, write_pos, b, s,
                                                      hq, hkv, d, smax, st)
              : dispatch_rope_cache<__nv_bfloat16, 1>(kv_e4m3, q, k, v, cos, sin, bq, bk, bv,
                                                      q_out, k_cache, v_cache, write_pos, b, s,
                                                      hq, hkv, d, smax, st);
  else
    err = vector_fits<float>(d / 2)
              ? dispatch_rope_cache<float, 4>(kv_e4m3, q, k, v, cos, sin, bq, bk, bv, q_out,
                                              k_cache, v_cache, write_pos, b, s, hq, hkv, d,
                                              smax, st)
              : dispatch_rope_cache<float, 1>(kv_e4m3, q, k, v, cos, sin, bq, bk, bv, q_out,
                                              k_cache, v_cache, write_pos, b, s, hq, hkv, d,
                                              smax, st);
  return static_cast<int>(err);
}

// g, u, out: n elements each; kind 0 = SiLU, 1 = tanh-GELU.
int gated_act_launch(const void* g, const void* u, void* out, long long n, int kind, int dtype,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1)
    err = vector_fits<__nv_bfloat16>(n) ? launch_gated<__nv_bfloat16, 8>(g, u, out, n, kind, st)
                                          : launch_gated<__nv_bfloat16, 1>(g, u, out, n, kind, st);
  else
    err = vector_fits<float>(n) ? launch_gated<float, 4>(g, u, out, n, kind, st)
                                  : launch_gated<float, 1>(g, u, out, n, kind, st);
  return static_cast<int>(err);
}

}  // extern "C"
