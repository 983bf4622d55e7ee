// Shared pieces of the two attention kernels (paged decode, chunked prefill).
//
// Both kernels hold one warp's query rows against a tile of 32 keys staged
// in shared memory: lane c scores key c for every row of the warp, the warp
// reduces max and sum across its lanes (the online softmax of flash
// attention, in f32), and each lane then accumulates its own column pairs of
// P.V. Types are bf16 or f32 in, f32 inside, the input type out.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace rt {

constexpr int kWarp = 32;
constexpr int kTileKeys = 32;          // keys per staged tile == lanes
constexpr unsigned kFull = 0xffffffffu;

// Column pairs a lane owns (ceil(D / 64)) and rows a warp owns, so that the
// accumulator stays at 64 f32 registers a lane.
template <int NCP>
struct Shape {
  static constexpr int kRowsPerWarp = NCP == 4 ? 8 : 16;
};

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Two consecutive elements (the address is even, so 4- or 8-byte aligned).
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __float22bfloat162_rn(v);
}

// Row and column of chunk t + j * THREADS of a tile of rows of CH 16-byte
// chunks: thread t's chunk in pass j of a copy over the tile. Where
// THREADS is a multiple of CH (D = 64, 128, 256) the thread keeps column
// t % CH and its row steps by THREADS / CH, written out so that the
// column is one register and each pass adds an immediate (computed from
// the index, the D = 256 decode kernel took 231 registers instead of 164
// and was 1.04-1.06x slower); at D = 80 (CH = 10, or 5 raw e4m3 chunks)
// both change from pass to pass.
template <int CH, int THREADS>
__device__ __forceinline__ int2 pass_chunk(int t, int j) {
  if constexpr (THREADS % CH == 0) {
    return make_int2(t / CH + j * (THREADS / CH), t % CH);
  } else {
    const int idx = t + j * THREADS;
    return make_int2(idx / CH, idx % CH);
  }
}

// ------------------------------------------------- fp8 (e4m3) K/V

using e4m3 = __nv_fp8_e4m3;

// Two e4m3 values (the low byte first) widened to f32: e4m3 -> f16 by
// cvt.rn.f16x2.e4m3x2 (sm_89 on), then f16 -> f32. Every e4m3 value,
// NaN aside, is exactly an f16, an f32 and a bf16 value, so the widening
// loses nothing, as the JAX model's cast of its cache to q's dtype.
__device__ __forceinline__ float2 e4m3x2_to_float2(uint32_t x) {
  uint32_t h;
  const uint16_t pair = static_cast<uint16_t>(x & 0xffffu);
  asm("cvt.rn.f16x2.e4m3x2 %0, %1;\n" : "=r"(h) : "h"(pair));
  return __half22float2(*reinterpret_cast<const __half2*>(&h));
}

__device__ __forceinline__ uint32_t e4m3x2_to_bf16x2(uint32_t x) {
  const __nv_bfloat162 b = __float22bfloat162_rn(e4m3x2_to_float2(x));
  return *reinterpret_cast<const uint32_t*>(&b);
}

// 16 bytes of T widened from the 16 / sizeof(T) e4m3 values at src (8
// bytes for bf16, 4 for f32; src aligned to that).
template <typename T>
__device__ __forceinline__ uint4 widen_e4m3(const e4m3* src);

template <>
__device__ __forceinline__ uint4 widen_e4m3<__nv_bfloat16>(const e4m3* src) {
  const uint2 x = *reinterpret_cast<const uint2*>(src);
  return make_uint4(e4m3x2_to_bf16x2(x.x), e4m3x2_to_bf16x2(x.x >> 16),
                    e4m3x2_to_bf16x2(x.y), e4m3x2_to_bf16x2(x.y >> 16));
}

template <>
__device__ __forceinline__ uint4 widen_e4m3<float>(const e4m3* src) {
  const uint32_t x = *reinterpret_cast<const uint32_t*>(src);
  const float2 a = e4m3x2_to_float2(x), b = e4m3x2_to_float2(x >> 16);
  return make_uint4(__float_as_uint(a.x), __float_as_uint(a.y), __float_as_uint(b.x),
                    __float_as_uint(b.y));
}

// The tensor-core kernels' e4m3 stage: ROWS rows of D e4m3 values that
// cp.async has landed in shared memory (row after row, unpadded) widened
// into bf16 rows of `stride` elements, the layout their ldmatrix reads.
// Thread t of THREADS widens 16-byte chunks t, t + THREADS, ..., chunk idx
// being column c = idx % CR of row idx / CR (CR = D / 16; at D = 64, 128
// and 256 THREADS is a multiple of CR and c stays put): one 16-byte load,
// 16 exact widenings, two 16-byte stores. The half at byte 16 goes first
// when c & 4, so that the eight stores of a quarter-warp fall in distinct
// banks. At D = 80 (CR = 5) a row is 11 16-byte units, so some eight
// consecutive chunks cover one bank group three times and no order avoids
// a conflict; there the half at byte 16 goes first when (row + c) & 4:
// every 40 chunks then take 14 store wavefronts (10 without conflicts, 18
// in order, 19 under c & 4), the fewest any choice of halves allows.
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void widen_rows_e4m3(const e4m3* src, __nv_bfloat16* dst,
                                                int stride, int t) {
  constexpr int CR = D / 16;
  static_assert(ROWS * CR % THREADS == 0, "whole passes");
#pragma unroll
  for (int j = 0; j < ROWS * CR / THREADS; ++j) {
    const int idx = t + j * THREADS;
    const int2 rc = pass_chunk<CR, THREADS>(t, j);
    const int row = rc.x, c = rc.y;
    const bool swap = (((CR % 2 != 0) ? row + c : c) & 4) != 0;
    const uint4 x = reinterpret_cast<const uint4*>(src)[idx];
    const uint32_t a0 = swap ? x.z : x.x, a1 = swap ? x.w : x.y;
    const uint32_t b0 = swap ? x.x : x.z, b1 = swap ? x.y : x.w;
    uint4* out = reinterpret_cast<uint4*>(dst + row * stride + c * 16);
    out[swap ? 1 : 0] = make_uint4(e4m3x2_to_bf16x2(a0), e4m3x2_to_bf16x2(a0 >> 16),
                                   e4m3x2_to_bf16x2(a1), e4m3x2_to_bf16x2(a1 >> 16));
    out[swap ? 0 : 1] = make_uint4(e4m3x2_to_bf16x2(b0), e4m3x2_to_bf16x2(b0 >> 16),
                                   e4m3x2_to_bf16x2(b1), e4m3x2_to_bf16x2(b1 >> 16));
  }
}

// One 16-byte chunk of T of a staged K or V row: chunk `chunk` of src when
// K/V share T, else the same elements widened from e4m3.
template <typename T, typename KV>
__device__ __forceinline__ uint4 load_chunk(const KV* src, int chunk) {
  if constexpr (std::is_same_v<KV, T>) {
    return reinterpret_cast<const uint4*>(src)[chunk];
  } else {
    static_assert(std::is_same_v<KV, e4m3>, "K/V are T or e4m3");
    return widen_e4m3<T>(src + chunk * (16 / static_cast<int>(sizeof(T))));
  }
}

// Row stride of the staged K tile, in elements: two elements of padding
// make lane c's reads of row c fall in distinct banks.
__host__ __device__ __forceinline__ int k_stride(int d) { return d + 2; }

// Copy chunk `chunk` (16 bytes of T) of one D-element row (src 16-byte
// aligned, or an e4m3 row widened to T) into the padded K tile and the
// unpadded V tile, or zeros when src is null.
template <typename T, typename KV>
__device__ __forceinline__ void stage_chunk(const KV* ksrc, const KV* vsrc, T* kdst,
                                            T* vdst, int chunk) {
  uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
  if (ksrc != nullptr) {
    kv = load_chunk<T>(ksrc, chunk);
    vv = load_chunk<T>(vsrc, chunk);
  }
  uint32_t* kw = reinterpret_cast<uint32_t*>(kdst) + chunk * 4;
  kw[0] = kv.x; kw[1] = kv.y; kw[2] = kv.z; kw[3] = kv.w;
  reinterpret_cast<uint4*>(vdst)[chunk] = vv;
}

// Per-warp online-softmax state for up to R rows; lane-replicated m and l,
// column pairs 2*lane + 64*j of the accumulator.
template <int R, int NCP>
struct WarpState {
  float m[R], l[R];
  float2 acc[R][NCP];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      m[r] = -INFINITY;
      l[r] = 0.f;
#pragma unroll
      for (int j = 0; j < NCP; ++j) acc[r][j] = make_float2(0.f, 0.f);
    }
  }

  // One tile: ``qs`` holds this warp's R query rows (f32, row stride d),
  // ``ks``/``vs`` the 32 staged keys. ``valid(r)`` says whether this lane's
  // key counts for row r. Masked keys get weight 0 (never exp(-1e30 - m)).
  template <typename T, typename Valid>
  __device__ __forceinline__ void tile(const float* qs, const T* ks, const T* vs, int d,
                                       float scale, float softcap, int lane, Valid valid) {
    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = 0.f;
    const T* krow = ks + lane * k_stride(d);
    for (int dd = 0; dd < d; dd += 4) {
      const float2 k01 = load2(krow + dd);
      const float2 k23 = load2(krow + dd + 2);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(qs + r * d + dd);
        s[r] += qv.x * k01.x + qv.y * k01.y + qv.z * k23.x + qv.w * k23.y;
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float x = s[r] * scale;
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      const bool ok = valid(r);
      x = ok ? x : -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(x));
      float alpha = 1.f, p = 0.f;
      if (m_new != -INFINITY) {
        alpha = __expf(m[r] - m_new);
        p = ok ? __expf(x - m_new) : 0.f;
      }
      l[r] = l[r] * alpha + warp_sum(p);
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < NCP; ++j) {
        acc[r][j].x *= alpha;
        acc[r][j].y *= alpha;
      }
      s[r] = p;
    }
    for (int c = 0; c < kTileKeys; ++c) {
      float2 v[NCP];
#pragma unroll
      for (int j = 0; j < NCP; ++j) {
        const int col = 2 * lane + 64 * j;
        v[j] = col < d ? load2(vs + c * d + col) : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float pc = __shfl_sync(kFull, s[r], c);
#pragma unroll
        for (int j = 0; j < NCP; ++j) {
          acc[r][j].x += pc * v[j].x;
          acc[r][j].y += pc * v[j].y;
        }
      }
    }
  }
};

inline int col_pairs(int d) { return d <= 64 ? 1 : (d <= 128 ? 2 : 4); }

inline int rows_per_warp(int d) { return col_pairs(d) == 4 ? 8 : 16; }

template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// SMs of the current device, read once per device (the launchers size
// their grids by it on every call).
inline int card_sms() {
  constexpr int kDevices = 64;
  static int cached[kDevices] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 0 && dev < kDevices && cached[dev] > 0) return cached[dev];
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  sms = sms > 0 ? sms : 1;
  if (dev >= 0 && dev < kDevices) cached[dev] = sms;
  return sms;
}

}  // namespace rt
