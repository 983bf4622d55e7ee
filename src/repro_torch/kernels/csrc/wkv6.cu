// RWKV-6 WKV recurrence for Hopper (sm_90a).
//
// Replaces the TPU kernel `wkv6_chunked` in src/repro/kernels/wkv6.py (body
// `_kernel`), and on the model's path the jnp forms `wkv_chunked` /
// `wkv_scan` / `wkv_decode` of src/repro/models/rwkv6.py. Per (b, h):
//
//   out_t = r_t^T (S + diag(u) k_t v_t^T),   S <- diag(w_t) S + k_t v_t^T
//
// r, k, v (B, T, H, D) in bf16 or f32; w (B, T, H, D) f32 decay in (0, 1);
// u (H, D) f32; s0 (B, H, D, D) f32 [key][value]. Writes out (B, T, H, D)
// and sT (B, H, D, D), both f32 (the model normalises the f32 output).
// D = 64, the only head size of the model; any T >= 1.
//
// Bound on this card: the bytes (r, k, v, w read once, out written once,
// the state read and written once) at 3.35 TB/s for a prefill; the
// recurrence's 4*D*D f32 operations per (token, head) sit just below that.
//
// Design: one block per (b, h) holds the 64 x 64 f32 state in shared memory
// and walks T in chunks of C = 64 rows (the TPU kernel's sequential chunk
// grid axis becomes this loop). Each chunk stages r, k, v and log w in
// shared memory as f32, takes the inclusive cumulative sum of log w down
// each column, and computes the chunked-parallel form:
//   out   = (r * e^{cum_prev}) S  +  tril_{-1}(r_dec kj^T) v  +  diag(r.(u*k)) v
//   S'    = e^{total} * S  +  (k * e^{total - cum})^T v
// with r_dec = r * e^{cum_prev - ref} and kj = k * e^{ref - cum}, where ref
// is the cumulative decay at the chunk's midpoint row. Taken relative to
// ref, no exponent exceeds 32 * max|log w| (52.8 under the model's decay
// clip, e^52.8 < 1e23), so f32 neither overflows nor underflows on the
// pairs j < i that count; the masked pairs' scores (which may overflow) are
// dropped by a select, never multiplied. A ragged last chunk is
// the padding w = 1, r = k = v = 0, which contributes nothing, so every
// loop simply stops at the chunk's last real row (T = 1 decodes run the
// same code with one row). The four products are f32 on CUDA cores: each
// thread owns a 4 x 4 register tile (rows ti + 16a, columns tj + 16b), and
// shared-memory rows are padded to 65 floats so a tile's column reads fall
// in distinct banks. Tensor cores (wgmma) for the four products, and more
// than one block per head for short batches, are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kD = 64;                 // head size
constexpr int kC = 64;                 // chunk rows
constexpr int kStride = kD + 1;        // padded shared-memory row
constexpr int kTile = kC * kStride;    // one staged (C, D) tile, in floats
constexpr int kThreads = 256;          // 16 x 16 threads, 4 x 4 outputs each
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kC == kD && kC == 64, "the 4 x 4 thread tiles assume C = D = 64");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
            const float* __restrict__ w, const float* __restrict__ u,
            const float* __restrict__ s0, float* __restrict__ out, float* __restrict__ sT,
            int t_len, int heads) {
  extern __shared__ __align__(16) float smem[];
  float* S = smem;               // (D, D) state [key][value]
  float* rs = S + kTile;         // r, then r * e^{cum_prev}
  float* ks = rs + kTile;        // k, then k * e^{total - cum}
  float* vs = ks + kTile;        // v
  float* cum = vs + kTile;       // log w, its inclusive cumsum, then the C x C scores
  float* rd = cum + kTile;       // r * e^{cum_prev - ref}
  float* kj = rd + kTile;        // k * e^{ref - cum}
  float* diag = kj + kTile;      // (C,) r_c . (u * k_c)
  float* ref = diag + kC;        // (D,) cumulative decay at the midpoint row
  float* total = ref + kD;       // (D,) cumulative decay over the chunk

  const int tid = threadIdx.x;
  const int ti = tid / 16, tj = tid % 16;
  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const size_t step = static_cast<size_t>(heads) * kD;              // t -> t + 1
  const size_t base = (static_cast<size_t>(b) * t_len * heads + h) * kD;
  const size_t state = (static_cast<size_t>(b) * heads + h) * kD * kD;
  const float* uh = u + static_cast<size_t>(h) * kD;

  for (int idx = tid; idx < kD * kD; idx += kThreads)
    S[(idx / kD) * kStride + idx % kD] = s0[state + idx];

  for (int t0 = 0; t0 < t_len; t0 += kC) {
    const int cl = min(kC, t_len - t0);
    __syncthreads();               // the last chunk's readers of the tiles are done
    for (int idx = tid; idx < cl * kD; idx += kThreads) {
      const int c = idx / kD, d = idx % kD;
      const size_t g = base + static_cast<size_t>(t0 + c) * step + d;
      const int o = c * kStride + d;
      rs[o] = to_f32(r[g]);
      ks[o] = to_f32(k[g]);
      vs[o] = to_f32(v[g]);
      cum[o] = logf(fmaxf(w[g], 1e-38f));
    }
    __syncthreads();

    if (tid < kD) {                // warps 0-1: the cumulative sums, one column each
      float acc = 0.f;
      for (int c = 0; c < cl; ++c) {
        acc += cum[c * kStride + tid];
        cum[c * kStride + tid] = acc;
      }
      total[tid] = acc;
      ref[tid] = cum[((cl - 1) / 2) * kStride + tid];
    } else {                       // warps 2-7: the bonus term, one row per warp
      const int lane = tid % 32;
      for (int c = tid / 32 - 2; c < cl; c += kWarps - 2) {
        const int o = c * kStride;
        float p = rs[o + lane] * uh[lane] * ks[o + lane] +
                  rs[o + lane + 32] * uh[lane + 32] * ks[o + lane + 32];
        for (int m = 16; m > 0; m >>= 1) p += __shfl_xor_sync(kFull, p, m);
        if (lane == 0) diag[c] = p;
      }
    }
    __syncthreads();

    for (int idx = tid; idx < cl * kD; idx += kThreads) {
      const int c = idx / kD, d = idx % kD;
      const int o = c * kStride + d;
      const float prev = c > 0 ? cum[o - kStride] : 0.f;   // exclusive cumsum
      const float cu = cum[o], rv = rs[o], kv = ks[o];
      rd[o] = rv * expf(prev - ref[d]);
      rs[o] = rv * expf(prev);
      kj[o] = kv * expf(ref[d] - cu);
      ks[o] = kv * expf(total[d] - cu);
    }
    __syncthreads();

    // scores A[i][j] = rd_i . kj_j for j < i < cl, else 0 (into cum's space)
    float* att = cum;
    {
      float acc[4][4] = {};
      if (ti < cl) {
        for (int d = 0; d < kD; ++d) {
          float a[4], bb[4];
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            a[x] = rd[(ti + 16 * x) * kStride + d];
            bb[x] = kj[(tj + 16 * x) * kStride + d];
          }
#pragma unroll
          for (int x = 0; x < 4; ++x)
#pragma unroll
            for (int y = 0; y < 4; ++y) acc[x][y] += a[x] * bb[y];
        }
      }
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) {
          const int i = ti + 16 * x, j = tj + 16 * y;
          att[i * kStride + j] = (j < i && i < cl) ? acc[x][y] : 0.f;
        }
    }
    __syncthreads();

    // out[i][e] = rs_i . S[:, e] + sum_{j<i} A[i][j] v[j][e] + diag[i] v[i][e]
    if (ti < cl) {
      float acc[4][4] = {};
      for (int d = 0; d < kD; ++d) {
        float a[4], bb[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          a[x] = rs[(ti + 16 * x) * kStride + d];
          bb[x] = S[d * kStride + tj + 16 * x];
        }
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int y = 0; y < 4; ++y) acc[x][y] += a[x] * bb[y];
      }
      for (int j = 0; j < cl; ++j) {
        float a[4], bb[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          a[x] = att[(ti + 16 * x) * kStride + j];
          bb[x] = vs[j * kStride + tj + 16 * x];
        }
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int y = 0; y < 4; ++y) acc[x][y] += a[x] * bb[y];
      }
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int i = ti + 16 * x;
        if (i >= cl) continue;
        float* dst = out + base + static_cast<size_t>(t0 + i) * step;
#pragma unroll
        for (int y = 0; y < 4; ++y) {
          const int e = tj + 16 * y;
          dst[e] = acc[x][y] + diag[i] * vs[i * kStride + e];
        }
      }
    }
    __syncthreads();               // every reader of the old state is done

    // S[d][e] = e^{total[d]} S[d][e] + sum_c ks[c][d] v[c][e]
    {
      float acc[4][4];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float decay = expf(total[ti + 16 * x]);
#pragma unroll
        for (int y = 0; y < 4; ++y)
          acc[x][y] = decay * S[(ti + 16 * x) * kStride + tj + 16 * y];
      }
      for (int c = 0; c < cl; ++c) {
        float a[4], bb[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          a[x] = ks[c * kStride + ti + 16 * x];
          bb[x] = vs[c * kStride + tj + 16 * x];
        }
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int y = 0; y < 4; ++y) acc[x][y] += a[x] * bb[y];
      }
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) S[(ti + 16 * x) * kStride + tj + 16 * y] = acc[x][y];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < kD * kD; idx += kThreads)
    sT[state + idx] = S[(idx / kD) * kStride + idx % kD];
}

constexpr size_t kSmemBytes = sizeof(float) * (7 * kTile + kC + 2 * kD);

template <typename T>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w, const void* u,
                   const void* s0, void* out, void* sT, int b, int t, int h,
                   cudaStream_t stream) {
  auto kernel = wkv6_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  kernel<<<b * h, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(w), static_cast<const float*>(u),
      static_cast<const float*>(s0), static_cast<float*>(out), static_cast<float*>(sT), t, h);
  return cudaGetLastError();
}

}  // namespace

// dtype of r, k, v: 0 = f32, 1 = bf16. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int wkv6_launch(const void* r, const void* k, const void* v, const void* w,
                           const void* u, const void* s0, void* out, void* sT, int b, int t,
                           int h, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 1
      ? launch<__nv_bfloat16>(r, k, v, w, u, s0, out, sT, b, t, h, s)
      : launch<float>(r, k, v, w, u, s0, out, sT, b, t, h, s);
  return static_cast<int>(err);
}
