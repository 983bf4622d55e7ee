// Chunked-prefill attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `chunked_prefill_attention` in
// src/repro/kernels/chunked_prefill.py (body `_kernel`): a chunk of Sq
// queries per request, query i at absolute position starts[b] + i, attends
// over a dense per-request cache (B, Smax, Hkv, D) that already holds the
// chunk's own K/V. A key counts when kpos <= qpos, and kpos > qpos - window
// when a window is set; optional softcap; GQA folded in.
//
// Bound on this card: at the executor's shapes (D = 128, G = 6 query heads
// per KV head, chunks of 32..1024 tokens) the work is 4*D*Hq FLOPs per
// (query, attended key) pair against 2*D bytes per key and head, so long
// chunks are bound by operations and short ones over a long prefix by the
// bytes of K and V. This first version does its products on the CUDA cores
// in f32 (no wgmma yet), so it sits far from the tensor-core bound.
//
// Design: grid (B*Hkv, ceil(Sq/bq)). A block of 4 warps holds bq*G query
// rows in shared memory (f32); each warp owns up to 16 of them. The block
// walks 32-key tiles from the window floor up to the causal frontier
// min(Smax, start + q0 + nq) only, staging each tile once in shared memory
// for all rows (the TPU kernel's skipped KV blocks become the loop bounds).
// Ragged tails of Sq and Smax are masked, never asserted. A row with no
// valid key returns 0.
#include "attention_common.cuh"

namespace {

constexpr int kWarps = 4;

template <typename T, int NCP>
__global__ void __launch_bounds__(kWarps * rt::kWarp)
chunked_prefill_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                       const T* __restrict__ vc, const int* __restrict__ starts,
                       T* __restrict__ out, int sq, int hq, int hkv, int d, int smax,
                       int g, int bq, float scale, float softcap, int window) {
  constexpr int R = rt::Shape<NCP>::kRowsPerWarp;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);                 // kWarps*R x d
  T* ks = reinterpret_cast<T*>(qs + kWarps * R * d);              // 32 x (d+2)
  T* vs = ks + rt::kTileKeys * rt::k_stride(d);                   // 32 x d

  const int b = blockIdx.x / hkv, h = blockIdx.x % hkv;
  const int q0 = blockIdx.y * bq;
  const int nq = min(bq, sq - q0);
  const int rows = nq * g;
  const int start = starts[b];
  const int warp = threadIdx.x / rt::kWarp, lane = threadIdx.x % rt::kWarp;

  for (int idx = threadIdx.x; idx < kWarps * R * d; idx += blockDim.x) {
    const int r = idx / d, col = idx % d;
    float x = 0.f;
    if (r < rows) {
      const int i = r / g, head = h * g + r % g;
      x = rt::to_f32(q[((static_cast<size_t>(b) * sq + q0 + i) * hq + head) * d + col]);
    }
    qs[idx] = x;
  }

  const int row0 = warp * R;
  const int qpos0 = start + q0;
  const int hi = min(smax, qpos0 + nq);                      // causal frontier
  const int lo = window > 0 ? max(0, qpos0 - window + 1) : 0;
  // the last query row this warp owns, for skipping tiles above it
  const int warp_last = min(rows, row0 + R) - 1;
  const int warp_qmax = warp_last >= 0 ? qpos0 + warp_last / g : -1;
  const int warp_qmin = qpos0 + row0 / g;

  rt::WarpState<R, NCP> st;
  st.init();
  const int chunks = d * static_cast<int>(sizeof(T)) / 16;
  for (int kt = (lo / rt::kTileKeys) * rt::kTileKeys; kt < hi; kt += rt::kTileKeys) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < rt::kTileKeys * chunks; idx += blockDim.x) {
      const int row = idx / chunks, c = idx % chunks;
      const int kpos = kt + row;
      const size_t off = ((static_cast<size_t>(b) * smax + kpos) * hkv + h) * d;
      const bool in = kpos < smax;
      rt::stage_chunk(in ? kc + off : nullptr, in ? vc + off : nullptr,
                      ks + row * rt::k_stride(d), vs + row * d, c);
    }
    __syncthreads();
    if (row0 >= rows || kt > warp_qmax) continue;
    if (window > 0 && kt + rt::kTileKeys <= warp_qmin - window + 1) continue;
    const int kpos = kt + lane;
    st.tile(qs + row0 * d, ks, vs, d, scale, softcap, lane, [&](int r) {
      const int rr = row0 + r;
      const int qpos = qpos0 + rr / g;
      return rr < rows && kpos < smax && kpos <= qpos &&
             (window <= 0 || kpos > qpos - window);
    });
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int rr = row0 + r;
    if (rr >= rows) break;
    const int i = rr / g, head = h * g + rr % g;
    const float inv = 1.f / fmaxf(st.l[r], 1e-30f);
    T* dst = out + ((static_cast<size_t>(b) * sq + q0 + i) * hq + head) * d;
#pragma unroll
    for (int j = 0; j < NCP; ++j) {
      const int col = 2 * lane + 64 * j;
      if (col < d)
        rt::store2(dst + col, make_float2(st.acc[r][j].x * inv, st.acc[r][j].y * inv));
    }
  }
}

template <typename T, int NCP>
cudaError_t launch(const void* q, const void* k, const void* v, const void* starts, void* out,
                   int b, int sq, int hq, int hkv, int d, int smax, float softcap, int window,
                   cudaStream_t stream) {
  constexpr int R = rt::Shape<NCP>::kRowsPerWarp;
  const int g = hq / hkv;
  const int bq = min(sq, (kWarps * R) / g);
  const size_t smem = sizeof(float) * kWarps * R * d +
                      sizeof(T) * rt::kTileKeys * (rt::k_stride(d) + d);
  auto kernel = chunked_prefill_kernel<T, NCP>;
  cudaError_t err = rt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(b * hkv, (sq + bq - 1) / bq);
  kernel<<<grid, kWarps * rt::kWarp, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(starts), static_cast<T*>(out), sq, hq, hkv, d, smax, g, bq,
      1.f / sqrtf(static_cast<float>(d)), softcap, window);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = f32, 1 = bf16. softcap <= 0 and window <= 0 mean none.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int chunked_prefill_launch(const void* q, const void* k, const void* v,
                                      const void* starts, void* out, int b, int sq, int hq,
                                      int hkv, int d, int smax, float softcap, int window,
                                      int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ncp = rt::col_pairs(d);
  cudaError_t err;
  if (dtype == 1) {
    if (ncp == 1) err = launch<__nv_bfloat16, 1>(q, k, v, starts, out, b, sq, hq, hkv, d, smax, softcap, window, s);
    else if (ncp == 2) err = launch<__nv_bfloat16, 2>(q, k, v, starts, out, b, sq, hq, hkv, d, smax, softcap, window, s);
    else err = launch<__nv_bfloat16, 4>(q, k, v, starts, out, b, sq, hq, hkv, d, smax, softcap, window, s);
  } else {
    if (ncp == 1) err = launch<float, 1>(q, k, v, starts, out, b, sq, hq, hkv, d, smax, softcap, window, s);
    else if (ncp == 2) err = launch<float, 2>(q, k, v, starts, out, b, sq, hq, hkv, d, smax, softcap, window, s);
    else err = launch<float, 4>(q, k, v, starts, out, b, sq, hq, hkv, d, smax, softcap, window, s);
  }
  return static_cast<int>(err);
}

// Query rows one block holds for head_dim d (the wrapper refuses G above it).
extern "C" int chunked_prefill_max_group(int d) { return kWarps * rt::rows_per_warp(d); }
