// Paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `paged_attention` in
// src/repro/kernels/paged_attention.py (body `_kernel`): one query token per
// request over a page pool (N, page_size, Hkv, D) reached through
// block_tables (B, P); lengths[b] counts the tokens including the new one.
// Pages from ceil(len/ps) on are never read, positions >= len are masked,
// optional softcap, GQA (G query heads per KV head).
//
// Bound on this card: the bytes of K and V for the valid tokens at
// 3.35 TB/s; the products (4*D*G FLOPs per token and KV head) are far
// below the operation bound.
//
// Design: one block per (b, kv-head). The G query rows go to shared memory
// in f32. The block's warps split the request's tokens into 32-key tiles
// (warp w takes tiles w, w + warps, ...), each staging its own tile through
// the block table and keeping its own online softmax (m, l, acc) in f32;
// the warps' partial states are merged in shared memory at the end (the
// split-K combine of flash decoding, inside one block). A warp that saw no
// valid key carries m = -inf and weighs 0 in the merge; length 0 returns 0.
// Splitting a request across blocks (for batches too small to fill the
// card's 132 SMs) is later work.
#include "attention_common.cuh"

namespace {

template <typename T, int NCP>
__global__ void __launch_bounds__(8 * rt::kWarp)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                       const T* __restrict__ vp, const int* __restrict__ tables,
                       const int* __restrict__ lengths, T* __restrict__ out, int hq, int hkv,
                       int d, int ps, int max_pages, float scale, float softcap) {
  constexpr int R = rt::Shape<NCP>::kRowsPerWarp;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warps = blockDim.x / rt::kWarp;
  const int warp = threadIdx.x / rt::kWarp, lane = threadIdx.x % rt::kWarp;
  const int b = blockIdx.x / hkv, h = blockIdx.x % hkv;
  const int g = hq / hkv;
  float* qs = reinterpret_cast<float*>(smem_raw);                  // R x d
  const int tile_elems = rt::kTileKeys * (rt::k_stride(d) + d);
  T* ks = reinterpret_cast<T*>(qs + R * d) + warp * tile_elems;    // per warp
  T* vs = ks + rt::kTileKeys * rt::k_stride(d);

  for (int idx = threadIdx.x; idx < R * d; idx += blockDim.x) {
    const int r = idx / d, col = idx % d;
    qs[idx] = r < g ? rt::to_f32(q[(static_cast<size_t>(b) * hq + h * g + r) * d + col]) : 0.f;
  }
  __syncthreads();

  const int len = min(lengths[b], max_pages * ps);
  const int* table = tables + static_cast<size_t>(b) * max_pages;
  const int chunks = d * static_cast<int>(sizeof(T)) / 16;
  rt::WarpState<R, NCP> st;
  st.init();
  for (int kt = warp * rt::kTileKeys; kt < len; kt += warps * rt::kTileKeys) {
    __syncwarp();
    for (int idx = lane; idx < rt::kTileKeys * chunks; idx += rt::kWarp) {
      const int row = idx / chunks, c = idx % chunks;
      const int pos = kt + row;
      const T* ksrc = nullptr;
      const T* vsrc = nullptr;
      if (pos < len) {
        const int page = max(table[pos / ps], 0);
        const size_t off = ((static_cast<size_t>(page) * ps + pos % ps) * hkv + h) * d;
        ksrc = kp + off;
        vsrc = vp + off;
      }
      rt::stage_chunk(ksrc, vsrc, ks + row * rt::k_stride(d), vs + row * d, c);
    }
    __syncwarp();
    const bool key_ok = kt + lane < len;
    st.tile(qs, ks, vs, d, scale, softcap, lane, [&](int r) { return r < g && key_ok; });
  }

  // merge the warps' partial states: m, l, then acc (reusing the tiles)
  __syncthreads();
  float* ms = qs + R * d;
  float* ls = ms + warps * R;
  float* accs = ls + warps * R;                                     // warps x R x d
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      ms[warp * R + r] = st.m[r];
      ls[warp * R + r] = st.l[r];
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int j = 0; j < NCP; ++j) {
      const int col = 2 * lane + 64 * j;
      if (col < d) {
        accs[(warp * R + r) * d + col] = st.acc[r][j].x;
        accs[(warp * R + r) * d + col + 1] = st.acc[r][j].y;
      }
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < g * d; idx += blockDim.x) {
    const int r = idx / d, col = idx % d;
    float m = -INFINITY;
    for (int w = 0; w < warps; ++w) m = fmaxf(m, ms[w * R + r]);
    float l = 0.f, a = 0.f;
    if (m != -INFINITY) {
      for (int w = 0; w < warps; ++w) {
        const float mw = ms[w * R + r];
        if (mw == -INFINITY) continue;
        const float f = __expf(mw - m);
        l += ls[w * R + r] * f;
        a += accs[(w * R + r) * d + col] * f;
      }
    }
    const float o = a / fmaxf(l, 1e-30f);
    T* dst = out + (static_cast<size_t>(b) * hq + h * g + r) * d + col;
    if constexpr (sizeof(T) == 2) *dst = __float2bfloat16_rn(o);
    else *dst = o;
  }
}

size_t tiles_bytes(int warps, int d, int esize) {
  return static_cast<size_t>(warps) * rt::kTileKeys * (rt::k_stride(d) + d) * esize;
}

template <typename T, int NCP>
cudaError_t launch(const void* q, const void* kp, const void* vp, const void* tables,
                   const void* lengths, void* out, int b, int hq, int hkv, int d, int ps,
                   int max_pages, float softcap, cudaStream_t stream) {
  constexpr int R = rt::Shape<NCP>::kRowsPerWarp;
  // as many warps (up to 8) as fit in 200 KB of shared memory
  int warps = 8;
  while (warps > 1 && tiles_bytes(warps, d, sizeof(T)) +
                          sizeof(float) * R * d > 200 * 1024)
    warps /= 2;
  const size_t merge = sizeof(float) * warps * R * (d + 2);
  const size_t smem = sizeof(float) * R * d +
                      (tiles_bytes(warps, d, sizeof(T)) > merge ? tiles_bytes(warps, d, sizeof(T))
                                                                 : merge);
  auto kernel = paged_attention_kernel<T, NCP>;
  cudaError_t err = rt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<b * hkv, warps * rt::kWarp, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp),
      static_cast<const int*>(tables), static_cast<const int*>(lengths), static_cast<T*>(out),
      hq, hkv, d, ps, max_pages, 1.f / sqrtf(static_cast<float>(d)), softcap);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = f32, 1 = bf16. softcap <= 0 means none.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int paged_attention_launch(const void* q, const void* kp, const void* vp,
                                      const void* tables, const void* lengths, void* out, int b,
                                      int hq, int hkv, int d, int ps, int max_pages,
                                      float softcap, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ncp = rt::col_pairs(d);
  cudaError_t err;
  if (dtype == 1) {
    if (ncp == 1) err = launch<__nv_bfloat16, 1>(q, kp, vp, tables, lengths, out, b, hq, hkv, d, ps, max_pages, softcap, s);
    else if (ncp == 2) err = launch<__nv_bfloat16, 2>(q, kp, vp, tables, lengths, out, b, hq, hkv, d, ps, max_pages, softcap, s);
    else err = launch<__nv_bfloat16, 4>(q, kp, vp, tables, lengths, out, b, hq, hkv, d, ps, max_pages, softcap, s);
  } else {
    if (ncp == 1) err = launch<float, 1>(q, kp, vp, tables, lengths, out, b, hq, hkv, d, ps, max_pages, softcap, s);
    else if (ncp == 2) err = launch<float, 2>(q, kp, vp, tables, lengths, out, b, hq, hkv, d, ps, max_pages, softcap, s);
    else err = launch<float, 4>(q, kp, vp, tables, lengths, out, b, hq, hkv, d, ps, max_pages, softcap, s);
  }
  return static_cast<int>(err);
}

// Query heads per KV head one block holds for head_dim d (the wrapper
// refuses G above it).
extern "C" int paged_attention_max_group(int d) { return rt::rows_per_warp(d); }
