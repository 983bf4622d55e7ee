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
// bytes of K and V.
//
// Two variants; the launcher picks one from (dtype, D) alone
// (`chunked_prefill_variant`), never because the other failed.
//
// * `chunked_prefill_mma_kernel`, bf16 at D = 64 or 128 (every dense config
//   of the port): flash attention 2 on the tensor cores. A block of 4 warps
//   holds 64 (query, head) rows of one KV head, row = i*G + g (G = 6: 10
//   queries and 4 pad rows); each warp owns 16 rows. Q is staged once in
//   shared memory; K/V tiles of 64 keys come through a 2-stage cp.async
//   ring (the next tile loads while this one is used), rows padded by 16
//   bytes so that ldmatrix reads fall in distinct banks. S = Q K^T and
//   O += P V are mma.sync.m16n8k16 (bf16 operands, f32 accumulation); the
//   online softmax runs in f32 on the accumulator registers, softcap before
//   the mask, and a masked key gets weight 0; P is rounded to bf16 for P V
//   (as the JAX model casts p to V's dtype). wgmma (64-row warpgroup tiles,
//   B from shared memory) and TMA are the next step.
// * `chunked_prefill_kernel`, f32 inputs and other head dims: CUDA-core f32
//   products (the f32 path is held at 1e-4, which bf16 tensor-core operands
//   could not meet). A block of 4 warps holds bq*G query rows in shared
//   memory (f32); each warp owns up to 16 of them and scores 32-key tiles,
//   lane c against key c.
//
// Both walk key tiles from the window floor up to the causal frontier
// min(Smax, start + q0 + nq) only (the TPU kernel's skipped KV blocks become
// the loop bounds). Ragged tails of Sq and Smax are masked, never asserted.
// A row with no valid key returns 0.
#include "attention_common.cuh"
#include "cp_async.cuh"
#include "mma_sync.cuh"

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

// ------------------------------------------------- tensor-core variant

constexpr int kMmaWarps = 4;
constexpr int kMmaRows = 16 * kMmaWarps;   // (query, head) rows of one block
constexpr int kMmaKeys = 64;               // keys per staged tile
constexpr int kMmaStages = 2;

using bf16 = __nv_bfloat16;
using rt::ldsm_x4;
using rt::ldsm_x4_trans;
using rt::mma_bf16;
using rt::pack_bf16;

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(rt::kFull, v, 1));
  return fmaxf(v, __shfl_xor_sync(rt::kFull, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(rt::kFull, v, 1);
  return v + __shfl_xor_sync(rt::kFull, v, 2);
}

// Shared-memory row stride in elements: 16 bytes of padding, so the eight
// rows one ldmatrix reads start in eight distinct 16-byte bank groups.
template <int D>
__host__ __device__ constexpr int mma_stride() { return D + 8; }

template <int D>
__host__ __device__ constexpr size_t mma_smem_bytes() {
  return sizeof(bf16) * (kMmaRows + 2 * kMmaStages * kMmaKeys) * mma_stride<D>();
}

// mma.sync register layout (lane = 4 * gid + tq): an accumulator tile
// (16 x 8) holds rows gid (c[0], c[1]) and gid + 8 (c[2], c[3]) at columns
// 2*tq, 2*tq + 1; the score tile of n-tiles 2k, 2k+1 is therefore, packed
// to bf16, the A operand of the P V step over keys 16k .. 16k + 15.
template <int D>
__global__ void __launch_bounds__(kMmaWarps * rt::kWarp)
chunked_prefill_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kc,
                           const bf16* __restrict__ vc, const int* __restrict__ starts,
                           bf16* __restrict__ out, int sq, int hq, int hkv, int smax, int g,
                           int bq, float scale, float softcap, int window) {
  constexpr int S = mma_stride<D>();
  constexpr int CH = D / 8;                   // 16-byte chunks per row
  constexpr int KD = D / 16;                  // k-steps over D
  constexpr int ND = D / 8;                   // 8-column output tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);            // kMmaRows x S
  bf16* ks = qs + kMmaRows * S;                            // stages x kMmaKeys x S
  bf16* vs = ks + kMmaStages * kMmaKeys * S;

  const int b = blockIdx.x / hkv, h = blockIdx.x % hkv;
  const int q0 = blockIdx.y * bq;
  const int nq = min(bq, sq - q0);
  const int rows = nq * g;
  const int tid = threadIdx.x, warp = tid / rt::kWarp, lane = tid % rt::kWarp;
  const int qpos0 = starts[b] + q0;
  const int hi = min(smax, qpos0 + nq);                      // causal frontier
  const int lo = window > 0 ? max(0, qpos0 - window + 1) : 0;
  const int kt0 = (lo / kMmaKeys) * kMmaKeys;
  const int ntiles = hi > kt0 ? (hi - kt0 + kMmaKeys - 1) / kMmaKeys : 0;

  for (int idx = tid; idx < kMmaRows * CH; idx += blockDim.x) {
    const int row = idx / CH, c = idx % CH;
    const bool in = row < rows;
    const int i = in ? row / g : 0, head = h * g + (in ? row % g : 0);
    rt::cp_async16(qs + row * S + c * 8,
               q + ((static_cast<size_t>(b) * sq + q0 + i) * hq + head) * D + c * 8, in);
  }
  rt::cp_async_commit();
  auto load_tile = [&](int stage, int kt) {
    bf16* kd = ks + stage * kMmaKeys * S;
    bf16* vd = vs + stage * kMmaKeys * S;
    for (int idx = tid; idx < kMmaKeys * CH; idx += blockDim.x) {
      const int row = idx / CH, c = idx % CH;
      const bool in = kt + row < smax;
      const size_t off =
          ((static_cast<size_t>(b) * smax + (in ? kt + row : 0)) * hkv + h) * D + c * 8;
      rt::cp_async16(kd + row * S + c * 8, kc + off, in);
      rt::cp_async16(vd + row * S + c * 8, vc + off, in);
    }
  };
  if (ntiles > 0) load_tile(0, kt0);
  rt::cp_async_commit();

  const int gid = lane >> 2, tq = lane & 3;
  const int wrow0 = warp * 16;
  const int rlo = wrow0 + gid, rhi = rlo + 8;                // this lane's two rows
  const bool oklo = rlo < rows, okhi = rhi < rows;
  const int qplo = qpos0 + rlo / g, qphi = qpos0 + rhi / g;
  const bool warp_live = wrow0 < rows;
  const int warp_qmax = qpos0 + (min(rows, wrow0 + 16) - 1) / g;
  const int warp_qmin = qpos0 + wrow0 / g;

  uint32_t qf[KD][4];
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float mlo = -INFINITY, mhi = -INFINITY, llo = 0.f, lhi = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int kt = kt0 + it * kMmaKeys;
    if (it + 1 < ntiles) load_tile((it + 1) & 1, kt + kMmaKeys);
    rt::cp_async_commit();
    rt::cp_async_wait<1>();                   // Q and this tile have landed
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        const int mi = lane / 8;
        ldsm_x4(qf[kk], qs + (wrow0 + (mi % 2) * 8 + lane % 8) * S + kk * 16 + (mi / 2) * 8);
      }
    }
    const bool skip = !warp_live || kt > warp_qmax ||
                      (window > 0 && kt + kMmaKeys <= warp_qmin - window + 1);
    if (!skip) {
      const bf16* kd = ks + (it & 1) * kMmaKeys * S;
      const bf16* vd = vs + (it & 1) * kMmaKeys * S;
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
        for (int np = 0; np < 4; ++np) {     // key n-tiles 2np, 2np + 1
          uint32_t kb[4];
          const int mi = lane / 8;
          ldsm_x4(kb, kd + (np * 16 + (mi / 2) * 8 + lane % 8) * S + kk * 16 + (mi % 2) * 8);
          mma_bf16(s[2 * np], qf[kk], kb[0], kb[1]);
          mma_bf16(s[2 * np + 1], qf[kk], kb[2], kb[3]);
        }
      }
      float xlo = -INFINITY, xhi = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = kt + 8 * j + 2 * tq + (e & 1);
          const bool upper = e >= 2;
          const int qpos = upper ? qphi : qplo;
          const bool ok = (upper ? okhi : oklo) && kpos < smax && kpos <= qpos &&
                          (window <= 0 || kpos > qpos - window);
          float x = s[j][e] * scale;
          if (softcap > 0.f) x = softcap * tanhf(x / softcap);
          x = ok ? x : -INFINITY;
          s[j][e] = x;
          if (upper) xhi = fmaxf(xhi, x); else xlo = fmaxf(xlo, x);
        }
      }
      const float nlo = fmaxf(mlo, quad_max(xlo)), nhi = fmaxf(mhi, quad_max(xhi));
      const float alo = nlo == -INFINITY ? 1.f : __expf(mlo - nlo);
      const float ahi = nhi == -INFINITY ? 1.f : __expf(mhi - nhi);
      float slo = 0.f, shi = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool upper = e >= 2;
          const float m = upper ? nhi : nlo;
          const float p = s[j][e] == -INFINITY ? 0.f : __expf(s[j][e] - m);
          s[j][e] = p;
          if (upper) shi += p; else slo += p;
        }
      }
      llo = llo * alo + quad_sum(slo);
      lhi = lhi * ahi + quad_sum(shi);
      mlo = nlo;
      mhi = nhi;
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        acc[j][0] *= alo; acc[j][1] *= alo;
        acc[j][2] *= ahi; acc[j][3] *= ahi;
      }
#pragma unroll
      for (int kk = 0; kk < kMmaKeys / 16; ++kk) {
        const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int np = 0; np < ND / 2; ++np) {  // output n-tiles 2np, 2np + 1
          uint32_t vb[4];
          const int mi = lane / 8;
          ldsm_x4_trans(vb, vd + (kk * 16 + (mi % 2) * 8 + lane % 8) * S + np * 16 + (mi / 2) * 8);
          mma_bf16(acc[2 * np], pa, vb[0], vb[1]);
          mma_bf16(acc[2 * np + 1], pa, vb[2], vb[3]);
        }
      }
    }
    __syncthreads();                          // this stage may be refilled
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? rhi : rlo;
    if (row >= rows) continue;
    const float inv = 1.f / fmaxf(half ? lhi : llo, 1e-30f);
    const int i = row / g, head = h * g + row % g;
    bf16* dst = out + ((static_cast<size_t>(b) * sq + q0 + i) * hq + head) * D + 2 * tq;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      rt::store2(dst + 8 * j, make_float2(acc[j][2 * half] * inv, acc[j][2 * half + 1] * inv));
  }
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const void* starts,
                       void* out, int b, int sq, int hq, int hkv, int smax, float softcap,
                       int window, cudaStream_t stream) {
  const int g = hq / hkv;
  const int bq = min(sq, kMmaRows / g);
  constexpr size_t smem = mma_smem_bytes<D>();
  auto kernel = chunked_prefill_mma_kernel<D>;
  cudaError_t err = rt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(b * hkv, (sq + bq - 1) / bq);
  kernel<<<grid, kMmaWarps * rt::kWarp, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(starts), static_cast<bf16*>(out), sq, hq, hkv, smax, g, bq,
      1.f / sqrtf(static_cast<float>(D)), softcap, window);
  return cudaGetLastError();
}

}  // namespace

// 1 when (dtype, d) goes to the tensor-core kernel, 0 for the CUDA-core one.
extern "C" int chunked_prefill_variant(int d, int dtype) {
  return dtype == 1 && (d == 64 || d == 128);
}

// dtype: 0 = f32, 1 = bf16. softcap <= 0 and window <= 0 mean none.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int chunked_prefill_launch(const void* q, const void* k, const void* v,
                                      const void* starts, void* out, int b, int sq, int hq,
                                      int hkv, int d, int smax, float softcap, int window,
                                      int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ncp = rt::col_pairs(d);
  cudaError_t err;
  if (chunked_prefill_variant(d, dtype)) {
    err = d == 64 ? launch_mma<64>(q, k, v, starts, out, b, sq, hq, hkv, smax, softcap, window, s)
                  : launch_mma<128>(q, k, v, starts, out, b, sq, hq, hkv, smax, softcap, window, s);
  } else if (dtype == 1) {
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
