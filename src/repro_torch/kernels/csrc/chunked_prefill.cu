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
// per KV head, D = 256, G = 2, or zamba2's D = 80, G = 1; chunks of
// 32..1024 tokens) the work is 4*D*Hq FLOPs per (query, attended key) pair
// against 2*D bytes per key and head, so long chunks are bound by
// operations and short ones over a long prefix (and zamba2's 256-token
// chunks, one query head a KV head) by the bytes of K and V.
//
// Two variants; the launcher picks one from (dtype, D) alone
// (`chunked_prefill_variant`), never because the other failed.
//
// * `chunked_prefill_mma_kernel`, bf16 at D = 64, 80, 128 or 256 (every
//   config of the port): flash attention 2 on the tensor cores. A block of 4
//   warps holds 64 (query, head) rows of one KV head, row = i*G + g (G = 6:
//   10 queries and 4 pad rows; gemma2's G = 2: 32 queries; zamba2's G = 1 at
//   D = 80: 64); each warp owns 16 rows. Q is staged once in shared
//   memory; K/V tiles come through a 2-stage cp.async ring (the next tile
//   loads while this one is used), rows padded by 16 bytes so that ldmatrix
//   reads fall in distinct banks (at D = 80 a row is 176 B, 11 16-byte
//   units: the eight rows of an ldmatrix still start in distinct groups).
//   S = Q K^T and O += P V are mma.sync.m16n8k16 (bf16 operands, f32
//   accumulation); the online softmax runs in f32 on the accumulator
//   registers, softcap before the mask, and a masked key gets weight 0; P
//   is rounded to bf16 for P V (as the JAX model casts p to V's dtype).
//   What D = 256 changes (32-key tiles, Q read from shared memory, key
//   tiles split across a cluster whose blocks merge their (m, l, O)
//   partials through distributed shared memory, as the decode kernel does)
//   is set out at `MmaPlan`. D = 80 = 5 x 16 is tiled by m16n8k16 exactly
//   (5 k-steps, 10 output n-tiles, no padded columns). wgmma (64-row
//   warpgroup tiles, B from shared memory) and TMA are the next step.
// * `chunked_prefill_kernel`, f32 inputs and other head dims (bf16 at
//   D = 96, say, which no config of the port has): CUDA-core f32
//   products (the f32 path is held at 1e-4, which bf16 tensor-core operands
//   could not meet). A block of 4 warps holds bq*G query rows in shared
//   memory (f32); each warp owns up to 16 of them and scores 32-key tiles,
//   lane c against key c.
//
// K/V may be fp8 e4m3 (an fp8 KV cache) with q in bf16 or f32; the variant
// still follows q's dtype, and the products stay bf16 (or f32) ones: the
// JAX model widens its e4m3 cache to q's dtype before attention, so fp8
// tensor-core products (which would round Q and P to fp8) are not used.
// * The tensor-core kernel brings the e4m3 bytes in by cp.async, as the
//   bf16 path brings its tiles: a 2-stage ring of raw tiles (K x D bytes
//   for K and for V, rows unpadded, half a bf16 tile's bytes; one 16-byte
//   copy carries 16 values; rows past smax zero-filled, and byte 0 is +0 in
//   e4m3). Once a raw tile has landed the block widens it in shared memory
//   (e4m3 -> f16 -> f32 -> bf16 by cvt.rn.f16x2.e4m3x2, exact; 16 values a
//   thread a pass) into one bf16 K/V tile pair laid out as the bf16 ring's
//   stages (`mma_stride`), between two barriers, while the next raw tile's
//   copies are in flight; fragments, softmax, merge and output are the bf16
//   path's. Shared memory at D = 256: Q 33,792 B, the widened pair 33,792,
//   the raw ring 32,768 (100,352 in all; bf16 101,376), so two blocks an SM
//   and the same split counts. A third raw stage fits at D <= 128 but made
//   it slower (PERF.md §6). Raw rows are unpadded: the widening reads them
//   in order, and 16 bytes of padding would put two rows of one read phase
//   on the same banks at D = 64.
// * The CUDA-core kernel widens each e4m3 tile to q's type as it stages it,
//   loaded and stored by the threads (off the serving path: f32 q).
//
// Both walk key tiles from the window floor up to the causal frontier
// min(Smax, start + q0 + nq) only (the TPU kernel's skipped KV blocks become
// the loop bounds). Ragged tails of Sq and Smax are masked, never asserted.
// A row with no valid key returns 0.
#include <cooperative_groups.h>

#include "attention_common.cuh"
#include "cp_async.cuh"
#include "mma_sync.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;

template <typename T, typename KV, int NCP>
__global__ void __launch_bounds__(kWarps * rt::kWarp)
chunked_prefill_kernel(const T* __restrict__ q, const KV* __restrict__ kc,
                       const KV* __restrict__ vc, const int* __restrict__ starts,
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

template <typename T, typename KV, int NCP>
cudaError_t launch(const void* q, const void* k, const void* v, const void* starts, void* out,
                   int b, int sq, int hq, int hkv, int d, int smax, float softcap, int window,
                   cudaStream_t stream) {
  constexpr int R = rt::Shape<NCP>::kRowsPerWarp;
  const int g = hq / hkv;
  const int bq = min(sq, (kWarps * R) / g);
  const size_t smem = sizeof(float) * kWarps * R * d +
                      sizeof(T) * rt::kTileKeys * (rt::k_stride(d) + d);
  auto kernel = chunked_prefill_kernel<T, KV, NCP>;
  cudaError_t err = rt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(b * hkv, (sq + bq - 1) / bq);
  kernel<<<grid, kWarps * rt::kWarp, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k), static_cast<const KV*>(v),
      static_cast<const int*>(starts), static_cast<T*>(out), sq, hq, hkv, d, smax, g, bq,
      1.f / sqrtf(static_cast<float>(d)), softcap, window);
  return cudaGetLastError();
}

// ------------------------------------------------- tensor-core variant

constexpr int kMmaWarps = 4;
constexpr int kMmaRows = 16 * kMmaWarps;   // (query, head) rows of one block
constexpr int kMmaStages = 2;
constexpr int kMaxSplits = 4;              // blocks of a cluster, at most
constexpr int kMinSplitTiles = 4;          // key tiles a split walks at least

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

// What the head dim changes. D = 64/80/128: 64-key tiles, Q's A fragments
// in registers, one block per q-block. At D = 256 ("wide") the O
// accumulator alone is 128 f32 registers a thread, so:
// * tiles of 32 keys (16 score registers; Q and the ring take 101,376 B,
//   two blocks an SM), Q's fragments read from shared memory at each
//   k-step (64 registers fewer);
// * the blocks of a cluster split each q-block's key tiles: its grids are
//   small (Hkv = 4, 32 queries a block) and its walks long (a 4096-key
//   window);
// * a tile inside every row's causal range and window skips the mask, and
//   each thread copies its rows from one precomputed address. At D = 128
//   the first, beside the softcap below, made the kernel 1.08-1.10x
//   slower, and the second 1.04x (PERF.md §6), so D = 64/80/128 keep the
//   masked tile and the strided copy.
// At every D a tile costs about as many CUDA-core instructions as
// tensor-core ones, so a tile that raises no row's max skips the
// accumulator's rescale and the softcap takes two MUFU operations
// (`rt::soft_cap_fast`).
template <int D>
struct MmaPlan {
  static constexpr bool kWide = D > 128;
  static constexpr int kKeys = kWide ? 32 : 64;
};

// Shared-memory row stride in elements: 16 bytes of padding, so the eight
// rows one ldmatrix reads start in eight distinct 16-byte bank groups.
template <int D>
__host__ __device__ constexpr int mma_stride() { return D + 8; }

// Stages of the e4m3 ring of raw tiles (a third, which fits at D <= 128,
// made the qwen2 shape 1.06x slower on an NVIDIA H100 80GB HBM3 at 700 W;
// PERF.md §6).
constexpr int kRawStages = 2;

// Q, then bf16: the 2-stage ring of K/V tiles; e4m3: one widened K/V tile
// pair and the ring of raw e4m3 tiles (K x D bytes each, unpadded).
template <int D, typename KV>
__host__ __device__ constexpr size_t mma_smem_bytes() {
  if constexpr (std::is_same_v<KV, bf16>) {
    return sizeof(bf16) * (kMmaRows + 2 * kMmaStages * MmaPlan<D>::kKeys) * mma_stride<D>();
  } else {
    return sizeof(bf16) * (kMmaRows + 2 * MmaPlan<D>::kKeys) * mma_stride<D>() +
           kRawStages * 2 * MmaPlan<D>::kKeys * D;
  }
}
// chunked_prefill_splits counts on two blocks an SM at D = 256 (228 KB an
// SM, 1 KB of it reserved for each block), whatever the K/V type
static_assert(2 * (mma_smem_bytes<256, bf16>() + 1024) <= 228 * 1024, "one block an SM");
static_assert(2 * (mma_smem_bytes<256, rt::e4m3>() + 1024) <= 228 * 1024, "one block an SM");

// What a block receives from the splits of its cluster, over Q and the ring
// once every split is done with them: (m, l) of each split's 64 rows, and
// each split's accumulator columns [o * chunk, (o + 1) * chunk) of them in
// block o (rows padded by 8 floats, so that the 8 rows of a warp's float2
// stores start in distinct banks).
__host__ __device__ constexpr int recv_stride(int d, int splits) { return d / splits + 8; }

template <int D>
__host__ __device__ constexpr size_t recv_bytes(int splits) {
  return sizeof(float2) * kMaxSplits * kMmaRows +
         sizeof(float) * splits * kMmaRows * recv_stride(D, splits);
}
static_assert(recv_bytes<256>(kMaxSplits) <= mma_smem_bytes<256, bf16>() &&
                  recv_bytes<256>(kMaxSplits) <= mma_smem_bytes<256, rt::e4m3>(),
              "recv > Q + ring");

// mma.sync register layout (lane = 4 * gid + tq): an accumulator tile
// (16 x 8) holds rows gid (c[0], c[1]) and gid + 8 (c[2], c[3]) at columns
// 2*tq, 2*tq + 1; the score tile of n-tiles 2k, 2k+1 is therefore, packed
// to bf16, the A operand of the P V step over keys 16k .. 16k + 15.
//
// Grid (B * Hkv * splits, ceil(Sq / bq)), clusters of `splits` blocks along
// x: the blocks of a cluster share one (b, kv-head, q-block) and split its
// key tiles into `splits` runs; with splits > 1 they merge their partials
// through distributed shared memory.
template <int D, typename KV>
__global__ void __launch_bounds__(kMmaWarps * rt::kWarp)
chunked_prefill_mma_kernel(const bf16* __restrict__ q, const KV* __restrict__ kc,
                           const KV* __restrict__ vc, const int* __restrict__ starts,
                           bf16* __restrict__ out, int sq, int hq, int hkv, int smax, int g,
                           int bq, int splits, float scale, float softcap, int window) {
  constexpr bool W = MmaPlan<D>::kWide;
  constexpr bool E = std::is_same_v<KV, rt::e4m3>;
  constexpr int K = MmaPlan<D>::kKeys;
  constexpr int S = mma_stride<D>();
  constexpr int CH = D / 8;                   // 16-byte chunks per row
  constexpr int KD = D / 16;                  // k-steps over D
  constexpr int ND = D / 8;                   // 8-column output tiles
  constexpr int NS = K / 8;                   // 8-key score tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);            // kMmaRows x S
  bf16* ks = qs + kMmaRows * S;                            // (stages x) K x S
  bf16* vs = ks + (E ? 1 : kMmaStages) * K * S;
  // e4m3: stages x (K, V) x K x D bytes
  rt::e4m3* raw = reinterpret_cast<rt::e4m3*>(vs + K * S);

  const int nsplit = W ? splits : 1;
  const int split = W ? blockIdx.x % nsplit : 0;
  const unsigned pair = W ? blockIdx.x / nsplit : blockIdx.x;
  const int b = pair / hkv, h = pair % hkv;
  const int q0 = blockIdx.y * bq;
  const int nq = min(bq, sq - q0);
  const int rows = nq * g;
  const int tid = threadIdx.x, warp = tid / rt::kWarp, lane = tid % rt::kWarp;
  const int qpos0 = starts[b] + q0;
  const int hi = min(smax, qpos0 + nq);                      // causal frontier
  const int lo = window > 0 ? max(0, qpos0 - window + 1) : 0;
  int kt0 = (lo / K) * K;
  int ntiles = hi > kt0 ? (hi - kt0 + K - 1) / K : 0;       // the q-block's tiles
  if constexpr (W) {                                         // this split's run of them
    const int per = (ntiles + nsplit - 1) / nsplit;
    const int first = min(ntiles, split * per);
    kt0 += first * K;
    ntiles = min(ntiles, first + per) - first;
  }

  for (int idx = tid; idx < kMmaRows * CH; idx += blockDim.x) {
    const int row = idx / CH, c = idx % CH;
    const bool in = row < rows;
    const int i = in ? row / g : 0, head = h * g + (in ? row % g : 0);
    rt::cp_async16(qs + row * S + c * 8,
               q + ((static_cast<size_t>(b) * sq + q0 + i) * hq + head) * D + c * 8, in);
  }
  rt::cp_async_commit();
  // wide: thread t copies chunk t % CH of rows t / CH, + RP, ...
  constexpr int RP = kMmaWarps * rt::kWarp / CH;
  const size_t kv_row = static_cast<size_t>(hkv) * D;
  const size_t kv_base = (static_cast<size_t>(b) * smax * hkv + h) * D + (tid % CH) * 8;
  auto load_tile = [&](int stage, int kt) {
    bf16* kd = ks + stage * K * S;
    bf16* vd = vs + stage * K * S;
    if constexpr (W) {
#pragma unroll
      for (int j = 0; j < K / RP; ++j) {
        const int row = tid / CH + j * RP;
        const bool in = kt + row < smax;
        const size_t off = kv_base + (in ? kt + row : 0) * kv_row;
        rt::cp_async16(kd + row * S + (tid % CH) * 8, kc + off, in);
        rt::cp_async16(vd + row * S + (tid % CH) * 8, vc + off, in);
      }
    } else {
      for (int idx = tid; idx < K * CH; idx += blockDim.x) {
        const int row = idx / CH, c = idx % CH;
        const bool in = kt + row < smax;
        const size_t off =
            ((static_cast<size_t>(b) * smax + (in ? kt + row : 0)) * hkv + h) * D + c * 8;
        rt::cp_async16(kd + row * S + c * 8, kc + off, in);
        rt::cp_async16(vd + row * S + c * 8, vc + off, in);
      }
    }
  };
  // e4m3: thread t copies 16-byte chunks (16 values) t, t + 128, ... of a
  // raw tile's K * CR, chunk idx being column idx % CR of row idx / CR (at
  // byte 16 * idx: raw rows are unpadded), zeros past smax; at D = 80 (CR =
  // 5) the 320 chunks take 2.5 passes, so the last is guarded
  constexpr int CR = D / 16;
  constexpr int THREADS = kMmaWarps * rt::kWarp;
  const size_t raw_base = (static_cast<size_t>(b) * smax * hkv + h) * D;
  auto load_raw = [&](int stage, int kt) {
    rt::e4m3* kd = raw + stage * 2 * K * D;
    rt::e4m3* vd = kd + K * D;
#pragma unroll
    for (int j = 0; j < (K * CR + THREADS - 1) / THREADS; ++j) {
      const int idx = tid + j * THREADS;
      if (K * CR % THREADS != 0 && idx >= K * CR) break;
      const int2 rc = rt::pass_chunk<CR, THREADS>(tid, j);
      const int row = rc.x, c = rc.y;
      const bool in = kt + row < smax;
      const size_t off = raw_base + c * 16 + (in ? kt + row : 0) * kv_row;
      rt::cp_async16(kd + idx * 16, kc + off, in);
      rt::cp_async16(vd + idx * 16, vc + off, in);
    }
  };
  if constexpr (E) {
#pragma unroll
    for (int i = 0; i + 1 < kRawStages; ++i) {
      if (i < ntiles) load_raw(i, kt0 + i * K);
      rt::cp_async_commit();
    }
  } else {
    if (ntiles > 0) load_tile(0, kt0);
    rt::cp_async_commit();
  }

  const int gid = lane >> 2, tq = lane & 3;
  const int wrow0 = warp * 16;
  const int rlo = wrow0 + gid, rhi = rlo + 8;                // this lane's two rows
  const bool oklo = rlo < rows, okhi = rhi < rows;
  const int qplo = qpos0 + rlo / g, qphi = qpos0 + rhi / g;
  const bool warp_live = wrow0 < rows;
  const int warp_qmax = qpos0 + (min(rows, wrow0 + 16) - 1) / g;
  const int warp_qmin = qpos0 + wrow0 / g;
  // this lane's ldmatrix address in the Q tile (A operand) at k-step kk
  auto q_frag = [&](int kk) {
    const int mi = lane / 8;
    return qs + (wrow0 + (mi % 2) * 8 + lane % 8) * S + kk * 16 + (mi / 2) * 8;
  };
  const float c2 = softcap > 0.f ? 2.f / softcap : 0.f;
  auto logit = [&](float v) {                 // scale, then the softcap
    return softcap > 0.f ? rt::soft_cap_fast(v * scale, softcap, c2) : v * scale;
  };

  uint32_t qf[W ? 1 : KD][4];
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float mlo = -INFINITY, mhi = -INFINITY, llo = 0.f, lhi = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int kt = kt0 + it * K;
    if constexpr (E) {
      // the raw tile kRawStages - 1 ahead is copied while this one is
      // widened and used; the widening overwrites the pair the previous
      // tile's products read, which the barrier below has waited out
      if (it + kRawStages - 1 < ntiles)
        load_raw((it + kRawStages - 1) % kRawStages, kt + (kRawStages - 1) * K);
      rt::cp_async_commit();
      rt::cp_async_wait<kRawStages - 1>();    // Q and this raw tile have landed
      __syncthreads();
      rt::widen_rows_e4m3<D, 2 * K, kMmaWarps * rt::kWarp>(
          raw + (it % kRawStages) * 2 * K * D, ks, S, tid);
      __syncthreads();
    } else {
      if (it + 1 < ntiles) load_tile((it + 1) & 1, kt + K);
      rt::cp_async_commit();
      rt::cp_async_wait<1>();                 // Q and this tile have landed
      __syncthreads();
    }
    if constexpr (!W) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) ldsm_x4(qf[kk], q_frag(kk));
      }
    }
    const bool skip = !warp_live || kt > warp_qmax ||
                      (window > 0 && kt + K <= warp_qmin - window + 1);
    if (!skip) {
      const bf16* kd = E ? ks : ks + (it & 1) * K * S;
      const bf16* vd = E ? vs : vs + (it & 1) * K * S;
      float s[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t qa[4];
        if constexpr (W) {
          ldsm_x4(qa, q_frag(kk));
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) qa[e] = qf[kk][e];
        }
#pragma unroll
        for (int np = 0; np < K / 16; ++np) {  // key n-tiles 2np, 2np + 1
          uint32_t kb[4];
          const int mi = lane / 8;
          ldsm_x4(kb, kd + (np * 16 + (mi / 2) * 8 + lane % 8) * S + kk * 16 + (mi % 2) * 8);
          mma_bf16(s[2 * np], qa, kb[0], kb[1]);
          mma_bf16(s[2 * np + 1], qa, kb[2], kb[3]);
        }
      }
      float xlo = -INFINITY, xhi = -INFINITY;
      // every key of the tile counts for every row of the warp
      const bool interior = W && wrow0 + 16 <= rows && kt + K <= min(smax, warp_qmin + 1) &&
                            (window <= 0 || kt > warp_qmax - window);
      if (interior) {
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          s[j][0] = logit(s[j][0]);
          s[j][1] = logit(s[j][1]);
          s[j][2] = logit(s[j][2]);
          s[j][3] = logit(s[j][3]);
          xlo = fmaxf(xlo, fmaxf(s[j][0], s[j][1]));
          xhi = fmaxf(xhi, fmaxf(s[j][2], s[j][3]));
        }
      } else {
#pragma unroll
        for (int j = 0; j < NS; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kpos = kt + 8 * j + 2 * tq + (e & 1);
            const bool upper = e >= 2;
            const int qpos = upper ? qphi : qplo;
            const bool ok = (upper ? okhi : oklo) && kpos < smax && kpos <= qpos &&
                            (window <= 0 || kpos > qpos - window);
            float x = logit(s[j][e]);
            x = ok ? x : -INFINITY;
            s[j][e] = x;
            if (upper) xhi = fmaxf(xhi, x); else xlo = fmaxf(xlo, x);
          }
        }
      }
      const float nlo = fmaxf(mlo, quad_max(xlo)), nhi = fmaxf(mhi, quad_max(xhi));
      const float alo = nlo == -INFINITY ? 1.f : __expf(mlo - nlo);
      const float ahi = nhi == -INFINITY ? 1.f : __expf(mhi - nhi);
      float slo = 0.f, shi = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
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
      if (__any_sync(rt::kFull, alo != 1.f || ahi != 1.f)) {
#pragma unroll
        for (int j = 0; j < ND; ++j) {
          acc[j][0] *= alo; acc[j][1] *= alo;
          acc[j][2] *= ahi; acc[j][3] *= ahi;
        }
      }
#pragma unroll
      for (int kk = 0; kk < K / 16; ++kk) {
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
    // this stage may be refilled (e4m3: the next iteration's first barrier
    // keeps the widened pair until every warp is done with it)
    if constexpr (!E) __syncthreads();
  }

  if (nsplit == 1) {
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
    return;
  }

  if constexpr (W) {
    // Merge the splits. Every block of the cluster is done with Q and its
    // ring before any partial lands over them (first barrier); each block
    // stores its rows' (m, l) into every block and each accumulator column
    // into the block that owns it (stores, which do not wait for a reply);
    // after the second barrier each block weighs each split's rows once
    // (e^{m_p - m} / l, 0 for a split that saw no key) and merges its
    // columns in f32, four at a time.
    rt::cp_async_wait<0>();
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const int chunk = D / nsplit, rs = recv_stride(D, nsplit);
    float2* rml = reinterpret_cast<float2*>(smem_raw);                   // splits x kMmaRows
    float* racc = reinterpret_cast<float*>(rml + kMaxSplits * kMmaRows);  // splits x kMmaRows x rs
    if (tq == 0) {
      for (int o = 0; o < nsplit; ++o) {
        *cluster.map_shared_rank(rml + split * kMmaRows + rlo, o) = make_float2(mlo, llo);
        *cluster.map_shared_rank(rml + split * kMmaRows + rhi, o) = make_float2(mhi, lhi);
      }
    }
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int col = 8 * j + 2 * tq, o = col / chunk;
      float* dst = racc + (split * kMmaRows + rlo) * rs + col - o * chunk;
      *reinterpret_cast<float2*>(cluster.map_shared_rank(dst, o)) =
          make_float2(acc[j][0], acc[j][1]);
      *reinterpret_cast<float2*>(cluster.map_shared_rank(dst + 8 * rs, o)) =
          make_float2(acc[j][2], acc[j][3]);
    }
    cluster.sync();
    if (tid < kMmaRows) {                     // each row's weight of each split
      float m = -INFINITY, l = 0.f, f[kMaxSplits];
      for (int p = 0; p < nsplit; ++p) m = fmaxf(m, rml[p * kMmaRows + tid].x);
#pragma unroll
      for (int p = 0; p < kMaxSplits; ++p) {
        if (p >= nsplit) break;
        const float2 ml = rml[p * kMmaRows + tid];
        f[p] = ml.x == -INFINITY ? 0.f : __expf(ml.x - m);
        l += ml.y * f[p];
      }
      const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
      for (int p = 0; p < kMaxSplits; ++p) {
        if (p >= nsplit) break;
        rml[p * kMmaRows + tid].x = f[p] * inv;
      }
    }
    __syncthreads();
    const int quads = chunk / 4;
    for (int idx = tid; idx < rows * quads; idx += blockDim.x) {
      const int row = idx / quads, j = (idx % quads) * 4;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int p = 0; p < nsplit; ++p) {
        const float w = rml[p * kMmaRows + row].x;
        const float4 v = *reinterpret_cast<const float4*>(racc + (p * kMmaRows + row) * rs + j);
        a.x += w * v.x;
        a.y += w * v.y;
        a.z += w * v.z;
        a.w += w * v.w;
      }
      const int i = row / g, head = h * g + row % g;
      bf16* dst = out + ((static_cast<size_t>(b) * sq + q0 + i) * hq + head) * D + split * chunk + j;
      rt::store2(dst, make_float2(a.x, a.y));
      rt::store2(dst + 2, make_float2(a.z, a.w));
    }
  }
}

template <int D, typename KV>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const void* starts,
                       void* out, int b, int sq, int hq, int hkv, int smax, float softcap,
                       int window, int splits, cudaStream_t stream) {
  const int g = hq / hkv;
  const int bq = min(sq, kMmaRows / g);
  constexpr size_t smem = mma_smem_bytes<D, KV>();
  auto kernel = chunked_prefill_mma_kernel<D, KV>;
  cudaError_t err = rt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr = {};
  cfg.gridDim = dim3(b * hkv * splits, (sq + bq - 1) / bq);
  cfg.blockDim = dim3(kMmaWarps * rt::kWarp);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  if (splits > 1) {                           // clusters of the splits along x
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = splits;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const bf16*>(q), static_cast<const KV*>(k),
                           static_cast<const KV*>(v), static_cast<const int*>(starts),
                           static_cast<bf16*>(out), sq, hq, hkv, smax, g, bq, splits,
                           1.f / sqrtf(static_cast<float>(D)), softcap, window);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// 1 when (dtype, d) goes to the tensor-core kernel, 0 for the CUDA-core one.
extern "C" int chunked_prefill_variant(int d, int dtype) {
  return dtype == 1 && (d == 64 || d == 80 || d == 128 || d == 256);
}

// Blocks of a cluster that split each q-block's key tiles. At D = 256 (the
// longest walks, gemma2's 4096-key window, and the smallest grids: Hkv = 4,
// 32 queries a block) as many as keep two blocks on every SM, a power of two
// (so that D / splits columns merge in each block), at most kMaxSplits
// (clusters of 8 were slower on every gemma2 shape timed) and at most a
// quarter of the tiles a q-block can walk; 1 elsewhere.
extern "C" int chunked_prefill_splits(int b, int sq, int hq, int hkv, int d, int smax,
                                      int window, int dtype) {
  if (d != 256 || !chunked_prefill_variant(d, dtype) || sq <= 0 || hkv <= 0) return 1;
  const int bq = max(1, min(sq, kMmaRows / max(1, hq / hkv)));
  const int blocks = b * hkv * ((sq + bq - 1) / bq);
  const int span = window > 0 ? min(smax, window + bq) : smax;
  const int tiles = (span + MmaPlan<256>::kKeys - 1) / MmaPlan<256>::kKeys;
  const int want = min(kMaxSplits, min(2 * rt::card_sms() / max(blocks, 1), tiles / kMinSplitTiles));
  int s = 1;
  while (2 * s <= want) s *= 2;
  return s;
}

// The launch for (q's dtype, d), K/V beside q in q's dtype or (FP8) e4m3.
template <bool FP8>
cudaError_t dispatch(const void* q, const void* k, const void* v, const void* starts, void* out,
                     int b, int sq, int hq, int hkv, int d, int smax, float softcap, int window,
                     int dtype, int splits, cudaStream_t s) {
  using KB = std::conditional_t<FP8, rt::e4m3, __nv_bfloat16>;   // K/V beside bf16 q
  using KF = std::conditional_t<FP8, rt::e4m3, float>;           // beside f32 q
  const int ncp = rt::col_pairs(d);
  if (chunked_prefill_variant(d, dtype)) {
    if (d == 64) return launch_mma<64, KB>(q, k, v, starts, out, b, sq, hq, hkv, smax, softcap, window, splits, s);
    if (d == 80) return launch_mma<80, KB>(q, k, v, starts, out, b, sq, hq, hkv, smax, softcap, window, splits, s);
    if (d == 128) return launch_mma<128, KB>(q, k, v, starts, out, b, sq, hq, hkv, smax, softcap, window, splits, s);
    return launch_mma<256, KB>(q, k, v, starts, out, b, sq, hq, hkv, smax, softcap, window, splits, s);
  }
  if (dtype == 1) {
    if (ncp == 1) return launch<__nv_bfloat16, KB, 1>(q, k, v, starts, out, b, sq, hq, hkv, d, smax, softcap, window, s);
    if (ncp == 2) return launch<__nv_bfloat16, KB, 2>(q, k, v, starts, out, b, sq, hq, hkv, d, smax, softcap, window, s);
    return launch<__nv_bfloat16, KB, 4>(q, k, v, starts, out, b, sq, hq, hkv, d, smax, softcap, window, s);
  }
  if (ncp == 1) return launch<float, KF, 1>(q, k, v, starts, out, b, sq, hq, hkv, d, smax, softcap, window, s);
  if (ncp == 2) return launch<float, KF, 2>(q, k, v, starts, out, b, sq, hq, hkv, d, smax, softcap, window, s);
  return launch<float, KF, 4>(q, k, v, starts, out, b, sq, hq, hkv, d, smax, softcap, window, s);
}

// dtype (q and out): 0 = f32, 1 = bf16; kv: 0 = K/V in q's dtype, 1 = e4m3.
// softcap <= 0 and window <= 0 mean none. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int chunked_prefill_launch(const void* q, const void* k, const void* v,
                                      const void* starts, void* out, int b, int sq, int hq,
                                      int hkv, int d, int smax, float softcap, int window,
                                      int dtype, int kv, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int splits = chunked_prefill_splits(b, sq, hq, hkv, d, smax, window, dtype);
  const cudaError_t err =
      kv ? dispatch<true>(q, k, v, starts, out, b, sq, hq, hkv, d, smax, softcap, window, dtype, splits, s)
         : dispatch<false>(q, k, v, starts, out, b, sq, hq, hkv, d, smax, softcap, window, dtype, splits, s);
  return static_cast<int>(err);
}

// Query rows one block holds for head_dim d (the wrapper refuses G above it).
extern "C" int chunked_prefill_max_group(int d) { return kWarps * rt::rows_per_warp(d); }
