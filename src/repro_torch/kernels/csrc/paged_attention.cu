// Paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `paged_attention` in
// src/repro/kernels/paged_attention.py (body `_kernel`): one query token per
// request over a page pool (N, page_size, Hkv, D) reached through
// block_tables (B, P); lengths[b] counts the tokens including the new one
// (clamped to P * page_size). Pages from ceil(len/ps) on are never read,
// table entries < 0 read page 0, optional softcap, GQA (G query heads per
// KV head), length 0 returns 0. An optional sliding window (window > 0)
// keeps the last `window` tokens, [len - window, len): the JAX model's
// MaskSpec("lengths", window), kpos > lengths - window with its lengths the
// write position, one less than this kernel's. The TPU kernel has no
// window: the JAX model decodes through XLA, the port through this kernel.
//
// Bound on this card: the bytes of K and V for the valid tokens at
// 3.35 TB/s; the products (4*D*G FLOPs per token and KV head) are far
// below the operation bound. At decode sizes (a few hundred tokens per
// request, one to eight requests) that is under a microsecond, so what
// sets the time is the launch, the device-memory round trips that follow
// one another (lengths and table, then K and V, whose rate an SM bounds),
// and the cluster barrier of the merge: the design spends SMs to shorten
// that chain.
//
// Design (flash decoding in one launch):
// * Each (b, kv-head) is a thread-block cluster of S blocks (grid
//   (S, B * Hkv), cluster (S, 1, 1)). S is chosen at launch so that the
//   grid fills the card's SMs: S = SMs / (B * Hkv), at most the table's
//   pages (the longest length it admits; the lengths themselves live on
//   the card) and at most the cluster limit (16, a non-portable cluster,
//   where the card can hold one of this kernel; else 8). The pages that
//   hold the token range [first, len) are split into S runs of whole
//   pages, at least one a split; a split past the request's length holds
//   no key, carries m = -inf and weighs 0. `first` is len - window under a
//   window, else 0: the splits cover [first, len) only, so the keys of
//   first's page below it are never in a split's range (weight 0) and the
//   pages before it are never read.
// * The request's block table (up to 256 pages) is copied into shared
//   memory beside the lengths read, so the K/V addresses wait for one
//   round trip, not two. In a block, warp w takes the split's key tiles
//   w, w + 4, ... and brings them in through its own 2-stage cp.async
//   ring: the next tile's copies are issued before the current tile is
//   used. Each copy resolves its page through the table; rows past the
//   split are zero-filled (a masked key gets weight 0, never 0 * garbage).
// * The warps' online-softmax partials (m, l, acc in f32) are rescaled to
//   the block's max and summed in shared memory into the block's partial.
//   Block o of the cluster owns output columns [o * chunk, (o + 1) *
//   chunk), chunk = ceil(D / S): each block stores its (m, l) into every
//   block and each acc column into the block that owns it, through
//   distributed shared memory (16-byte stores, which do not wait for a
//   reply as loads would); one `cluster.sync()`, and each block merges its
//   columns from the S partials out of its own shared memory and writes
//   them. One launch per call, no workspace, no second kernel; sums in a
//   fixed order.
//
// Two variants of the block's arithmetic; the launcher picks one from
// (dtype, D) alone (`paged_attention_variant`), never because the other
// failed.
// * `paged_attention_mma_kernel`, bf16 at D = 64, 128 or 256 (every config
//   of the port): tensor cores with the keys on M and the query heads on N
//   ("swap AB"), so G = 6 pads to 8 columns, not 16 rows, and G <= 16
//   takes two n-tiles (at D = 256 G <= 8, one n-tile: the O^T accumulator
//   is then 64 f32 registers a thread, as at D = 128 with two n-tiles, and
//   Q, the table, the partials and the rings take about 97 KB of shared
//   memory, so clusters of 16 fit). A warp tile is 16 keys: S^T = K Q^T
//   (mma.sync.m16n8k16, K by ldmatrix from the ring, Q^T fragments held in
//   registers), the online softmax in f32 down each column (one query head),
//   then O^T += V^T P^T with P rounded to bf16 (as the prefill kernel rounds
//   it): movmatrix turns the score accumulator into the B operand in
//   registers, and ldmatrix.trans reads V^T from the ring.
// * `paged_attention_kernel`, f32 inputs and other head dims: CUDA-core f32
//   products (the f32 path is held at 1e-4): a warp tile is 32 keys, lane c
//   scores key c for the G query rows (rt::WarpState), 1-4 warps as shared
//   memory allows.
//
// K/V pages may be fp8 e4m3 (an fp8 KV cache) with q in bf16 or f32; the
// variant still follows q's dtype. Each warp widens its e4m3 tiles to q's
// type as it stages them (e4m3 -> f16 -> f32 [-> bf16], exact) into the
// ring layout the rest already reads; those tiles are loaded and stored by
// the lanes instead of cp.async, so the next tile's load no longer overlaps
// the current tile's products: a first, simple design.
#include <cooperative_groups.h>

#include "attention_common.cuh"
#include "cp_async.cuh"
#include "mma_sync.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;        // warps of a tensor-core block
constexpr int kStages = 2;       // depth of each warp's cp.async ring
constexpr int kRows = 16;        // query heads a block's partial holds
constexpr int kTableSlots = 256; // block tables up to this many pages are staged
constexpr int kPortableCluster = 8;
constexpr int kMaxCluster = 16;

using bf16 = __nv_bfloat16;

struct Range {
  int lo, hi;                    // this split's keys: [lo, hi), empty if lo >= hi
};

// Split `split` of `splits` over the pages that hold [first, len).
__device__ __forceinline__ Range split_range(int first, int len, int ps, int split, int splits) {
  const int p0 = first / ps;
  const int pages = (len + ps - 1) / ps - p0;
  const int per = max(1, (pages + splits - 1) / splits);
  return {max(first, (p0 + split * per) * ps), min(len, (p0 + (split + 1) * per) * ps)};
}

// The first key a query at length `len` attends to: len - window under a
// sliding window (window > 0), else 0.
__device__ __forceinline__ int first_key(int len, int window) {
  return window > 0 ? max(0, len - window) : 0;
}

// Element offset of token `pos`'s row for KV head h in the page pool.
__device__ __forceinline__ size_t token_offset(const int* table, int pos, int ps, int hkv, int h,
                                               int d) {
  const int page = max(table[pos / ps], 0);
  return ((static_cast<size_t>(page) * ps + pos % ps) * hkv + h) * d;
}

// Start copying request b's block table into `staged` when it fits there
// (it then arrives beside the lengths read instead of after it); returns
// where the pages are to be read once the copies have landed.
__device__ __forceinline__ const int* stage_table(const int* tables, int b, int max_pages,
                                                  int* staged) {
  const int* row = tables + static_cast<size_t>(b) * max_pages;
  if (max_pages > kTableSlots) return row;
  for (int i = threadIdx.x; i < max_pages; i += blockDim.x)
    rt::cp_async_ca<4>(staged + i, row + i, true);
  return staged;
}

// The two halves of the cluster barrier that keeps a block's stores into
// a peer's shared memory from reaching a peer that has not started: every
// thread arrives when its block starts and waits before its first such
// store (by then the wait is almost always over).
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// A block's scratch for merging its warps: per head, each warp's m and its
// l rescaled to the block's max (wm, wl: warps x kRows), and its acc so
// rescaled (wacc: warps x d x kRows, over the rings once they are done).
struct Scratch {
  float* wm;
  float* wl;
  float* wacc;
};

// Where a block receives the block partials of its cluster. Block o owns output columns [o * chunk, (o + 1) *
// chunk) of every head, chunk = ceil(d / S); rank r's partial arrives as
// (m, l) per head in every block (ml: S x kRows) and as its acc columns in
// their owner (acc: S x chunk x kRows).
struct Recv {
  float2* ml;
  float* acc;
};

constexpr size_t kWmWlBytes = sizeof(float) * 2 * kWarps * kRows;

// Bytes of Recv for any S <= kMaxCluster (S * chunk <= d + 15).
__host__ __device__ constexpr size_t recv_bytes(int d) {
  return sizeof(float2) * kMaxCluster * kRows + sizeof(float) * (d + kMaxCluster - 1) * kRows;
}

__device__ __forceinline__ Recv recv_at(void* p) {
  float2* ml = static_cast<float2*>(p);
  return {ml, reinterpret_cast<float*>(ml + kMaxCluster * kRows)};
}

// The warp's rescale factor for a head whose m is `m` (its own max), from
// every warp's m in wm: exp(m - block max), 0 for a warp that saw no key.
__device__ __forceinline__ float rescale(const float* wm, int warps, int head, float m) {
  float top = -INFINITY;
  for (int w = 0; w < warps; ++w) top = fmaxf(top, wm[w * kRows + head]);
  return m == -INFINITY ? 0.f : __expf(m - top);
}

// Sum the warps' rescaled acc into the block's partial and store it, with
// each head's (m, l), into the blocks of the cluster that own its columns
// (distributed shared memory; the stores do not wait for a reply). `heads`
// (a multiple of 4) are the head slots the warps filled.
__device__ __forceinline__ void push_block(const Scratch& sc, const Recv& rv, int warps,
                                           int heads, int d) {
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(gridDim.x), rank = static_cast<int>(blockIdx.x);
  const int chunk = (d + splits - 1) / splits;
  const int quads = heads / 4;
  for (int idx = threadIdx.x; idx < d * quads; idx += blockDim.x) {
    const int col = idx / quads, h4 = 4 * (idx % quads);
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int w = 0; w < warps; ++w) {
      const float4 v = *reinterpret_cast<const float4*>(sc.wacc + (w * d + col) * kRows + h4);
      a.x += v.x;
      a.y += v.y;
      a.z += v.z;
      a.w += v.w;
    }
    const int o = col / chunk;
    *reinterpret_cast<float4*>(cluster.map_shared_rank(
        rv.acc + (rank * chunk + col - o * chunk) * kRows + h4, o)) = a;
  }
  for (int idx = threadIdx.x; idx < splits * heads; idx += blockDim.x) {
    const int head = idx % heads, o = idx / heads;
    float m = -INFINITY, l = 0.f;
    for (int w = 0; w < warps; ++w) {
      m = fmaxf(m, sc.wm[w * kRows + head]);
      l += sc.wl[w * kRows + head];
    }
    *cluster.map_shared_rank(rv.ml + rank * kRows + head, o) = make_float2(m, l);
  }
}

// After every block partial has arrived (cluster.sync): merge this block's
// columns of the G heads from the S partials in f32 and write them to
// `out` (the first of the G output rows). A head that saw no key gives 0.
template <typename T>
__device__ __forceinline__ void merge_owned(const Recv& rv, int g, int d, T* out) {
  const int splits = static_cast<int>(gridDim.x);
  const int chunk = (d + splits - 1) / splits;
  const int c0 = static_cast<int>(blockIdx.x) * chunk, n = min(chunk, d - c0);
  for (int idx = threadIdx.x; idx < g * n; idx += blockDim.x) {
    const int r = idx % g, j = idx / g;
    float2 ml[kMaxCluster];        // every load first: one latency, not S
    float av[kMaxCluster];
#pragma unroll
    for (int p = 0; p < kMaxCluster; ++p) {
      ml[p] = p < splits ? rv.ml[p * kRows + r] : make_float2(-INFINITY, 0.f);
      av[p] = p < splits ? rv.acc[(p * chunk + j) * kRows + r] : 0.f;
    }
    float m = -INFINITY;
#pragma unroll
    for (int p = 0; p < kMaxCluster; ++p) m = fmaxf(m, ml[p].x);
    float l = 0.f, a = 0.f;
#pragma unroll
    for (int p = 0; p < kMaxCluster; ++p) {
      const float f = ml[p].x == -INFINITY ? 0.f : __expf(ml[p].x - m);
      l += ml[p].y * f;
      a += av[p] * f;
    }
    const float o = a / fmaxf(l, 1e-30f);
    T* dst = out + r * d + c0 + j;
    if constexpr (sizeof(T) == 2) *dst = __float2bfloat16_rn(o);
    else *dst = o;
  }
}

// ------------------------------------------------- tensor-core variant

constexpr int kMmaKeys = 16;     // keys of a warp tile (the M of m16n8k16)

template <int D>
__host__ __device__ constexpr int mma_stride() { return D + 8; }   // ldmatrix without conflicts

template <int D>
__host__ __device__ constexpr size_t mma_ring_bytes() {
  return sizeof(bf16) * kWarps * kStages * 2 * kMmaKeys * mma_stride<D>();
}

// Q (kRows x stride), the staged table, wm and wl, the received partials,
// then the warps' rings (wacc, kWarps * D * kRows floats, overlays them
// once they are done with).
template <int D>
__host__ __device__ constexpr size_t mma_smem_bytes() {
  static_assert(sizeof(float) * kWarps * D * kRows <= mma_ring_bytes<D>(), "wacc > rings");
  return sizeof(bf16) * kRows * mma_stride<D>() + sizeof(int) * kTableSlots + kWmWlBytes +
         recv_bytes(D) + mma_ring_bytes<D>();
}

// One 16-byte chunk (8 bf16) of a staged K/V row: a cp.async when K/V are
// bf16, else 8 e4m3 values widened and stored by the lane (zeros when
// !in, src then unread).
template <typename KV>
__device__ __forceinline__ void stage_bf16x8(bf16* dst, const KV* src, bool in) {
  if constexpr (std::is_same_v<KV, bf16>) {
    rt::cp_async16(dst, src, in);
  } else {
    *reinterpret_cast<uint4*>(dst) = in ? rt::widen_e4m3<bf16>(src) : make_uint4(0, 0, 0, 0);
  }
}

template <int D, int NT, typename KV>
__global__ void __launch_bounds__(kWarps * rt::kWarp)
paged_attention_mma_kernel(const bf16* __restrict__ q, const KV* __restrict__ kp,
                           const KV* __restrict__ vp, const int* __restrict__ tables,
                           const int* __restrict__ lengths, bf16* __restrict__ out, int hq,
                           int hkv, int ps, int max_pages, float scale, float softcap,
                           int window) {
  // a tile's rescale (64 FMULs a lane at D = 256) and softcap cost about as
  // much as its products: the softcap takes two MUFU operations, and at
  // D = 256 a tile that raises no head's max skips the rescale (at D = 128
  // the skip made one slot 1.02-1.03x slower; PERF.md §6)
  constexpr bool W = D > 128;
  constexpr int S = mma_stride<D>();
  constexpr int CH = D / 8;      // 16-byte chunks per row
  constexpr int KD = D / 16;     // k-steps of K Q^T, and 16-row tiles of O^T
  constexpr int TILE = kMmaKeys * S;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);                     // kRows x S
  int* tab_s = reinterpret_cast<int*>(qs + kRows * S);              // kTableSlots
  float* wm = reinterpret_cast<float*>(tab_s + kTableSlots);
  const Recv rv = recv_at(wm + 2 * kWarps * kRows);
  bf16* ring_base = reinterpret_cast<bf16*>(reinterpret_cast<unsigned char*>(rv.ml) +
                                            recv_bytes(D));               // warps' rings
  const Scratch sc{wm, wm + kWarps * kRows, reinterpret_cast<float*>(ring_base)};
  cluster_arrive_relaxed();

  const int tid = threadIdx.x, warp = tid / rt::kWarp, lane = tid % rt::kWarp;
  const int gid = lane >> 2, tq = lane & 3;
  const int b = blockIdx.y / hkv, h = blockIdx.y % hkv;
  const int g = hq / hkv;
  const bf16* qb = q + (static_cast<size_t>(b) * hq + h * g) * D;
  const int length = lengths[b];
  const int* table = stage_table(tables, b, max_pages, tab_s);
  for (int idx = tid; idx < NT * 8 * CH; idx += blockDim.x) {
    const int row = idx / CH, c = idx % CH;
    rt::cp_async16(qs + row * S + c * 8, qb + (row < g ? row : 0) * D + c * 8, row < g);
  }
  rt::cp_async_commit();

  const int len = max(0, min(length, max_pages * ps));
  const Range rg = split_range(first_key(len, window), len, ps, blockIdx.x, gridDim.x);
  const int ntiles = rg.hi > rg.lo ? (rg.hi - rg.lo + kMmaKeys - 1) / kMmaKeys : 0;
  const int mine = ntiles > warp ? (ntiles - warp + kWarps - 1) / kWarps : 0;
  bf16* ring = ring_base + warp * kStages * 2 * TILE;
  auto tile_start = [&](int i) { return rg.lo + (warp + i * kWarps) * kMmaKeys; };
  // Lane l copies 16-byte chunk l % CH of rows l / CH, + RP, ... (a warp
  // instruction covers whole rows). With one warp per scheduler the address
  // arithmetic is on the critical path, so when pages and the split start
  // are multiples of the tile (every page size the executor uses), a
  // tile's rows lie in one page: one table read a tile, then one add a row.
  constexpr int RP = rt::kWarp / CH;
  const int c = lane % CH, r0 = lane / CH;
  const bool one_page = ps % kMmaKeys == 0 && rg.lo % kMmaKeys == 0;
  const size_t row_step = static_cast<size_t>(hkv) * D;
  auto load_tile = [&](int i) {  // this warp's i-th tile into stage i % kStages
    const int k0 = tile_start(i);
    bf16* kd = ring + (i % kStages) * 2 * TILE + c * 8;
    bf16* vd = kd + TILE;
    const size_t base = one_page ? token_offset(table, k0, ps, hkv, h, D) + c * 8 : 0;
#pragma unroll
    for (int j = 0; j < kMmaKeys / RP; ++j) {
      const int r = r0 + j * RP;
      const bool in = k0 + r < rg.hi;
      size_t off = 0;
      if (in) off = one_page ? base + r * row_step : token_offset(table, k0 + r, ps, hkv, h, D) + c * 8;
      stage_bf16x8(kd + r * S, kp + off, in);
      stage_bf16x8(vd + r * S, vp + off, in);
    }
  };
  rt::cp_async_wait<0>();                  // Q and the table have landed
  __syncthreads();
  if (mine > 0) load_tile(0);
  rt::cp_async_commit();

  // Q^T fragments (the B operand of S^T = K Q^T): n-tile nt holds heads
  // 8*nt .. 8*nt + 7; one ldmatrix.x4 gives two k-steps
  uint32_t qf[KD][NT][2];
#pragma unroll
  for (int kk = 0; kk < KD; kk += 2) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t r[4];
      rt::ldsm_x4(r, qs + (nt * 8 + lane % 8) * S + kk * 16 + (lane / 8) * 8);
      qf[kk][nt][0] = r[0];
      qf[kk][nt][1] = r[1];
      qf[kk + 1][nt][0] = r[2];
      qf[kk + 1][nt][1] = r[3];
    }
  }

  // this lane's columns: heads 8*nt + 2*tq + j; l is the lane's share
  // (keys gid, gid + 8 of each tile), summed over the lanes at the end
  float m[NT][2], l[NT][2];
  float acc[KD][NT][4];         // O^T: rows d = 16*dt + gid (+8), columns heads
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    m[nt][0] = m[nt][1] = -INFINITY;
    l[nt][0] = l[nt][1] = 0.f;
#pragma unroll
    for (int dt = 0; dt < KD; ++dt) acc[dt][nt][0] = acc[dt][nt][1] = acc[dt][nt][2] = acc[dt][nt][3] = 0.f;
  }

  for (int it = 0; it < mine; ++it) {
    if (it + 1 < mine) load_tile(it + 1);
    rt::cp_async_commit();
    rt::cp_async_wait<1>();                // this tile has landed
    __syncwarp();
    const bf16* kd = ring + (it % kStages) * 2 * TILE;
    const bf16* vd = kd + TILE;
    const int mi = lane / 8;
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t ka[4];
      rt::ldsm_x4(ka, kd + ((mi % 2) * 8 + lane % 8) * S + kk * 16 + (mi / 2) * 8);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) rt::mma_bf16(s[nt], ka, qf[kk][nt][0], qf[kk][nt][1]);
    }
    const int k0 = tile_start(it);
    const bool ok_lo = k0 + gid < rg.hi, ok_hi = k0 + gid + 8 < rg.hi;
    uint32_t pb[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * scale;
        if (softcap > 0.f) x = rt::soft_cap_fast(x, softcap, 2.f / softcap);
        x = (e < 2 ? ok_lo : ok_hi) ? x : -INFINITY;
        s[nt][e] = x;
        mx[e & 1] = fmaxf(mx[e & 1], x);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) mx[j] = fmaxf(mx[j], __shfl_xor_sync(rt::kFull, mx[j], o));
        const float mn = fmaxf(m[nt][j], mx[j]);
        const float alpha = mn == -INFINITY ? 1.f : __expf(m[nt][j] - mn);
        m[nt][j] = mn;
        l[nt][j] *= alpha;
        if (!W || __any_sync(rt::kFull, alpha != 1.f)) {
#pragma unroll
          for (int dt = 0; dt < KD; ++dt) {
            acc[dt][nt][j] *= alpha;
            acc[dt][nt][j + 2] *= alpha;
          }
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = s[nt][e] == -INFINITY ? 0.f : __expf(s[nt][e] - m[nt][e & 1]);
        s[nt][e] = p;
        l[nt][e & 1] += p;
      }
      // P^T as the B operand: keys 2*tq, 2*tq + 1 (+ 8) of head gid
      pb[nt][0] = rt::movmatrix_trans(rt::pack_bf16(s[nt][0], s[nt][1]));
      pb[nt][1] = rt::movmatrix_trans(rt::pack_bf16(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int dt = 0; dt < KD; ++dt) {
      uint32_t va[4];              // V^T rows d 16*dt.., keys 0..15
      rt::ldsm_x4_trans(va, vd + ((mi / 2) * 8 + lane % 8) * S + dt * 16 + (mi % 2) * 8);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) rt::mma_bf16(acc[dt][nt], va, pb[nt][0], pb[nt][1]);
    }
    __syncwarp();                          // this stage may be refilled
  }

  // merge the warps into the block's partial, rescaled to its max
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) l[nt][j] += __shfl_xor_sync(rt::kFull, l[nt][j], o);
      if (gid == 0) sc.wm[warp * kRows + nt * 8 + 2 * tq + j] = m[nt][j];
    }
  }
  __syncthreads();
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float f = rescale(sc.wm, kWarps, nt * 8 + 2 * tq + j, m[nt][j]);
      if (gid == 0) sc.wl[warp * kRows + nt * 8 + 2 * tq + j] = l[nt][j] * f;
#pragma unroll
      for (int dt = 0; dt < KD; ++dt) {
        acc[dt][nt][j] *= f;
        acc[dt][nt][j + 2] *= f;
      }
    }
#pragma unroll
    for (int dt = 0; dt < KD; ++dt) {
      float* dst = sc.wacc + (warp * D + dt * 16 + gid) * kRows + nt * 8 + 2 * tq;
      *reinterpret_cast<float2*>(dst) = make_float2(acc[dt][nt][0], acc[dt][nt][1]);
      *reinterpret_cast<float2*>(dst + 8 * kRows) = make_float2(acc[dt][nt][2], acc[dt][nt][3]);
    }
  }
  __syncthreads();
  cluster_wait();                          // every block of the cluster has started
  push_block(sc, rv, kWarps, NT * 8, D);
  cg::this_cluster().sync();
  merge_owned(rv, g, D, out + (static_cast<size_t>(b) * hq + h * g) * D);
}

// ------------------------------------------------- CUDA-core variant

// Q (R x d, f32), the staged table, wm and wl, the received partials,
// then the warps' rings of 32-key tiles (K rows padded to k_stride(d)),
// which wacc overlays.
template <int R>
size_t core_smem_bytes(int warps, int d, int esize) {
  const size_t ring =
      static_cast<size_t>(warps) * kStages * rt::kTileKeys * (rt::k_stride(d) + d) * esize;
  const size_t wacc = sizeof(float) * warps * d * kRows;
  return sizeof(float) * R * d + sizeof(int) * kTableSlots + kWmWlBytes + recv_bytes(d) +
         (ring > wacc ? ring : wacc);
}

template <typename T, typename KV, int NCP>
__global__ void __launch_bounds__(kWarps * rt::kWarp)
paged_attention_kernel(const T* __restrict__ q, const KV* __restrict__ kp,
                       const KV* __restrict__ vp, const int* __restrict__ tables,
                       const int* __restrict__ lengths, T* __restrict__ out, int hq, int hkv,
                       int d, int ps, int max_pages, float scale, float softcap, int window) {
  constexpr int R = rt::Shape<NCP>::kRowsPerWarp;
  constexpr int E = 16 / sizeof(T);        // elements of a 16-byte chunk
  constexpr int KB = sizeof(T) == 2 ? 4 : 8;   // copy size the padded K rows allow
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warps = blockDim.x / rt::kWarp;
  const int warp = threadIdx.x / rt::kWarp, lane = threadIdx.x % rt::kWarp;
  const int b = blockIdx.y / hkv, h = blockIdx.y % hkv;
  const int g = hq / hkv;
  float* qs = reinterpret_cast<float*>(smem_raw);                  // R x d
  int* tab_s = reinterpret_cast<int*>(qs + R * d);                 // kTableSlots
  float* wm = reinterpret_cast<float*>(tab_s + kTableSlots);
  const Recv rv = recv_at(wm + 2 * kWarps * kRows);
  float* ring_base = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(rv.ml) +
                                              recv_bytes(d));      // warps' rings
  const Scratch sc{wm, wm + kWarps * kRows, ring_base};
  cluster_arrive_relaxed();
  const int tile = rt::kTileKeys * (rt::k_stride(d) + d);
  T* ring = reinterpret_cast<T*>(ring_base) + warp * kStages * tile;

  const int* table = stage_table(tables, b, max_pages, tab_s);
  rt::cp_async_commit();
  for (int idx = threadIdx.x; idx < R * d; idx += blockDim.x) {
    const int r = idx / d, col = idx % d;
    qs[idx] = r < g ? rt::to_f32(q[(static_cast<size_t>(b) * hq + h * g + r) * d + col]) : 0.f;
  }

  const int len = max(0, min(lengths[b], max_pages * ps));
  const Range rg = split_range(first_key(len, window), len, ps, blockIdx.x, gridDim.x);
  const int ntiles = rg.hi > rg.lo ? (rg.hi - rg.lo + rt::kTileKeys - 1) / rt::kTileKeys : 0;
  const int mine = ntiles > warp ? (ntiles - warp + warps - 1) / warps : 0;
  const int chunks = d / E;
  auto tile_start = [&](int i) { return rg.lo + (warp + i * warps) * rt::kTileKeys; };
  auto load_tile = [&](int i) {
    const int k0 = tile_start(i);
    T* kd = ring + (i % kStages) * tile;
    T* vd = kd + rt::kTileKeys * rt::k_stride(d);
    for (int idx = lane; idx < rt::kTileKeys * chunks; idx += rt::kWarp) {
      const int row = idx / chunks, c = idx % chunks;
      const bool in = k0 + row < rg.hi;
      const size_t row_off = in ? token_offset(table, k0 + row, ps, hkv, h, d) : 0;
      if constexpr (std::is_same_v<KV, T>) {
        const size_t off = row_off + c * E;
#pragma unroll
        for (int part = 0; part < 16 / KB; ++part)
          rt::cp_async_ca<KB>(kd + row * rt::k_stride(d) + c * E + part * (KB / sizeof(T)),
                              kp + off + part * (KB / sizeof(T)), in);
        rt::cp_async16(vd + row * d + c * E, vp + off, in);
      } else {                     // e4m3 widened to T (the K row is 4-byte aligned)
        rt::stage_chunk(in ? kp + row_off : nullptr, in ? vp + row_off : nullptr,
                        kd + row * rt::k_stride(d), vd + row * d, c);
      }
    }
  };
  rt::cp_async_wait<0>();
  __syncthreads();                         // qs and the table are in place
  if (mine > 0) load_tile(0);
  rt::cp_async_commit();

  rt::WarpState<R, NCP> st;
  st.init();
  for (int it = 0; it < mine; ++it) {
    if (it + 1 < mine) load_tile(it + 1);
    rt::cp_async_commit();
    rt::cp_async_wait<1>();
    __syncwarp();
    const T* kd = ring + (it % kStages) * tile;
    const bool key_ok = tile_start(it) + lane < rg.hi;
    st.tile(qs, kd, kd + rt::kTileKeys * rt::k_stride(d), d, scale, softcap, lane,
            [&](int r) { return r < g && key_ok; });
    __syncwarp();
  }

  // merge the warps into the block's partial, rescaled to its max
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) sc.wm[warp * kRows + r] = st.m[r];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float f = rescale(sc.wm, warps, r, st.m[r]);
    if (lane == 0) sc.wl[warp * kRows + r] = st.l[r] * f;
#pragma unroll
    for (int j = 0; j < NCP; ++j) {
      const int col = 2 * lane + 64 * j;
      if (col < d) {
        sc.wacc[(warp * d + col) * kRows + r] = st.acc[r][j].x * f;
        sc.wacc[(warp * d + col + 1) * kRows + r] = st.acc[r][j].y * f;
      }
    }
  }
  __syncthreads();
  cluster_wait();                          // every block of the cluster has started
  push_block(sc, rv, warps, R, d);
  cg::this_cluster().sync();
  merge_owned(rv, g, d, out + (static_cast<size_t>(b) * hq + h * g) * d);
}

// ------------------------------------------------- launch

// S: blocks per (b, kv-head), as many as fill the card's SMs.
int choose_splits(int pairs, int max_pages, int cap) {
  const int s = min(rt::card_sms() / max(pairs, 1), min(cap, max_pages));
  return max(s, 1);
}

// The launch of a (splits, pairs) grid in clusters of `splits` blocks
// along x (not copied: cfg points at attr).
struct ClusterLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr = {};
  ClusterLaunch(int splits, int pairs, int threads, size_t smem, cudaStream_t stream) {
    cfg.gridDim = dim3(splits, pairs, 1);
    cfg.blockDim = dim3(threads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = splits;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
};

// The largest cluster this kernel may launch with: 16 where the card can
// co-schedule a non-portable cluster of 16 of its blocks, else 8.
template <typename Kernel>
int cluster_cap(Kernel kernel, int threads, size_t smem) {
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1) ==
      cudaSuccess) {
    const ClusterLaunch l(kMaxCluster, 1, threads, smem, nullptr);
    int clusters = 0;
    if (cudaOccupancyMaxActiveClusters(&clusters, kernel, &l.cfg) == cudaSuccess &&
        clusters > 0)
      return kMaxCluster;
  }
  cudaGetLastError();              // the query's error is not the launch's
  return kPortableCluster;
}

template <typename Kernel, typename... Args>
cudaError_t launch_clusters(Kernel kernel, int splits, int pairs, int threads, size_t smem,
                            cudaStream_t stream, Args... args) {
  const ClusterLaunch l(splits, pairs, threads, smem, stream);
  cudaError_t err = cudaLaunchKernelEx(&l.cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

struct Call {
  const void *q, *kp, *vp, *tables, *lengths;
  void* out;
  int b, hq, hkv, d, ps, max_pages;
  float softcap;
  int window;
  cudaStream_t stream;
};

template <int D, int NT, typename KV>
int mma_cap() {
  static const int cap = [] {
    auto kernel = paged_attention_mma_kernel<D, NT, KV>;
    if (rt::allow_smem(kernel, mma_smem_bytes<D>()) != cudaSuccess) {
      cudaGetLastError();
      return kPortableCluster;
    }
    return cluster_cap(kernel, kWarps * rt::kWarp, mma_smem_bytes<D>());
  }();
  return cap;
}

template <int D, int NT, typename KV>
cudaError_t launch_mma(const Call& c, int splits) {
  auto kernel = paged_attention_mma_kernel<D, NT, KV>;
  constexpr size_t smem = mma_smem_bytes<D>();
  cudaError_t err = rt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  return launch_clusters(kernel, splits, c.b * c.hkv, kWarps * rt::kWarp, smem, c.stream,
                         static_cast<const bf16*>(c.q), static_cast<const KV*>(c.kp),
                         static_cast<const KV*>(c.vp), static_cast<const int*>(c.tables),
                         static_cast<const int*>(c.lengths), static_cast<bf16*>(c.out), c.hq,
                         c.hkv, c.ps, c.max_pages, 1.f / sqrtf(static_cast<float>(D)), c.softcap,
                         c.window);
}

// warps of a CUDA-core block: as many (up to 4) as fit in 200 KB
template <typename T, int NCP>
int core_warps(int d) {
  constexpr int R = rt::Shape<NCP>::kRowsPerWarp;
  int warps = kWarps;
  while (warps > 1 && core_smem_bytes<R>(warps, d, sizeof(T)) > 200 * 1024) warps /= 2;
  return warps;
}

template <typename T, typename KV, int NCP>
cudaError_t launch_core(const Call& c, int splits) {
  constexpr int R = rt::Shape<NCP>::kRowsPerWarp;
  const int warps = core_warps<T, NCP>(c.d);
  const size_t smem = core_smem_bytes<R>(warps, c.d, sizeof(T));
  auto kernel = paged_attention_kernel<T, KV, NCP>;
  cudaError_t err = rt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  return launch_clusters(kernel, splits, c.b * c.hkv, warps * rt::kWarp, smem, c.stream,
                         static_cast<const T*>(c.q), static_cast<const KV*>(c.kp),
                         static_cast<const KV*>(c.vp), static_cast<const int*>(c.tables),
                         static_cast<const int*>(c.lengths), static_cast<T*>(c.out), c.hq,
                         c.hkv, c.d, c.ps, c.max_pages,
                         1.f / sqrtf(static_cast<float>(c.d)), c.softcap, c.window);
}

int variant(int d, int dtype) { return dtype == 1 && (d == 64 || d == 128 || d == 256); }

// The cluster limit of the kernel (d, dtype, g, K/V) goes to (G <= 8 at
// D = 256).
template <typename KV>
int cap_for(int d, int dtype, int g) {
  if (!variant(d, dtype)) return kPortableCluster;
  if (d == 64) return g <= 8 ? mma_cap<64, 1, KV>() : mma_cap<64, 2, KV>();
  if (d == 128) return g <= 8 ? mma_cap<128, 1, KV>() : mma_cap<128, 2, KV>();
  return mma_cap<256, 1, KV>();
}

// The launch for (q's dtype, d), K/V beside q in q's dtype or (FP8) e4m3.
template <bool FP8>
cudaError_t dispatch(const Call& c, int dtype, int splits) {
  using KB = std::conditional_t<FP8, rt::e4m3, bf16>;    // K/V beside bf16 q
  using KF = std::conditional_t<FP8, rt::e4m3, float>;   // beside f32 q
  const int g = c.hq / c.hkv;
  const int ncp = rt::col_pairs(c.d);
  if (variant(c.d, dtype)) {
    if (c.d == 64) return g <= 8 ? launch_mma<64, 1, KB>(c, splits) : launch_mma<64, 2, KB>(c, splits);
    if (c.d == 128) return g <= 8 ? launch_mma<128, 1, KB>(c, splits) : launch_mma<128, 2, KB>(c, splits);
    return launch_mma<256, 1, KB>(c, splits);
  }
  if (dtype == 1) {
    if (ncp == 1) return launch_core<bf16, KB, 1>(c, splits);
    if (ncp == 2) return launch_core<bf16, KB, 2>(c, splits);
    return launch_core<bf16, KB, 4>(c, splits);
  }
  if (ncp == 1) return launch_core<float, KF, 1>(c, splits);
  if (ncp == 2) return launch_core<float, KF, 2>(c, splits);
  return launch_core<float, KF, 4>(c, splits);
}

}  // namespace

// 1 when (dtype, d) goes to the tensor-core kernel, 0 for the CUDA-core one.
extern "C" int paged_attention_variant(int d, int dtype) { return variant(d, dtype); }

// Blocks per (b, kv-head) a call with these sizes launches (kv as below).
extern "C" int paged_attention_splits(int b, int hq, int hkv, int d, int max_pages, int dtype,
                                      int kv) {
  const int cap = kv ? cap_for<rt::e4m3>(d, dtype, hq / hkv) : cap_for<bf16>(d, dtype, hq / hkv);
  return choose_splits(b * hkv, max_pages, cap);
}

// dtype (q and out): 0 = f32, 1 = bf16; kv: 0 = K/V in q's dtype, 1 = e4m3.
// softcap <= 0 and window <= 0 mean none. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int paged_attention_launch(const void* q, const void* kp, const void* vp,
                                      const void* tables, const void* lengths, void* out, int b,
                                      int hq, int hkv, int d, int ps, int max_pages,
                                      float softcap, int window, int dtype, int kv, void* stream) {
  const Call c{q, kp, vp, tables, lengths, out, b, hq, hkv, d, ps, max_pages, softcap, window,
               static_cast<cudaStream_t>(stream)};
  const int splits = paged_attention_splits(b, hq, hkv, d, max_pages, dtype, kv);
  const cudaError_t err = kv ? dispatch<true>(c, dtype, splits) : dispatch<false>(c, dtype, splits);
  return static_cast<int>(err);
}

// Query heads per KV head one block holds for head_dim d (the wrapper
// refuses G above it).
extern "C" int paged_attention_max_group(int d) { return rt::rows_per_warp(d); }
