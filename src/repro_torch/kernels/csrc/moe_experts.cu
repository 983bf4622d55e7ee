// Routed expert products of a mixture-of-experts layer on one card, for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's apply_moe_reference
// (src/repro/models/moe.py) runs every token through every expert as dense
// XLA dots and masks the combine, and the port did the same with cuBLAS's
// batched products over every held expert table. A decode step routes a
// few tokens to each of a few of the held experts, so that dispatch reads
// every table (3 x d x f bf16 an expert) for mostly zero-weighted rows.
// These kernels do the same work over each held expert's live tokens alone:
//
//   moe_lists_kernel     one block: from the routes (ids (T, k), global),
//                        the live rows and the held range, each held
//                        expert's count and offset, the held assignments
//                        sorted stably by (expert, token) (tok: the token
//                        of each place in the list), and for each (token,
//                        j) its place in the list or -1.
//   moe_gate_up_kernel   grid (held expert, column tiles of d_ff): h =
//                        act(x w_gate) * (x w_up) over the expert's tokens,
//                        in list order. An expert with no token returns
//                        before it reads a weight byte.
//   moe_down_kernel      grid (held expert, column tiles of d_model): y = h
//                        w_down over the expert's rows of h, in list order.
//   moe_combine_kernel   out[t] = sum_j gate[t, j] * y[place[t, j]] in f32
//                        over the token's held picks (j in order; no
//                        atomics), cast to the working type; 0 for a row
//                        with none.
//
// Bound on this card: at decode the bytes of the touched experts' tables
// (about 209 MB each at arctic's 7168 x 4864), read once; at prefill's tens
// of tokens an expert, still the bytes (the products reach the tensor
// cores' rate only past about 300 tokens an expert). The products are
// swap-AB mma.sync.m16n8k16 (bf16 in, f32 accumulators): the weight tile is
// the 16-row side, the expert's tokens the 8-column side, BN = 8..64 columns
// a block (from the mean load, T x k over the router's experts), so a
// decode's 1 to 4 tokens an expert pad to 8, not to 64. K streams through a 4-stage cp.async ring of 64-deep tiles (16 KB of
// weights a stage for gate and up, whose token rows are loaded once for
// both), XOR-swizzled so that ldmatrix reads conflict-free; an expert with
// more tokens than BN takes its tokens BN at a time. Rounding is where the
// plain ops round: g and u to bf16, act(g) to bf16, h and y to bf16; the
// f32 combine adds the same products the plain combine adds. d_model and
// d_ff are multiples of 8 (16-byte rows); a last tile past either is read
// as zeros and not stored.
//
// f32 (the SMOKE configurations) runs the same passes on the CUDA cores, as
// cuBLAS's f32 products do: a thread a column of a 128-column tile, the
// expert's tokens 8 at a time, K through shared memory 64 deep, f32 FMAs;
// any d_model and d_ff.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "activation.cuh"
#include "mma_sync.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 64;         // output columns a block: 4 warps x 16
constexpr int kBK = 64;         // depth of a stage
constexpr int kStages = 4;
constexpr int kThreads = 128;
constexpr int kListThreads = 1024;
constexpr int kMaxHeld = 1024;  // the lists kernel's shared offsets
constexpr int kF32Cols = 128;   // f32: output columns a block, one a thread
constexpr int kF32Tokens = 8;   // f32: tokens a pass over K

// A tile of rows x 64 bf16 in shared memory, 8 chunks of 16 bytes a row:
// chunk c of row r sits at r * 8 + (c ^ (r & 7)), so the 8 rows an
// ldmatrix reads at one column lie in 8 different banks.
__device__ __forceinline__ int swz(int r, int c) { return r * 8 + (c ^ (r & 7)); }

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The j (0..k-1) of the token's pick of expert ``id``, or -1.
__device__ __forceinline__ int pick(const long long* ids, int k, long long id) {
  for (int j = 0; j < k; ++j)
    if (ids[j] == id) return j;
  return -1;
}

// ---------------------------------------------------------------------------
// lists
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kListThreads)
moe_lists_kernel(const long long* __restrict__ ids, int ids_stride,
                 const uint8_t* __restrict__ live, int t_rows, int k, long long first,
                 int held, int* __restrict__ counts, int* __restrict__ offsets,
                 int* __restrict__ tok, int* __restrict__ place) {
  __shared__ int s_off[kMaxHeld + 1];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warps = blockDim.x >> 5;
  for (int i = tid; i < t_rows * k; i += blockDim.x) place[i] = -1;
  // each warp counts its experts' live assignments, 32 tokens a ballot
  for (int e = warp; e < held; e += warps) {
    int n = 0;
    for (int t0 = 0; t0 < t_rows; t0 += 32) {
      const int t = t0 + lane;
      const bool hit = t < t_rows && (live == nullptr || live[t]) &&
                       pick(ids + static_cast<size_t>(t) * ids_stride, k, first + e) >= 0;
      n += __popc(__ballot_sync(0xffffffffu, hit));
    }
    if (lane == 0) s_off[e + 1] = n;
  }
  __syncthreads();
  if (tid == 0) {
    s_off[0] = 0;
    for (int e = 0; e < held; ++e) {
      counts[e] = s_off[e + 1];
      s_off[e + 1] += s_off[e];
    }
  }
  __syncthreads();
  // again, each hit placed after the expert's earlier tokens (stable)
  for (int e = warp; e < held; e += warps) {
    int at = s_off[e];
    if (lane == 0) offsets[e] = at;
    for (int t0 = 0; t0 < t_rows; t0 += 32) {
      const int t = t0 + lane;
      const int j = t < t_rows && (live == nullptr || live[t])
                        ? pick(ids + static_cast<size_t>(t) * ids_stride, k, first + e)
                        : -1;
      const unsigned mask = __ballot_sync(0xffffffffu, j >= 0);
      if (j >= 0) {
        const int pos = at + __popc(mask & ((1u << lane) - 1u));
        tok[pos] = t;
        place[t * k + j] = pos;
      }
      at += __popc(mask);
    }
  }
}

// ---------------------------------------------------------------------------
// the expert products
// ---------------------------------------------------------------------------

template <int BN, bool kGated>
struct Tiles {
  static constexpr int kW = kBK * kBM;                     // a weight tile's elements
  static constexpr int kMats = kGated ? 2 : 1;
  static constexpr int kStage = kMats * kW + BN * kBK;     // a stage's elements
  static constexpr size_t kBytes = sizeof(bf16) * kStages * kStage;
};

// out[list row][n0 + 0..63] for the expert blockIdx.x's rows of the list,
// n0 = 64 * blockIdx.y. A row's input is a[tok[row]] (gate and up: x) or
// a[row] (down: h). Weights (held, K, N) row-major; out (rows, N).
template <int BN, bool kGated>
__device__ __forceinline__ void expert_gemm(const bf16* __restrict__ a,
                                            const int* __restrict__ tok,
                                            const int* __restrict__ counts,
                                            const int* __restrict__ offsets,
                                            const bf16* __restrict__ w0,
                                            const bf16* __restrict__ w1,
                                            bf16* __restrict__ out, int K, int N, int gelu) {
  using Ti = Tiles<BN, kGated>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ int s_src[BN];
  bf16* sm = reinterpret_cast<bf16*>(smem_raw);
  const int e = blockIdx.x;
  const int count = counts[e];
  if (count == 0) return;                     // no weight byte read
  const int base = offsets[e];
  const int n0 = blockIdx.y * kBM;
  const size_t table = static_cast<size_t>(e) * K * N;
  const bf16* wa = w0 + table;
  const bf16* wb = w1 == nullptr ? nullptr : w1 + table;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tq = lane & 3;
  const int ksteps = (K + kBK - 1) / kBK;

  for (int c0 = 0; c0 < count; c0 += BN) {
    const int rows = min(BN, count - c0);
    for (int r = tid; r < BN; r += kThreads)
      s_src[r] = r < rows ? (kGated ? tok[base + c0 + r] : base + c0 + r) : -1;
    __syncthreads();

    auto load = [&](int stage, int kt) {
      bf16* st = sm + stage * Ti::kStage;
      const int k0 = kt * kBK;
#pragma unroll
      for (int i = tid; i < kBK * 8; i += kThreads) {
        const int r = i >> 3, c = i & 7;
        // zeros past the table's last row or column
        const bool in = k0 + r < K && n0 + c * 8 < N;
        const size_t g = in ? static_cast<size_t>(k0 + r) * N + n0 + c * 8 : 0;
        rt::cp_async16(st + swz(r, c) * 8, wa + g, in);
        if constexpr (kGated) rt::cp_async16(st + Ti::kW + swz(r, c) * 8, wb + g, in);
      }
      bf16* sx = st + Ti::kMats * Ti::kW;
      for (int i = tid; i < BN * 8; i += kThreads) {
        const int r = i >> 3, c = i & 7;
        const int src = s_src[r];
        const bool in = src >= 0 && k0 + c * 8 < K;
        const bf16* p = a + (in ? static_cast<size_t>(src) * K + k0 + c * 8 : 0);
        rt::cp_async16(sx + swz(r, c) * 8, p, in);
      }
    };

    float acc[Ti::kMats][BN / 8][4];
#pragma unroll
    for (int m = 0; m < Ti::kMats; ++m)
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[m][nt][i] = 0.0f;

#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < ksteps) load(s, s);
      rt::cp_async_commit();
    }
    for (int kt = 0; kt < ksteps; ++kt) {
      rt::cp_async_wait<kStages - 2>();
      __syncthreads();                       // stage kt landed; kt - 1 consumed
      const int next = kt + kStages - 1;
      if (next < ksteps) load(next % kStages, next);
      rt::cp_async_commit();

      const bf16* st = sm + (kt % kStages) * Ti::kStage;
      const bf16* sx = st + Ti::kMats * Ti::kW;
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        // A = the weight tile transposed (16 columns of N x 16 of K), from
        // its [k][n] rows: matrices (k 0-7, n 0-7), (k 0-7, n 8-15),
        // (k 8-15, n 0-7), (k 8-15, n 8-15)
        const int q = lane >> 3;
        const int kr = kk * 16 + ((q >> 1) << 3) + (lane & 7);
        const int nc = warp * 2 + (q & 1);
        uint32_t fa[Ti::kMats][4];
        rt::ldsm_x4_trans(fa[0], st + swz(kr, nc) * 8);
        if constexpr (kGated) rt::ldsm_x4_trans(fa[1], st + Ti::kW + swz(kr, nc) * 8);
#pragma unroll
        for (int nt = 0; nt < BN / 8; ++nt) {
          if (nt * 8 < rows) {               // the expert's tokens only
            const int xr = nt * 8 + (lane & 7);
            const int xc = kk * 2 + ((lane >> 3) & 1);
            uint32_t fb[2];
            rt::ldsm_x2(fb, sx + swz(xr, xc) * 8);
#pragma unroll
            for (int m = 0; m < Ti::kMats; ++m) rt::mma_bf16(acc[m][nt], fa[m], fb[0], fb[1]);
          }
        }
      }
    }
    rt::cp_async_wait<0>();

    // accumulator (16 columns of N x 8 tokens): c0, c1 at column gid,
    // tokens 2tq, 2tq + 1; c2, c3 at column gid + 8. Rounded, transposed
    // by movmatrix to a token's 2 adjacent columns a lane, stored.
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      if (nt * 8 < rows) {
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if constexpr (kGated) {
            const float g = round_bf16(acc[0][nt][i]);
            const float u = round_bf16(acc[1][nt][i]);
            const float act = round_bf16(gelu ? rt::gelu_tanh(g) : rt::silu(g));
            v[i] = __fmul_rn(act, u);
          } else {
            v[i] = acc[0][nt][i];
          }
        }
        const uint32_t lo = rt::movmatrix_trans(rt::pack_bf16(v[0], v[1]));
        const uint32_t hi = rt::movmatrix_trans(rt::pack_bf16(v[2], v[3]));
        const int r = nt * 8 + gid;
        const int col = n0 + warp * 16 + 2 * tq;   // N even: col + 1 < N too
        if (r < rows) {
          bf16* dst = out + static_cast<size_t>(base + c0 + r) * N + col;
          if (col < N) *reinterpret_cast<uint32_t*>(dst) = lo;
          if (col + 8 < N) *reinterpret_cast<uint32_t*>(dst + 8) = hi;
        }
      }
    }
    __syncthreads();                         // the ring and s_src free again
  }
}

// The same product in f32 on the CUDA cores: out[list row][n] for the
// expert blockIdx.x's rows, n = 128 * blockIdx.y + the thread; the
// expert's tokens 8 at a time, their K-slices staged 64 deep in shared
// memory, each thread's weight column read once a pass (coalesced across
// the block). Any K and N.
template <bool kGated>
__device__ __forceinline__ void expert_gemm_f32(const float* __restrict__ a,
                                                const int* __restrict__ tok,
                                                const int* __restrict__ counts,
                                                const int* __restrict__ offsets,
                                                const float* __restrict__ w0,
                                                const float* __restrict__ w1,
                                                float* __restrict__ out, int K, int N, int gelu) {
  __shared__ float s_x[kF32Tokens][kBK];
  __shared__ int s_src[kF32Tokens];
  const int e = blockIdx.x;
  const int count = counts[e];
  if (count == 0) return;                     // no weight byte read
  const int base = offsets[e];
  const int tid = threadIdx.x;
  const int n = blockIdx.y * kF32Cols + tid;
  const size_t table = static_cast<size_t>(e) * K * N;
  for (int c0 = 0; c0 < count; c0 += kF32Tokens) {
    const int rows = min(kF32Tokens, count - c0);
    if (tid < kF32Tokens)
      s_src[tid] = tid < rows ? (kGated ? tok[base + c0 + tid] : base + c0 + tid) : -1;
    float acc0[kF32Tokens], acc1[kF32Tokens];
#pragma unroll
    for (int r = 0; r < kF32Tokens; ++r) acc0[r] = acc1[r] = 0.0f;
    for (int k0 = 0; k0 < K; k0 += kBK) {
      __syncthreads();                       // s_src written; s_x consumed
      for (int i = tid; i < kF32Tokens * kBK; i += kF32Cols) {
        const int r = i / kBK, kk = i % kBK;
        const int src = s_src[r];
        s_x[r][kk] = src >= 0 && k0 + kk < K ? a[static_cast<size_t>(src) * K + k0 + kk] : 0.0f;
      }
      __syncthreads();
      if (n < N) {
        const int depth = min(kBK, K - k0);
        for (int kk = 0; kk < depth; ++kk) {
          const size_t g = table + static_cast<size_t>(k0 + kk) * N + n;
          const float wa = w0[g];
          const float wb = kGated ? w1[g] : 0.0f;
#pragma unroll
          for (int r = 0; r < kF32Tokens; ++r) {
            acc0[r] = fmaf(s_x[r][kk], wa, acc0[r]);
            if constexpr (kGated) acc1[r] = fmaf(s_x[r][kk], wb, acc1[r]);
          }
        }
      }
    }
    if (n < N) {
#pragma unroll
      for (int r = 0; r < kF32Tokens; ++r) {
        if (r < rows) {
          float v = acc0[r];
          if constexpr (kGated) v = __fmul_rn(gelu ? rt::gelu_tanh(v) : rt::silu(v), acc1[r]);
          out[static_cast<size_t>(base + c0 + r) * N + n] = v;
        }
      }
    }
  }
}

// bf16 takes the tensor cores at BN token columns a block; f32 the CUDA
// cores (BN unused)
template <typename T, int BN>
__global__ void __launch_bounds__(kThreads)
moe_gate_up_kernel(const T* __restrict__ x, const int* __restrict__ tok,
                   const int* __restrict__ counts, const int* __restrict__ offsets,
                   const T* __restrict__ w_gate, const T* __restrict__ w_up,
                   T* __restrict__ h, int d, int f, int gelu) {
  if constexpr (std::is_same<T, float>::value)
    expert_gemm_f32<true>(x, tok, counts, offsets, w_gate, w_up, h, d, f, gelu);
  else
    expert_gemm<BN, true>(x, tok, counts, offsets, w_gate, w_up, h, d, f, gelu);
}

template <typename T, int BN>
__global__ void __launch_bounds__(kThreads)
moe_down_kernel(const T* __restrict__ h, const int* __restrict__ counts,
                const int* __restrict__ offsets, const T* __restrict__ w_down,
                T* __restrict__ y, int f, int d) {
  if constexpr (std::is_same<T, float>::value)
    expert_gemm_f32<false>(h, nullptr, counts, offsets, w_down, nullptr, y, f, d, 0);
  else
    expert_gemm<BN, false>(h, nullptr, counts, offsets, w_down, nullptr, y, f, d, 0);
}

static_assert(kF32Cols == kThreads, "the f32 products run the bf16 block size");

// ---------------------------------------------------------------------------
// combine
// ---------------------------------------------------------------------------

// Grid (T, column blocks of 8 x 128): a thread's 8 columns of one token
// (bf16: one 16-byte load a pick, d a multiple of 8; f32: one a column).
template <typename T>
__global__ void __launch_bounds__(128)
moe_combine_kernel(const T* __restrict__ y, const int* __restrict__ place,
                   const float* __restrict__ gates, T* __restrict__ out, int k, int d) {
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  const int t = blockIdx.x;
  const int c = (blockIdx.y * blockDim.x + threadIdx.x) * 8;
  if (c >= d) return;
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.0f;
  for (int j = 0; j < k; ++j) {
    const int p = place[t * k + j];
    if (p < 0) continue;
    const float g = gates[t * k + j];
    const T* row = y + static_cast<size_t>(p) * d + c;
    float v[8];
    if constexpr (kBf16) {
      const uint4 raw = *reinterpret_cast<const uint4*>(row);
      const bf16* b = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(b[i]);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = c + i < d ? row[i] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(v[i], g));
  }
  T* o = out + static_cast<size_t>(t) * d + c;
  if constexpr (kBf16) {
    uint4 raw;
    bf16* b = reinterpret_cast<bf16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) b[i] = __float2bfloat16_rn(acc[i]);
    *reinterpret_cast<uint4*>(o) = raw;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (c + i < d) o[i] = acc[i];
  }
}

template <typename T, int BN>
size_t gemm_smem(bool gated) {
  if constexpr (std::is_same<T, float>::value) return 0;   // static arrays only
  else return gated ? Tiles<BN, true>::kBytes : Tiles<BN, false>::kBytes;
}

template <typename T>
int col_tiles(int n) {
  const int tile = std::is_same<T, float>::value ? kF32Cols : kBM;
  return (n + tile - 1) / tile;
}

template <typename T, int BN>
cudaError_t launch_gate_up(const void* x, const void* tok, const void* counts,
                           const void* offsets, const void* w_gate, const void* w_up, void* h,
                           int held, int d, int f, int gelu, cudaStream_t stream) {
  const size_t smem = gemm_smem<T, BN>(true);
  auto kernel = moe_gate_up_kernel<T, BN>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(held, col_tiles<T>(f)), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int*>(tok), static_cast<const int*>(counts),
      static_cast<const int*>(offsets), static_cast<const T*>(w_gate),
      static_cast<const T*>(w_up), static_cast<T*>(h), d, f, gelu);
  return cudaGetLastError();
}

template <typename T, int BN>
cudaError_t launch_down(const void* h, const void* counts, const void* offsets,
                        const void* w_down, void* y, int held, int f, int d,
                        cudaStream_t stream) {
  const size_t smem = gemm_smem<T, BN>(false);
  auto kernel = moe_down_kernel<T, BN>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(held, col_tiles<T>(d)), kThreads, smem, stream>>>(
      static_cast<const T*>(h), static_cast<const int*>(counts),
      static_cast<const int*>(offsets), static_cast<const T*>(w_down), static_cast<T*>(y), f,
      d);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// ids (T, k) int64 with row stride ids_stride; live (T,) bytes or null (all
// live); counts, offsets (held,); tok, place (T * k,), int32.
int moe_lists_launch(const void* ids, int ids_stride, const void* live, int t_rows, int k,
                     long long first, int held, void* counts, void* offsets, void* tok,
                     void* place, void* stream) {
  moe_lists_kernel<<<1, kListThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(ids), ids_stride, static_cast<const uint8_t*>(live), t_rows,
      k, first, held, static_cast<int*>(counts), static_cast<int*>(offsets),
      static_cast<int*>(tok), static_cast<int*>(place));
  return static_cast<int>(cudaGetLastError());
}

// x (T, d); w_gate, w_up (held, d, f); h (T * k, f); dtype 1 = bf16 (bn in
// 8, 16, 32, 64), 0 = f32 (bn unused); gelu 0 = SiLU, 1 = tanh-GELU.
// Returns the cudaError_t, or -1 for a bn or dtype the library lacks.
int moe_gate_up_launch(const void* x, const void* tok, const void* counts, const void* offsets,
                       const void* w_gate, const void* w_up, void* h, int held, int d, int f,
                       int bn, int gelu, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch_gate_up<float, 0>(x, tok, counts, offsets, w_gate, w_up, h, held, d, f, gelu, st);
  else if (dtype != 1)
    return -1;
  else switch (bn) {
    case 8: err = launch_gate_up<bf16, 8>(x, tok, counts, offsets, w_gate, w_up, h, held, d, f, gelu, st); break;
    case 16: err = launch_gate_up<bf16, 16>(x, tok, counts, offsets, w_gate, w_up, h, held, d, f, gelu, st); break;
    case 32: err = launch_gate_up<bf16, 32>(x, tok, counts, offsets, w_gate, w_up, h, held, d, f, gelu, st); break;
    case 64: err = launch_gate_up<bf16, 64>(x, tok, counts, offsets, w_gate, w_up, h, held, d, f, gelu, st); break;
    default: return -1;
  }
  return static_cast<int>(err);
}

// h (T * k, f) in list order; w_down (held, f, d); y (T * k, d).
int moe_down_launch(const void* h, const void* counts, const void* offsets, const void* w_down,
                    void* y, int held, int f, int d, int bn, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch_down<float, 0>(h, counts, offsets, w_down, y, held, f, d, st);
  else if (dtype != 1)
    return -1;
  else switch (bn) {
    case 8: err = launch_down<bf16, 8>(h, counts, offsets, w_down, y, held, f, d, st); break;
    case 16: err = launch_down<bf16, 16>(h, counts, offsets, w_down, y, held, f, d, st); break;
    case 32: err = launch_down<bf16, 32>(h, counts, offsets, w_down, y, held, f, d, st); break;
    case 64: err = launch_down<bf16, 64>(h, counts, offsets, w_down, y, held, f, d, st); break;
    default: return -1;
  }
  return static_cast<int>(err);
}

// y (T * k, d) in list order; place, gates (T, k); out (T, d), of y's type.
int moe_combine_launch(const void* y, const void* place, const void* gates, void* out, int t_rows,
                       int k, int d, int dtype, void* stream) {
  const int groups = (d + 7) / 8;            // a thread's 8 columns
  const dim3 grid(t_rows, (groups + 127) / 128);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    moe_combine_kernel<float><<<grid, 128, 0, st>>>(
        static_cast<const float*>(y), static_cast<const int*>(place),
        static_cast<const float*>(gates), static_cast<float*>(out), k, d);
  else if (dtype == 1)
    moe_combine_kernel<bf16><<<grid, 128, 0, st>>>(
        static_cast<const bf16*>(y), static_cast<const int*>(place),
        static_cast<const float*>(gates), static_cast<bf16*>(out), k, d);
  else
    return -1;
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
