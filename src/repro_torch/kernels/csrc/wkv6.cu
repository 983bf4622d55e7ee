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
// the state read and written once) at 3.35 TB/s; the recurrence's 4*D*D
// f32 operations per (token, head) sit just below that.
//
// Two kernels; the launcher picks one by T alone.
//
// `wkv6_decode_kernel` (T = 1, the decode step): no chunk machinery. One
// block of 256 threads per (b, h) streams the 16 KB state with 16-byte
// loads (a half-warp reads one 256-byte row), forms
// out[e] = sum_d r_d S_de + (sum_d r_d u_d k_d) v_e with warp shuffles and
// one shared-memory pass, and writes S' = w_d S_de + k_d v_e straight out.
//
// `wkv6_chunk_kernel` (T > 1): one block of 8 warps per (b, h, slice of
// E value columns). Column e of out and of S depends only on column e of S
// and of v, so the slices are exact and need no reduction across blocks;
// each block recomputes the chunk's C x C score matrix. E = 32 when
// B*H < 132 (so a 64-head prefill fills 128 SMs), else 64. The block holds
// its (D, E) f32 state slice in shared memory and walks T in chunks of
// C = 64 rows (the TPU kernel's sequential chunk grid axis becomes this
// loop). Per chunk:
//   1. stage r, k, log w (all D columns) and v (the slice) in f32, and the
//      bonus r_c . (u * k_c) by a 16-lane shuffle sum per row, from raw
//      buffers that cp.async filled while the previous chunk was worked on;
//   2. per column, the inclusive cumulative sum of log w down the chunk
//      (8-lane shuffle scans over 8-row segments), then the four decayed
//      operands in registers:
//        r_dec = r e^{cum_prev - ref}, kj = k e^{ref - cum},
//        rs = r e^{cum_prev}, ks = k e^{total - cum},
//      where ref is the cumulative decay at the chunk's midpoint row;
//   3. A[i][j] = r_dec_i . kj_j for j < i < cl, else 0;
//   4. out = rs S + A v + diag v;
//   5. S = e^{total} S + ks^T v.
// Taken relative to ref, no exponent exceeds 32 * max|log w| (52.8 under
// the model's decay clip, e^52.8 < 1e23), so f32 neither overflows nor
// underflows on the pairs j < i that count; the masked pairs' scores (which
// may overflow) are dropped by a select, never multiplied. A ragged last
// chunk is the padding w = 1, r = k = v = 0, which contributes nothing.
//
// The three products run on the tensor cores as 3xTF32: each f32 operand
// is split into a tf32 big part and a tf32 remainder (both truncated), and
// mma.sync.m16n8k8 sums big*small + small*big + big*big in f32, which
// keeps f32 accuracy (single-pass TF32 or bf16 cannot hold the 3e-4
// tolerance at outputs of several hundred). On CUDA cores the products
// were bound by shared-memory wavefronts (a 4 x 4 register tile reads 8
// words per 16 FMAs); a tensor-core fragment is read once per 8-deep step
// and used for a whole 16 x 8 tile. Each warp owns a 16-row tile of every
// product. (C, D) tiles have rows of 68 floats and (rows, E) tiles of
// E + 8, so every fragment load and the per-column scan are free of bank
// conflicts; ks is stored transposed so each product reads its operands in
// the fragment layout.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int kD = 64;                 // head size
constexpr int kC = 64;                 // chunk rows
constexpr int kP = kD + 4;             // row of a full tile: 4 mod 32 banks
constexpr int kTile = kC * kP;         // one staged (C, D) tile, in floats
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kC == kD && kC == 64, "the warp tiles assume C = D = 64");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// four consecutive elements of shared memory as f32 (16- or 8-byte aligned)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// Row of a (rows, E) slice tile: 8 mod 32 banks, so the B fragments read
// along its rows fall in distinct banks.
template <int E>
__host__ __device__ constexpr int slice_stride() { return E + 8; }

// f32 working tiles, then the raw chunk (w f32; r, k, v in T) that cp.async
// brings in while the previous chunk is being worked on
template <typename T, int E>
__host__ __device__ constexpr size_t chunk_smem_bytes() {
  return sizeof(float) * (5 * kTile + 2 * kD * slice_stride<E>() + kC + kD + kC * kD) +
         sizeof(T) * (2 * kC * kD + kC * E);
}

// x = big + small, both tf32 (the low 13 bits masked off, i.e. rounded
// toward zero): the 3xTF32 split. Two integer ANDs and a subtraction, at
// full rate, where cvt.rna.tf32 was measurably slower.
struct Tf32x2 {
  uint32_t big, small;
};
__device__ __forceinline__ Tf32x2 split_tf32(float x) {
  const uint32_t big = __float_as_uint(x) & 0xffffe000u;
  return {big, __float_as_uint(x - __uint_as_float(big)) & 0xffffe000u};
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// c += A B at f32 accuracy from three tf32 products (small terms first):
// A_big B_small + A_small B_big + A_big B_big; A_small B_small (2^-22
// relative) is dropped.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const Tf32x2 (&a)[4],
                                           const Tf32x2 (&b)[2]) {
  mma_tf32(c, a[0].big, a[1].big, a[2].big, a[3].big, b[0].small, b[1].small);
  mma_tf32(c, a[0].small, a[1].small, a[2].small, a[3].small, b[0].big, b[1].big);
  mma_tf32(c, a[0].big, a[1].big, a[2].big, a[3].big, b[0].big, b[1].big);
}

// mma.m16n8k8 tf32 fragments (lane = 4 * g + t): A (16 x 8, row-major
// source X[m][k] with row stride ld) holds X[g][t], X[g+8][t], X[g][t+4],
// X[g+8][t+4]; B (8 x 8) holds B[t][g], B[t+4][g]; the accumulator holds
// rows g (c[0], c[1]) and g + 8 (c[2], c[3]) at columns 2t, 2t + 1.
__device__ __forceinline__ void load_a(Tf32x2 (&a)[4], const float* x, int ld, int g, int t) {
  a[0] = split_tf32(x[g * ld + t]);
  a[1] = split_tf32(x[(g + 8) * ld + t]);
  a[2] = split_tf32(x[g * ld + t + 4]);
  a[3] = split_tf32(x[(g + 8) * ld + t + 4]);
}
// B[k][n] from a k-major source Z[k][n] (row stride ld)
__device__ __forceinline__ void load_b_kn(Tf32x2 (&b)[2], const float* z, int ld, int g,
                                          int t) {
  b[0] = split_tf32(z[t * ld + g]);
  b[1] = split_tf32(z[(t + 4) * ld + g]);
}
// B[k][n] from an n-major source Y[n][k] (row stride ld)
__device__ __forceinline__ void load_b_nk(Tf32x2 (&b)[2], const float* y, int ld, int g,
                                          int t) {
  b[0] = split_tf32(y[g * ld + t]);
  b[1] = split_tf32(y[g * ld + t + 4]);
}

template <typename T, int E>
__global__ void __launch_bounds__(kThreads)
wkv6_chunk_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                  const float* __restrict__ w, const float* __restrict__ u,
                  const float* __restrict__ s0, float* __restrict__ out,
                  float* __restrict__ sT, int t_len, int heads) {
  constexpr int ES = slice_stride<E>();
  constexpr int NSLICE = kD / E;
  constexpr int NT = E / 16;           // phases 4-5: 8-column tiles a warp owns
  extern __shared__ __align__(16) float smem[];
  float* rs = smem;              // r, then r * e^{cum_prev}               [c][d]
  float* kj = rs + kTile;        // k, then k * e^{ref - cum}              [c][d]
  float* rd = kj + kTile;        // r * e^{cum_prev - ref}                 [c][d]
  float* lw = rd + kTile;        // log w, then the C x C scores           [c][d] / [i][j]
  float* ksT = lw + kTile;       // k * e^{total - cum}, transposed         [d][c]
  float* S = ksT + kTile;        // (D, E) state slice                     [d][e]
  float* vs = S + kD * ES;       // (C, E) v slice, zero past the chunk    [c][e]
  float* diag = vs + kC * ES;    // (C,) bonus r_c . (u * k_c)
  float* total = diag + kC;      // (D,) cumulative decay over the chunk
  float* wraw = total + kD;      // the raw chunk, dense (C, D) / (C, E)
  T* rraw = reinterpret_cast<T*>(wraw + kC * kD);
  T* kraw = rraw + kC * kD;
  T* vraw = kraw + kC * kD;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;               // mma fragment coordinates
  const int mt = warp & 3;                             // the warp's 16-row tile
  const int bh = blockIdx.x / NSLICE, e0 = (blockIdx.x % NSLICE) * E;
  const int b = bh / heads, h = bh % heads;
  const size_t step = static_cast<size_t>(heads) * kD;              // t -> t + 1
  const size_t base = (static_cast<size_t>(b) * t_len * heads + h) * kD;
  const size_t state = static_cast<size_t>(bh) * kD * kD;
  const float* uh = u + static_cast<size_t>(h) * kD;

  // The next chunk's r, k, w and v slice come by cp.async into the raw
  // buffers while this chunk is worked on (rows past the end are zeros).
  constexpr int RV = 16 / sizeof(T);                   // elements per 16 bytes
  auto prefetch = [&](int t0) {
    const int cl = min(kC, t_len - t0);
    for (int idx = tid; idx < kC * (kD / RV); idx += kThreads) {
      const int c = idx / (kD / RV), x = (idx % (kD / RV)) * RV;
      const size_t gi = base + static_cast<size_t>(t0 + (c < cl ? c : 0)) * step + x;
      rt::cp_async16(rraw + c * kD + x, r + gi, c < cl);
      rt::cp_async16(kraw + c * kD + x, k + gi, c < cl);
    }
    for (int idx = tid; idx < kC * (kD / 4); idx += kThreads) {
      const int c = idx / (kD / 4), x = (idx % (kD / 4)) * 4;
      rt::cp_async16(wraw + c * kD + x,
                 w + base + static_cast<size_t>(t0 + (c < cl ? c : 0)) * step + x, c < cl);
    }
    for (int idx = tid; idx < kC * (E / RV); idx += kThreads) {
      const int c = idx / (E / RV), x = (idx % (E / RV)) * RV;
      rt::cp_async16(vraw + c * E + x,
                 v + base + static_cast<size_t>(t0 + (c < cl ? c : 0)) * step + e0 + x,
                 c < cl);
    }
    rt::cp_async_commit();
  };
  prefetch(0);

  for (int idx = tid; idx < kD * E; idx += kThreads)
    S[(idx / E) * ES + idx % E] = s0[state + (idx / E) * kD + e0 + idx % E];

  const int qd = tid % (kD / 4);                      // staging: columns 4qd .. 4qd+3
  const float4 u4 = make_float4(uh[4 * qd], uh[4 * qd + 1], uh[4 * qd + 2], uh[4 * qd + 3]);

  for (int t0 = 0; t0 < t_len; t0 += kC) {
    const int cl = min(kC, t_len - t0);
    const int ksteps = (cl + 7) / 8;                   // 8-row k-steps over the chunk
    rt::cp_async_wait<0>();
    __syncthreads();               // the chunk has landed; the last one's readers are done
    // 1. stage in f32 (rows past cl are the padding r = k = v = 0, w = 1):
    //    thread (c, qd) takes columns 4qd .. 4qd + 3 of row c, so every
    //    shared access is 16 (f32) or 8 (bf16) bytes and the bonus of a row
    //    is a 16-lane sum
    {
#pragma unroll
      for (int c = tid / (kD / 4); c < kC; c += kThreads / (kD / 4)) {
        const int x = c * kD + 4 * qd, o = c * kP + 4 * qd;
        const float4 r4 = load4(rraw + x), k4 = load4(kraw + x);
        const float4 w4 = *reinterpret_cast<const float4*>(wraw + x);
        const bool in = c < cl;
        *reinterpret_cast<float4*>(rs + o) = r4;
        *reinterpret_cast<float4*>(kj + o) = k4;
        *reinterpret_cast<float4*>(lw + o) =
            in ? make_float4(logf(fmaxf(w4.x, 1e-38f)), logf(fmaxf(w4.y, 1e-38f)),
                             logf(fmaxf(w4.z, 1e-38f)), logf(fmaxf(w4.w, 1e-38f)))
               : make_float4(0.f, 0.f, 0.f, 0.f);
        float p = r4.x * u4.x * k4.x + r4.y * u4.y * k4.y + r4.z * u4.z * k4.z +
                  r4.w * u4.w * k4.w;
        for (int m = 8; m > 0; m >>= 1) p += __shfl_xor_sync(kFull, p, m);
        if (qd == 0) diag[c] = p;
      }
#pragma unroll
      for (int idx = tid; idx < kC * E / 4; idx += kThreads) {
        const int c = idx / (E / 4), x = (idx % (E / 4)) * 4;
        *reinterpret_cast<float4*>(vs + c * ES + x) = load4(vraw + c * E + x);
      }
    }
    __syncthreads();
    if (t0 + kC < t_len) prefetch(t0 + kC);               // the raw buffers are free

    // 2. per column: the inclusive cumulative sum of log w down the chunk,
    //    then the decayed operands, in place. Lane (q, s) = (lane / 8,
    //    lane % 8) of a warp takes column d0 + q, rows s + 8m (m < 8): an
    //    8-lane shuffle scan per 8-row segment plus the running segment
    //    sum; every shared access is free of bank conflicts.
    {
      const int q = lane >> 3, sl = lane & 7;
      const int mid = (cl - 1) / 2;
#pragma unroll
      for (int pass = 0; pass < kD / (4 * kWarps); ++pass) {
        const int d = warp * (kD / kWarps) + pass * 4 + q;
        float a[8], cum[8], before[8];
        float carry = 0.f;
#pragma unroll
        for (int m = 0; m < 8; ++m) a[m] = lw[(sl + 8 * m) * kP + d];
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          float x = a[m];
#pragma unroll
          for (int o = 1; o < 8; o <<= 1) {
            const float y = __shfl_up_sync(kFull, x, o, 8);
            if (sl >= o) x += y;
          }
          before[m] = carry;
          cum[m] = x + carry;
          carry += __shfl_sync(kFull, x, 7, 8);
        }
        float cm = 0.f;
#pragma unroll
        for (int m = 0; m < 8; ++m)
          if (m == (mid >> 3)) cm = cum[m];
        const float ref = __shfl_sync(kFull, cm, mid & 7, 8);
        const float tot = carry;
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          const float up = __shfl_up_sync(kFull, cum[m], 1, 8);
          const float prev = sl == 0 ? before[m] : up;      // the row above's sum
          const int c = sl + 8 * m, o = c * kP + d;
          const bool in = c < cl;
          const float rr = in ? rs[o] : 0.f, kk = in ? kj[o] : 0.f;
          rd[o] = rr * expf(prev - ref);
          rs[o] = rr * expf(prev);
          kj[o] = kk * expf(ref - cum[m]);
          ksT[d * kP + c] = kk * expf(tot - cum[m]);
        }
        if (sl == 0) total[d] = tot;
      }
    }
    __syncthreads();

    // 3. scores A[i][j] = rd_i . kj_j for j < i < cl, else 0 (into lw's
    //    space); warp: rows 16 mt .. +15, columns 32 (warp / 4) .. +31
    float* att = lw;
    {
      const int n0 = 32 * (warp >> 2);
      float c[4][4] = {};
      if (16 * mt < cl && n0 < 16 * mt + 16) {
#pragma unroll
        for (int ks = 0; ks < kD / 8; ++ks) {
          Tf32x2 fa[4];
          load_a(fa, rd + 16 * mt * kP + 8 * ks, kP, g, t);
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            Tf32x2 fb[2];
            load_b_nk(fb, kj + (n0 + 8 * n) * kP + 8 * ks, kP, g, t);
            mma_3xtf32(c[n], fa, fb);
          }
        }
      }
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 16 * mt + g + 8 * (e >> 1), j = n0 + 8 * n + 2 * t + (e & 1);
          att[i * kP + j] = (j < i && i < cl) ? c[n][e] : 0.f;
        }
    }
    __syncthreads();

    // 4. out[i][e] = rs_i . S[:, e] + sum_{j<i} A[i][j] v[j][e] + diag[i] v[i][e];
    //    warp: rows 16 mt .. +15, columns 8 NT (warp / 4) .. + 8 NT - 1
    const int nc0 = 8 * NT * (warp >> 2);
    if (16 * mt < cl) {
      float c[NT][4] = {};
#pragma unroll
      for (int ks = 0; ks < kD / 8; ++ks) {
        Tf32x2 fa[4];
        load_a(fa, rs + 16 * mt * kP + 8 * ks, kP, g, t);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          Tf32x2 fb[2];
          load_b_kn(fb, S + 8 * ks * ES + nc0 + 8 * n, ES, g, t);
          mma_3xtf32(c[n], fa, fb);
        }
      }
      const int kmax = min(ksteps, 2 * mt + 2);        // A[i][j] = 0 for j >= i
      for (int ks = 0; ks < kmax; ++ks) {
        Tf32x2 fa[4];
        load_a(fa, att + 16 * mt * kP + 8 * ks, kP, g, t);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          Tf32x2 fb[2];
          load_b_kn(fb, vs + 8 * ks * ES + nc0 + 8 * n, ES, g, t);
          mma_3xtf32(c[n], fa, fb);
        }
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i = 16 * mt + g + 8 * hf;
        if (i >= cl) continue;
        const float dg = diag[i];
        float* dst = out + base + static_cast<size_t>(t0 + i) * step + e0;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int col = nc0 + 8 * n + 2 * t;
          *reinterpret_cast<float2*>(dst + col) =
              make_float2(c[n][2 * hf] + dg * vs[i * ES + col],
                          c[n][2 * hf + 1] + dg * vs[i * ES + col + 1]);
        }
      }
    }
    __syncthreads();               // every reader of the old state is done

    // 5. S[d][e] = e^{total[d]} S[d][e] + sum_c ks[c][d] v[c][e]; warp: rows
    //    (keys) 16 mt .. +15, the same columns as in 4
    {
      float c[NT][4] = {};
      for (int ks = 0; ks < ksteps; ++ks) {
        Tf32x2 fa[4];
        load_a(fa, ksT + 16 * mt * kP + 8 * ks, kP, g, t);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          Tf32x2 fb[2];
          load_b_kn(fb, vs + 8 * ks * ES + nc0 + 8 * n, ES, g, t);
          mma_3xtf32(c[n], fa, fb);
        }
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int d = 16 * mt + g + 8 * hf;
        const float decay = expf(total[d]);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          float* sp = S + d * ES + nc0 + 8 * n + 2 * t;
          sp[0] = decay * sp[0] + c[n][2 * hf];
          sp[1] = decay * sp[1] + c[n][2 * hf + 1];
        }
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < kD * E; idx += kThreads)
    sT[state + (idx / E) * kD + e0 + idx % E] = S[(idx / E) * ES + idx % E];
}

// T = 1. Thread (rg, cg) = (tid / 16, tid % 16) owns rows rg + 16i of the
// state at value columns 4cg .. 4cg + 3: a half-warp reads one 256-byte row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
wkv6_decode_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                   const float* __restrict__ w, const float* __restrict__ u,
                   const float* __restrict__ s0, float* __restrict__ out,
                   float* __restrict__ sT, int heads) {
  __shared__ float4 part[kWarps][16];
  __shared__ float bonus[kWarps];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rg = tid / 16, cg = tid % 16;
  const int bh = blockIdx.x, h = bh % heads;
  const size_t x = static_cast<size_t>(bh) * kD;      // (B, 1, H, D) row of (b, h)
  const float4* src = reinterpret_cast<const float4*>(s0 + x * kD);
  float4* dst = reinterpret_cast<float4*>(sT + x * kD);
  const float4 ve = make_float4(to_f32(v[x + 4 * cg]), to_f32(v[x + 4 * cg + 1]),
                                to_f32(v[x + 4 * cg + 2]), to_f32(v[x + 4 * cg + 3]));
  float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
  float bon = 0.f;
#pragma unroll
  for (int i = 0; i < kD / 16; ++i) {
    const int d = rg + 16 * i;
    const float rv = to_f32(r[x + d]), kv = to_f32(k[x + d]), wv = w[x + d];
    const float4 sv = src[d * (kD / 4) + cg];
    o.x += rv * sv.x;
    o.y += rv * sv.y;
    o.z += rv * sv.z;
    o.w += rv * sv.w;
    dst[d * (kD / 4) + cg] = make_float4(wv * sv.x + kv * ve.x, wv * sv.y + kv * ve.y,
                                         wv * sv.z + kv * ve.z, wv * sv.w + kv * ve.w);
    bon += rv * u[static_cast<size_t>(h) * kD + d] * kv;
  }
  // lanes l and l ^ 16 share cg: fold the warp's two row groups
  o.x += __shfl_xor_sync(kFull, o.x, 16);
  o.y += __shfl_xor_sync(kFull, o.y, 16);
  o.z += __shfl_xor_sync(kFull, o.z, 16);
  o.w += __shfl_xor_sync(kFull, o.w, 16);
  bon += __shfl_xor_sync(kFull, bon, 16);
  if (lane < 16) part[warp][lane] = o;
  if (lane == 0) bonus[warp] = bon;
  __syncthreads();
  if (tid < 16) {
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    float bsum = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) {
      sum.x += part[wi][tid].x;
      sum.y += part[wi][tid].y;
      sum.z += part[wi][tid].z;
      sum.w += part[wi][tid].w;
      bsum += bonus[wi];
    }
    reinterpret_cast<float4*>(out + x)[tid] =
        make_float4(sum.x + bsum * ve.x, sum.y + bsum * ve.y, sum.z + bsum * ve.z,
                    sum.w + bsum * ve.w);
  }
}

// Value columns per block of the chunk kernel: enough blocks for the SMs.
inline int slice_columns(int b, int h) { return b * h < 132 ? 32 : 64; }

template <typename T, int E>
cudaError_t launch_chunk(const void* r, const void* k, const void* v, const void* w,
                         const void* u, const void* s0, void* out, void* sT, int b, int t,
                         int h, cudaStream_t stream) {
  constexpr size_t smem = chunk_smem_bytes<T, E>();
  auto kernel = wkv6_chunk_kernel<T, E>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<b * h * (kD / E), kThreads, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(w), static_cast<const float*>(u),
      static_cast<const float*>(s0), static_cast<float*>(out), static_cast<float*>(sT), t, h);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w, const void* u,
                   const void* s0, void* out, void* sT, int b, int t, int h,
                   cudaStream_t stream) {
  if (t == 1) {
    wkv6_decode_kernel<T><<<b * h, kThreads, 0, stream>>>(
        static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const float*>(w), static_cast<const float*>(u),
        static_cast<const float*>(s0), static_cast<float*>(out), static_cast<float*>(sT), h);
    return cudaGetLastError();
  }
  return slice_columns(b, h) == 32
      ? launch_chunk<T, 32>(r, k, v, w, u, s0, out, sT, b, t, h, stream)
      : launch_chunk<T, 64>(r, k, v, w, u, s0, out, sT, b, t, h, stream);
}

}  // namespace

// 1 when T goes to the decode kernel (T = 1), 0 for the chunk kernel.
extern "C" int wkv6_variant(int t) { return t == 1; }

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
