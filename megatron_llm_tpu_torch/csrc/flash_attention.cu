// Flash attention for Hopper (sm_90a): the forward (K4) and the two
// FlashAttention-2 backward kernels (K5: dq, K6: dk and dv), bf16 on the
// tensor cores.
//
// Replaces the Pallas kernels of megatron_llm_tpu/ops/flash_attention.py:
//   K4 `_fwd_kernel` (:262, launched by `_flash_fwd_pallas` at :352),
//   K5 `_bwd_dq_kernel` (:388, launched at :566),
//   K6 `_bwd_dkv_kernel` (:448, launched at :591).
//
// Layout (the TPU kernels' own, `_flash_fwd_pallas` :327-329): q, o, do
// are (BG, R, D) with BG = batch * kv groups and R = s * qpk rows, the
// (position, q head) pairs of a group folded with the head fastest, so
// one K/V tile serves every q head of its group; k, v, dk, dv are
// (BG, T, D); lse and delta are (BG, R) fp32. Row r sits at position
// r / qpk; with `causal` it attends keys 0 .. r / qpk (the mask of
// `_causal_invalid`, cols > rows, for any T), else every key below T.
//
// What each computes, per row, in the TPU kernels' exp2 domain (scores
// pre-scaled by sm_scale * log2(e)):
//   K4: online softmax over key tiles, m and l in fp32, p rounded to bf16
//       before the PV product, o = acc / max(l, 1e-30) and the natural-log
//       lse = m * ln2 + log(max(l, 1e-30));
//   K5: p = exp2(s - lse * log2e), dp = dO . V^T, ds = p * (dp - delta),
//       dq = sm_scale * sum_j bf16(ds_ij) k_j;
//   K6: dv = sum_i bf16(p_ij) dO_i, dk = sm_scale * sum_i bf16(ds_ij) q_i
//       over every folded row (all qpk heads of the group).
// delta = rowsum(dO * O) (with the lse cotangent folded in) is computed by
// the caller, as the JAX package leaves it to XLA.
//
// What bounds them on the H100: operations. At the training shape (s 4096,
// d 128) the causal forward does ~1000 flops per byte it must move, above
// the card's ~295 flops/byte balance point, and the backward ~2.5x the
// forward's flops. So every product runs on the tensor cores as
// mma.sync.m16n8k16 (bf16 in, fp32 accumulate): QK^T and PV in K4; QK^T,
// dO V^T and dS K in K5; K Q^T, V dO^T, P^T dO and dS^T Q in K6. Scores,
// probabilities and gradient tiles stay in registers (the C fragment of
// one product is re-packed as the A fragment of the next); K/V and Q/dO
// tiles are staged in shared memory with rows padded by 16 bytes so that
// fragment loads hit 32 distinct banks; the operand a product needs
// transposed is transposed once per tile inside shared memory.
//
// Design against the TPU grid: the TPU walks (bg, q block, k block) in
// order and carries the softmax state in VMEM scratch. Here one block of 4
// warps owns 64 rows (K4, K5) or 64 keys (K6) and loops over the other
// axis itself, each warp owning 16 rows (or keys) of every tile. A causal
// block computes its own last key tile (K4, K5) or first row tile (K6),
// which replaces the clamped index maps at :345-347 and :549-550. Every
// gradient is written by exactly one block: no atomics, so two runs give
// the same bits. Ragged edges (any R, any T) are zero-filled in shared
// memory and masked; d may be any multiple of 8 up to 256 (tiles are
// padded to 32, 64, 128 or 256 columns). Output columns are split into
// chunks of at most 128 (a grid axis) to bound the accumulators' registers;
// a block of a later chunk recomputes the scores of the first.
//
// The kernels launch on the caller's stream and allocate nothing.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float NEG_INF = -1e30f;  // the TPU kernels' finite mask value
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int NT = 128;  // threads per block: 4 warps

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A operand: the 16x16 tile at p, row-major with leading dimension ld.
__device__ __forceinline__ void load_a(uint32_t* a, const bf16* p, int ld,
                                       int g, int tg) {
  a[0] = ld32(p + g * ld + 2 * tg);
  a[1] = ld32(p + (g + 8) * ld + 2 * tg);
  a[2] = ld32(p + g * ld + 2 * tg + 8);
  a[3] = ld32(p + (g + 8) * ld + 2 * tg + 8);
}

// B operand (16 deep, 8 wide): stored n-major, row n of the tile at p
// holding its 16 k values contiguously.
__device__ __forceinline__ void load_b(uint32_t* b, const bf16* p, int ld,
                                       int g, int tg) {
  b[0] = ld32(p + g * ld + 2 * tg);
  b[1] = ld32(p + g * ld + 2 * tg + 8);
}

// The C fragments of two adjacent 8-wide tiles, rounded to bf16, as the A
// operand of the next product (16 rows x 16 deep).
__device__ __forceinline__ void c_to_a(uint32_t* a, const float* c0,
                                       const float* c1) {
  a[0] = pack(c0[0], c0[1]);
  a[1] = pack(c0[2], c0[3]);
  a[2] = pack(c1[0], c1[1]);
  a[3] = pack(c1[2], c1[3]);
}

// Rows [r0, r0 + nrows) and columns [c0, c0 + ncols) of a (rows, D)
// row-major matrix into dst (leading dimension ldd), zero past either edge.
__device__ __forceinline__ void load_tile(bf16* dst, int ldd, const bf16* src,
                                          int r0, int nrows, int rows, int D,
                                          int c0, int ncols) {
  const int cpr = ncols / 8;
  for (int i = threadIdx.x; i < nrows * cpr; i += NT) {
    const int r = i / cpr, c = (i % cpr) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < rows && c0 + c < D)
      v = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * D + c0 + c);
    *reinterpret_cast<uint4*>(dst + r * ldd + c) = v;
  }
}

// dst[c][r] = src[r][c0 + c] for r < nrows, c < ncols (shared to shared).
__device__ __forceinline__ void transpose_tile(bf16* dst, int ldt,
                                               const bf16* src, int lds,
                                               int nrows, int c0, int ncols) {
  for (int i = threadIdx.x; i < nrows * ncols; i += NT) {
    const int r = i % nrows, c = i / nrows;
    dst[c * ldt + r] = src[r * lds + c0 + c];
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Stores two adjacent fp32 values of row `row` at column `col` (even) as bf16.
__device__ __forceinline__ void store2(bf16* dst, int row, int rows, int col,
                                       int D, float x, float y) {
  if (row < rows && col < D)
    *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)row * D + col) =
        __floats2bfloat162_rn(x, y);
}

// ---------------------------------------------------------------------------
// K4: forward. Grid (ceil(R / 64), BG, D chunks); warp w owns rows
// m0 + 16 w .. m0 + 16 w + 15 of every tile.
// ---------------------------------------------------------------------------

template <int DP, int DC>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int R, int T, int D, int qpk,
                 int causal, float scale_log2) {
  constexpr int BM = 64, BN = 64, LDQ = DP + 8, LDT = BN + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // [BM][LDQ]
  bf16* Ks = Qs + BM * LDQ;                  // [BN][LDQ]
  bf16* Vs = Ks + BN * LDQ;                  // [BN][LDQ], DC columns used
  bf16* Vt = Vs + BN * LDQ;                  // [DC][LDT]

  const int m0 = blockIdx.x * BM, bg = blockIdx.y, c0 = blockIdx.z * DC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const bf16* qb = q + (size_t)bg * R * D;
  const bf16* kb = k + (size_t)bg * T * D;
  const bf16* vb = v + (size_t)bg * T * D;

  load_tile(Qs, LDQ, qb, m0, BM, R, D, 0, DP);
  const int last = min(m0 + BM, R) - 1;
  const int kend = causal ? min(T, last / qpk + 1) : T;
  const int ra = m0 + warp * 16 + g, rb = ra + 8;
  const int pa = ra / qpk, pb = rb / qpk;

  float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;
  float acc[DC / 8][4];
#pragma unroll
  for (int i = 0; i < DC / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int n0 = 0; n0 < kend; n0 += BN) {
    __syncthreads();  // the previous tile is consumed
    load_tile(Ks, LDQ, kb, n0, BN, T, D, 0, DP);
    load_tile(Vs, LDQ, vb, n0, BN, T, D, c0, DC);
    __syncthreads();
    transpose_tile(Vt, LDT, Vs, LDQ, BN, 0, DC);
    __syncthreads();

    float s[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16) {
      uint32_t a[4];
      load_a(a, Qs + warp * 16 * LDQ + kk, LDQ, g, tg);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        uint32_t b[2];
        load_b(b, Ks + j * 8 * LDQ + kk, LDQ, g, tg);
        mma_bf16(s[j], a, b);
      }
    }

    float mx_a = NEG_INF, mx_b = NEG_INF;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n0 + j * 8 + 2 * tg + e;
        const bool ok = col < T;
        s[j][e] = (ok && (!causal || col <= pa)) ? s[j][e] * scale_log2 : NEG_INF;
        s[j][2 + e] = (ok && (!causal || col <= pb)) ? s[j][2 + e] * scale_log2 : NEG_INF;
        mx_a = fmaxf(mx_a, s[j][e]);
        mx_b = fmaxf(mx_b, s[j][2 + e]);
      }
    }
    const float mn_a = fmaxf(m_a, quad_max(mx_a));
    const float mn_b = fmaxf(m_b, quad_max(mx_b));
    const float al_a = exp2f(m_a - mn_a), al_b = exp2f(m_b - mn_b);
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      s[j][0] = exp2f(s[j][0] - mn_a);
      s[j][1] = exp2f(s[j][1] - mn_a);
      s[j][2] = exp2f(s[j][2] - mn_b);
      s[j][3] = exp2f(s[j][3] - mn_b);
      sum_a += s[j][0] + s[j][1];
      sum_b += s[j][2] + s[j][3];
    }
    l_a = al_a * l_a + quad_sum(sum_a);
    l_b = al_b * l_b + quad_sum(sum_b);
    m_a = mn_a;
    m_b = mn_b;
#pragma unroll
    for (int i = 0; i < DC / 8; ++i) {
      acc[i][0] *= al_a; acc[i][1] *= al_a;
      acc[i][2] *= al_b; acc[i][3] *= al_b;
    }
    // O += bf16(P) V
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t a[4];
      c_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int i = 0; i < DC / 8; ++i) {
        uint32_t b[2];
        load_b(b, Vt + i * 8 * LDT + kk * 16, LDT, g, tg);
        mma_bf16(acc[i], a, b);
      }
    }
  }

  const float la = fmaxf(l_a, 1e-30f), lb = fmaxf(l_b, 1e-30f);
  bf16* ob = o + (size_t)bg * R * D;
#pragma unroll
  for (int i = 0; i < DC / 8; ++i) {
    const int col = c0 + i * 8 + 2 * tg;
    store2(ob, ra, R, col, D, acc[i][0] / la, acc[i][1] / la);
    store2(ob, rb, R, col, D, acc[i][2] / lb, acc[i][3] / lb);
  }
  if (blockIdx.z == 0 && tg == 0) {
    if (ra < R) lse[(size_t)bg * R + ra] = m_a * LN2 + logf(la);
    if (rb < R) lse[(size_t)bg * R + rb] = m_b * LN2 + logf(lb);
  }
}

// ---------------------------------------------------------------------------
// K5: dq. Grid (ceil(R / 64), BG, D chunks); warp w owns 16 rows.
// ---------------------------------------------------------------------------

template <int DP, int DC>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int R, int T, int D, int qpk, int causal,
                    float scale_log2, float sm_scale) {
  constexpr int BM = 64, BN = 64, LDQ = DP + 8, LDT = BN + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // [BM][LDQ]
  bf16* dOs = Qs + BM * LDQ;                 // [BM][LDQ]
  bf16* Ks = dOs + BM * LDQ;                 // [BN][LDQ]
  bf16* Vs = Ks + BN * LDQ;                  // [BN][LDQ]
  bf16* Kt = Vs + BN * LDQ;                  // [DC][LDT]

  const int m0 = blockIdx.x * BM, bg = blockIdx.y, c0 = blockIdx.z * DC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const size_t qoff = (size_t)bg * R * D, koff = (size_t)bg * T * D;

  load_tile(Qs, LDQ, q + qoff, m0, BM, R, D, 0, DP);
  load_tile(dOs, LDQ, dout + qoff, m0, BM, R, D, 0, DP);
  const int last = min(m0 + BM, R) - 1;
  const int kend = causal ? min(T, last / qpk + 1) : T;
  const int ra = m0 + warp * 16 + g, rb = ra + 8;
  const int pa = ra / qpk, pb = rb / qpk;
  const float lse_a = ra < R ? lse[(size_t)bg * R + ra] * LOG2E : 0.f;
  const float lse_b = rb < R ? lse[(size_t)bg * R + rb] * LOG2E : 0.f;
  const float dl_a = ra < R ? delta[(size_t)bg * R + ra] : 0.f;
  const float dl_b = rb < R ? delta[(size_t)bg * R + rb] : 0.f;

  float acc[DC / 8][4];
#pragma unroll
  for (int i = 0; i < DC / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int n0 = 0; n0 < kend; n0 += BN) {
    __syncthreads();
    load_tile(Ks, LDQ, k + koff, n0, BN, T, D, 0, DP);
    load_tile(Vs, LDQ, v + koff, n0, BN, T, D, 0, DP);
    __syncthreads();
    transpose_tile(Kt, LDT, Ks, LDQ, BN, c0, DC);
    __syncthreads();

    float s[BN / 8][4], dp[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16) {
      uint32_t aq[4], ad[4];
      load_a(aq, Qs + warp * 16 * LDQ + kk, LDQ, g, tg);
      load_a(ad, dOs + warp * 16 * LDQ + kk, LDQ, g, tg);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        uint32_t b[2];
        load_b(b, Ks + j * 8 * LDQ + kk, LDQ, g, tg);
        mma_bf16(s[j], aq, b);
        load_b(b, Vs + j * 8 * LDQ + kk, LDQ, g, tg);
        mma_bf16(dp[j], ad, b);
      }
    }
    // ds = p * (dp - delta), p = exp2(s - lse * log2e); masked p = 0
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n0 + j * 8 + 2 * tg + e;
        const bool ok = col < T;
        const float p_a = (ok && (!causal || col <= pa))
            ? exp2f(s[j][e] * scale_log2 - lse_a) : 0.f;
        const float p_b = (ok && (!causal || col <= pb))
            ? exp2f(s[j][2 + e] * scale_log2 - lse_b) : 0.f;
        s[j][e] = p_a * (dp[j][e] - dl_a);
        s[j][2 + e] = p_b * (dp[j][2 + e] - dl_b);
      }
    }
    // dq += bf16(ds) K
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t a[4];
      c_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int i = 0; i < DC / 8; ++i) {
        uint32_t b[2];
        load_b(b, Kt + i * 8 * LDT + kk * 16, LDT, g, tg);
        mma_bf16(acc[i], a, b);
      }
    }
  }

  bf16* dqb = dq + qoff;
#pragma unroll
  for (int i = 0; i < DC / 8; ++i) {
    const int col = c0 + i * 8 + 2 * tg;
    store2(dqb, ra, R, col, D, acc[i][0] * sm_scale, acc[i][1] * sm_scale);
    store2(dqb, rb, R, col, D, acc[i][2] * sm_scale, acc[i][3] * sm_scale);
  }
}

// ---------------------------------------------------------------------------
// K6: dk and dv. Grid (ceil(T / 64), BG, D chunks); warp w owns keys
// n0 + 16 w .. n0 + 16 w + 15; the block walks row tiles of 32.
// ---------------------------------------------------------------------------

template <int DP, int DC>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int R, int T, int D, int qpk,
                     int causal, float scale_log2, float sm_scale) {
  constexpr int BN = 64, BM = 32, LDQ = DP + 8, LDB = BM + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);  // [BN][LDQ]
  bf16* Vs = Ks + BN * LDQ;                  // [BN][LDQ]
  bf16* Qs = Vs + BN * LDQ;                  // [BM][LDQ]
  bf16* dOs = Qs + BM * LDQ;                 // [BM][LDQ]
  bf16* Qt = dOs + BM * LDQ;                 // [DC][LDB]
  bf16* dOt = Qt + DC * LDB;                 // [DC][LDB]
  float* lse_s = reinterpret_cast<float*>(dOt + DC * LDB);  // [BM]
  float* dl_s = lse_s + BM;                                  // [BM]

  const int n0 = blockIdx.x * BN, bg = blockIdx.y, c0 = blockIdx.z * DC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const size_t qoff = (size_t)bg * R * D, koff = (size_t)bg * T * D;

  load_tile(Ks, LDQ, k + koff, n0, BN, T, D, 0, DP);
  load_tile(Vs, LDQ, v + koff, n0, BN, T, D, 0, DP);
  const int ka = n0 + warp * 16 + g, kb = ka + 8;
  // the first row that reaches this key tile (rows before it see no key
  // of the tile under the causal mask)
  const int rstart = causal ? ((size_t)n0 * qpk / BM) * BM : 0;

  float dka[DC / 8][4], dva[DC / 8][4];
#pragma unroll
  for (int i = 0; i < DC / 8; ++i) {
    dka[i][0] = dka[i][1] = dka[i][2] = dka[i][3] = 0.f;
    dva[i][0] = dva[i][1] = dva[i][2] = dva[i][3] = 0.f;
  }

  for (int r0 = rstart; r0 < R; r0 += BM) {
    __syncthreads();
    load_tile(Qs, LDQ, q + qoff, r0, BM, R, D, 0, DP);
    load_tile(dOs, LDQ, dout + qoff, r0, BM, R, D, 0, DP);
    for (int i = threadIdx.x; i < BM; i += NT) {
      const bool ok = r0 + i < R;
      lse_s[i] = ok ? lse[(size_t)bg * R + r0 + i] * LOG2E : 0.f;
      dl_s[i] = ok ? delta[(size_t)bg * R + r0 + i] : 0.f;
    }
    __syncthreads();
    transpose_tile(Qt, LDB, Qs, LDQ, BM, c0, DC);
    transpose_tile(dOt, LDB, dOs, LDQ, BM, c0, DC);
    __syncthreads();

    // s^T = K Q^T and dp^T = V dO^T, 16 keys x 32 rows per warp
    float s[BM / 8][4], dp[BM / 8][4];
#pragma unroll
    for (int j = 0; j < BM / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16) {
      uint32_t ak[4], av[4];
      load_a(ak, Ks + warp * 16 * LDQ + kk, LDQ, g, tg);
      load_a(av, Vs + warp * 16 * LDQ + kk, LDQ, g, tg);
#pragma unroll
      for (int j = 0; j < BM / 8; ++j) {
        uint32_t b[2];
        load_b(b, Qs + j * 8 * LDQ + kk, LDQ, g, tg);
        mma_bf16(s[j], ak, b);
        load_b(b, dOs + j * 8 * LDQ + kk, LDQ, g, tg);
        mma_bf16(dp[j], av, b);
      }
    }
    // p^T and ds^T; p masked to 0 past R, past T and above the diagonal
#pragma unroll
    for (int j = 0; j < BM / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ci = j * 8 + 2 * tg + (e & 1);
        const int row = r0 + ci;
        const int key = e < 2 ? ka : kb;
        const bool ok = row < R && key < T && (!causal || key <= row / qpk);
        const float p = ok ? exp2f(s[j][e] * scale_log2 - lse_s[ci]) : 0.f;
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - dl_s[ci]);
      }
    }
    // dv += bf16(p^T) dO, dk += bf16(ds^T) Q
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk) {
      uint32_t ap[4], as[4];
      c_to_a(ap, s[2 * kk], s[2 * kk + 1]);
      c_to_a(as, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int i = 0; i < DC / 8; ++i) {
        uint32_t b[2];
        load_b(b, dOt + i * 8 * LDB + kk * 16, LDB, g, tg);
        mma_bf16(dva[i], ap, b);
        load_b(b, Qt + i * 8 * LDB + kk * 16, LDB, g, tg);
        mma_bf16(dka[i], as, b);
      }
    }
  }

  bf16* dkb = dk + koff;
  bf16* dvb = dv + koff;
#pragma unroll
  for (int i = 0; i < DC / 8; ++i) {
    const int col = c0 + i * 8 + 2 * tg;
    store2(dkb, ka, T, col, D, dka[i][0] * sm_scale, dka[i][1] * sm_scale);
    store2(dkb, kb, T, col, D, dka[i][2] * sm_scale, dka[i][3] * sm_scale);
    store2(dvb, ka, T, col, D, dva[i][0], dva[i][1]);
    store2(dvb, kb, T, col, D, dva[i][2], dva[i][3]);
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

template <int DP>
constexpr int chunk_cols() { return DP < 128 ? DP : 128; }

// Opts a kernel in to `bytes` of dynamic shared memory (above 48 KB).
template <typename K>
int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int DP>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               void* lse, int BG, int R, int T, int D, int qpk, int causal,
               float sm_scale, cudaStream_t s) {
  constexpr int DC = chunk_cols<DP>();
  const size_t smem = sizeof(bf16) * (3 * 64 * (DP + 8) + DC * (64 + 8));
  auto kern = flash_fwd_kernel<DP, DC>;
  // once per instantiation: never inside a CUDA-graph capture after the
  // first (warm-up) launch
  static const int err = set_smem(kern, smem);
  if (err) return err;
  dim3 grid((R + 63) / 64, BG, DP / DC);
  kern<<<grid, NT, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), R, T, D, qpk, causal, sm_scale * LOG2E);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int BG, int R,
              int T, int D, int qpk, int causal, float sm_scale,
              cudaStream_t s) {
  constexpr int DC = chunk_cols<DP>();
  const size_t smem = sizeof(bf16) * (4 * 64 * (DP + 8) + DC * (64 + 8));
  auto kern = flash_bwd_dq_kernel<DP, DC>;
  // once per instantiation: never inside a CUDA-graph capture after the
  // first (warm-up) launch
  static const int err = set_smem(kern, smem);
  if (err) return err;
  dim3 grid((R + 63) / 64, BG, DP / DC);
  kern<<<grid, NT, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), R, T, D, qpk, causal, sm_scale * LOG2E,
      sm_scale);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int BG,
               int R, int T, int D, int qpk, int causal, float sm_scale,
               cudaStream_t s) {
  constexpr int DC = chunk_cols<DP>();
  const size_t smem = sizeof(bf16) * (2 * 64 * (DP + 8) + 2 * 32 * (DP + 8)
                                      + 2 * DC * (32 + 8))
                      + sizeof(float) * 2 * 32;
  auto kern = flash_bwd_dkv_kernel<DP, DC>;
  // once per instantiation: never inside a CUDA-graph capture after the
  // first (warm-up) launch
  static const int err = set_smem(kern, smem);
  if (err) return err;
  dim3 grid((T + 63) / 64, BG, DP / DC);
  kern<<<grid, NT, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), R, T, D, qpk, causal,
      sm_scale * LOG2E, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o, dout, dq: (BG, R, D) bf16; k, v, dk, dv: (BG, T, D) bf16; lse,
// delta: (BG, R) fp32; all contiguous and 16-byte aligned. R = s * qpk.
// The wrapper checks 8 <= D <= 256, D % 8 == 0, qpk >= 1. Each returns the
// cudaError_t of its launch.

#define FLASH_DISPATCH(FN, ...)                          \
  if (D <= 32) return FN<32>(__VA_ARGS__);               \
  if (D <= 64) return FN<64>(__VA_ARGS__);               \
  if (D <= 128) return FN<128>(__VA_ARGS__);             \
  return FN<256>(__VA_ARGS__);

extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse, int BG,
                                   int R, int T, int D, int qpk, int causal,
                                   float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(launch_fwd, q, k, v, o, lse, BG, R, T, D, qpk, causal,
                 sm_scale, s)
}

extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dq, int BG, int R, int T, int D,
                                      int qpk, int causal, float sm_scale,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(launch_dq, q, k, v, dout, lse, delta, dq, BG, R, T, D, qpk,
                 causal, sm_scale, s)
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv, int BG, int R,
                                       int T, int D, int qpk, int causal,
                                       float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(launch_dkv, q, k, v, dout, lse, delta, dk, dv, BG, R, T, D,
                 qpk, causal, sm_scale, s)
}
