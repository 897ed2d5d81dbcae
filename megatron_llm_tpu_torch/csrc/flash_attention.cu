// Flash attention for Hopper (sm_90a): the forward (K4) and the two
// FlashAttention-2 backward kernels (K5: dq, K6: dk and dv), bf16 or fp16
// on the tensor cores.
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
//   K4: online softmax over key tiles, m and l in fp32, p rounded to the
//       element type E before the PV product, o = acc / max(l, 1e-30) and
//       the natural-log lse = m * ln2 + log(max(l, 1e-30));
//   K5: p = exp2(s - lse * log2e), dp = dO . V^T, ds = p * (dp - delta),
//       dq = sm_scale * sum_j E(ds_ij) k_j;
//   K6: dv = sum_i E(p_ij) dO_i, dk = sm_scale * sum_i E(ds_ij) q_i
//       over every folded row (all qpk heads of the group).
// E is q's type, bf16 or fp16, as the Pallas kernels take q's dtype: each
// kernel is instantiated for both, the same code with the products'
// operand type, the rounding of P and dS and the tensor maps' data type
// following E (csrc/hopper.cuh). In fp16 a dS or an output past 65504
// rounds to inf, as in the reference: the loss scaler sees it and skips
// the step; nothing clamps.
// delta = rowsum(dO * O) (with the lse cotangent folded in) is computed by
// the caller, as the JAX package leaves it to XLA.
//
// What bounds them on the H100: operations. At the training shape (s 4096,
// d 128, causal) K4 does 4 and K6 8 flops a (row, key, d column) on ~1000
// flops per byte moved, far above the card's ~295 flops/byte balance
// point: 0.139 and 0.278 ms at 989 TFLOP/s. So the design is about
// keeping the tensor cores fed.
//
// All three are warp-specialised: warpgroup 0 is
// the producer, whose elected thread 0 issues every load as TMA
// (`cp.async.bulk.tensor`, tensor maps built on the host) into
// 128-byte-swizzled shared memory, completing on mbarriers; TMA's zero
// fill past the edges replaces masking loads and pads d to 64, 128 or 256.
// The other warpgroups are consumers (setmaxnreg moves registers from the
// producer to them) and issue every product as `wgmma.mma_async`:
//   K4: a block owns 128 folded rows, two consumer warpgroups of 64; key
//       tiles of 128 (64 at d 256) stream through a 2-stage ring. S = Q K^T
//       with both operands from shared memory, K-major; the online softmax
//       runs on the accumulator in registers; O += P V with A = bf16(P)
//       re-packed from the accumulator into registers and B = V from
//       shared memory MN-major (the transpose bit of a 16-bit wgmma).
//   K5: a block owns 128 folded rows (64 at d 256), one consumer warpgroup
//       per 64, with Q, dO, lse and delta loaded once; key tiles of 64 (K
//       and V) stream through a 2-stage ring. S = Q K^T and dP = dO V^T
//       from shared memory, K-major, in two commit groups: P is computed
//       while dP's product runs; dS = P (dP - delta) is re-packed from the
//       accumulator to bf16 registers and dQ += dS K reads K MN-major from
//       the same stage (the transpose bit), so K lands in shared memory
//       once and is never transposed there.
//   K6: a block owns 128 keys (64 at d 256), one consumer warpgroup per 64,
//       with K and V loaded once; row tiles of 64 (Q, dO, lse, delta)
//       stream through a 2-stage ring. S^T = K Q^T and dP^T = V dO^T from
//       shared memory, K-major; P^T and dS^T in registers; dV += P^T dO and
//       dK += dS^T Q with A from registers and B = dO, Q MN-major. Each
//       product is a commit group waited for only when its result is
//       needed: P^T is computed while dP^T runs, dS^T while dV's runs.
// A 3- or 4-stage ring, and ping-pong ordering of the two consumer
// warpgroups' products with named barriers, measured no faster for K4 and
// K6 on the H100 (PERF.md): what bounds them now is each warpgroup's
// serial issue, wait, softmax (ex2 on the SFU), issue, wait per tile. K5
// has the same shape, with three products a tile where K6 has four: its
// S and dP accumulators (32 registers each at 64 keys) and dQ's (64) fit
// the 240 registers setmaxnreg gives a consumer; 128-key tiles would not.
// No operand is transposed in shared memory. Causal blocks never load the
// tiles above the diagonal; a warp masks only tiles that straddle its
// diagonal or the ragged edge (the TPU kernel's `split_diag`, JAX
// :281-300), the rest run a maskless branch. Blocks are launched heaviest
// first (K4, K5: the last row blocks; K6: the first key blocks) so the
// causal triangle leaves no tail of idle SMs. Output columns are split into chunks of 128 (a
// grid axis) at d 256 to bound the accumulators.
//
// Every output element is written by exactly one block, from registers:
// no atomics, so two runs give the same bits. The kernels launch on the
// caller's stream and allocate nothing.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr float NEG_INF = -1e30f;  // the TPU kernels' finite mask value
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int ST = 2;  // stages of the TMA ring

using hopper::align1024;
using hopper::c_to_a;
using hopper::k_slice;
using hopper::mma_rs;
using hopper::mma_ss;
using hopper::quad_max;
using hopper::quad_sum;

// Stores two adjacent fp32 values of row `row` at column `col` (even) as E.
template <typename E>
__device__ __forceinline__ void store2(E* dst, int row, int rows, int col,
                                       int D, float x, float y) {
  if (row < rows && col < D)
    *reinterpret_cast<uint32_t*>(dst + (size_t)row * D + col) =
        hopper::pack<E>(x, y);
}

// ---------------------------------------------------------------------------
// K4: forward. Grid (row blocks * BG, D chunks), heaviest row blocks first;
// 384 threads: the producer warpgroup, then two consumers of 64 rows each.
// ---------------------------------------------------------------------------

template <int DP_, int BN_, int DC_>
struct FwdLayout {
  static constexpr int DP = DP_, BN = BN_, DC = DC_, BM = 128;
  static constexpr uint32_t Q_BYTES = BM * DP * 2;  // DP / 64 panels
  static constexpr uint32_t K_BYTES = BN * DP * 2;
  static constexpr uint32_t V_BYTES = BN * DC * 2;  // this block's columns
  static constexpr uint32_t STAGE_BYTES = K_BYTES + V_BYTES;
  static constexpr size_t SMEM = 1024 + Q_BYTES + ST * STAGE_BYTES
                                 + 8 * (1 + 2 * ST);
};

template <typename E, int DP, int BN, int DC>
__global__ void __launch_bounds__(384, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 E* __restrict__ o, float* __restrict__ lse, int BG,
                 int R, int T, int D, int qpk, int causal, float scale_log2) {
  using L = FwdLayout<DP, BN, DC>;
  constexpr int BM = L::BM;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  E* Qs = reinterpret_cast<E*>(smem);
  unsigned char* ring = smem + L::Q_BYTES;
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(ring + ST * L::STAGE_BYTES);
  uint64_t* full = q_bar + 1;
  uint64_t* empty = full + ST;

  const int nm = (R + BM - 1) / BM;
  const int mb = causal ? nm - 1 - (int)(blockIdx.x / BG) : blockIdx.x / BG;
  const int bg = blockIdx.x % BG;
  const int m0 = mb * BM, c0 = blockIdx.y * DC;
  const int last = min(m0 + BM, R) - 1;
  const int kend = causal ? min(T, last / qpk + 1) : T;
  const int ntiles = (kend + BN - 1) / BN;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_bar, 1);
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 256);  // every consumer thread
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: thread 0 issues every load, the rest of the warpgroup
    // hands its registers to the consumers and leaves
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      hopper::mbar_expect_tx(q_bar, L::Q_BYTES);
      for (int p = 0; p < DP / 64; ++p)
        hopper::tma_load_3d(Qs + p * BM * 64, &tq, q_bar, 64 * p, m0, bg);
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % ST, n = i / ST;
        if (n > 0) hopper::mbar_wait(&empty[s], (n - 1) & 1);
        E* Ks = reinterpret_cast<E*>(ring + s * L::STAGE_BYTES);
        E* Vs = Ks + BN * DP;
        hopper::mbar_expect_tx(&full[s], L::STAGE_BYTES);
        for (int p = 0; p < DP / 64; ++p)
          hopper::tma_load_3d(Ks + p * BN * 64, &tk, &full[s], 64 * p,
                              i * BN, bg);
        for (int p = 0; p < DC / 64; ++p)
          hopper::tma_load_3d(Vs + p * BN * 64, &tv, &full[s], c0 + 64 * p,
                              i * BN, bg);
      }
    }
  } else {
    hopper::setmaxnreg_inc<240>();
    const int cw = threadIdx.x / 128 - 1, t = threadIdx.x & 127;
    const int warp = t >> 5, lane = t & 31, g = lane >> 2, tg = lane & 3;
    const int w0 = m0 + cw * 64;  // this warpgroup's first row
    const int ra = w0 + warp * 16 + g, rb = ra + 8;
    const int pa = ra / qpk, pb = rb / qpk;
    // key tiles this warpgroup's rows reach (the block's other warpgroup
    // may reach one more)
    const int wtiles =
        w0 >= R ? 0
                : causal ? (min(T, min(w0 + 63, R - 1) / qpk + 1) + BN - 1) / BN
                         : ntiles;
    // keys below `clean` are visible to every row of this warp
    const int clean = causal ? min(T, (w0 + warp * 16) / qpk + 1) : T;
    const E* Qw = Qs + cw * 64 * 64;

    float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;
    float acc[DC / 2];
#pragma unroll
    for (int i = 0; i < DC / 2; ++i) acc[i] = 0.f;

    hopper::mbar_wait(q_bar, 0);
    for (int i = 0; i < ntiles; ++i) {
      const int s = i % ST;
      hopper::mbar_wait(&full[s], (i / ST) & 1);
      if (i < wtiles) {
        const E* Ks = reinterpret_cast<const E*>(ring + s * L::STAGE_BYTES);
        const E* Vs = Ks + BN * DP;
        // S = Q K^T
        float sc[BN / 2];
#pragma unroll
        for (int j = 0; j < BN / 2; ++j) sc[j] = 0.f;
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          mma_ss<BN, E>(sc, k_slice(Qw, BM, kk), k_slice(Ks, BN, kk));
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs<BN / 2>(sc);

        const int n0 = i * BN;
        float mx_a = NEG_INF, mx_b = NEG_INF;
        if (n0 + BN <= clean) {
#pragma unroll
          for (int j = 0; j < BN / 2; j += 4) {
            sc[j] *= scale_log2; sc[j + 1] *= scale_log2;
            sc[j + 2] *= scale_log2; sc[j + 3] *= scale_log2;
            mx_a = fmaxf(mx_a, fmaxf(sc[j], sc[j + 1]));
            mx_b = fmaxf(mx_b, fmaxf(sc[j + 2], sc[j + 3]));
          }
        } else {  // the diagonal or the ragged end of T
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = n0 + j * 8 + 2 * tg + e;
              const bool ok = col < T;
              float& xa = sc[4 * j + e];
              float& xb = sc[4 * j + 2 + e];
              xa = (ok && (!causal || col <= pa)) ? xa * scale_log2 : NEG_INF;
              xb = (ok && (!causal || col <= pb)) ? xb * scale_log2 : NEG_INF;
              mx_a = fmaxf(mx_a, xa);
              mx_b = fmaxf(mx_b, xb);
            }
          }
        }
        const float mn_a = fmaxf(m_a, quad_max(mx_a));
        const float mn_b = fmaxf(m_b, quad_max(mx_b));
        const float al_a = exp2f(m_a - mn_a), al_b = exp2f(m_b - mn_b);
        float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
        for (int j = 0; j < BN / 2; j += 4) {
          sc[j] = exp2f(sc[j] - mn_a);
          sc[j + 1] = exp2f(sc[j + 1] - mn_a);
          sc[j + 2] = exp2f(sc[j + 2] - mn_b);
          sc[j + 3] = exp2f(sc[j + 3] - mn_b);
          sum_a += sc[j] + sc[j + 1];
          sum_b += sc[j + 2] + sc[j + 3];
        }
        l_a = al_a * l_a + quad_sum(sum_a);
        l_b = al_b * l_b + quad_sum(sum_b);
        m_a = mn_a;
        m_b = mn_b;
#pragma unroll
        for (int j = 0; j < DC / 2; j += 4) {
          acc[j] *= al_a; acc[j + 1] *= al_a;
          acc[j + 2] *= al_b; acc[j + 3] *= al_b;
        }
        // O += bf16(P) V
        uint32_t pf[BN / 16][4];
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          c_to_a<E>(pf[kk], sc + 8 * kk, sc + 8 * kk + 4);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          mma_rs<DC>(acc, pf[kk], Vs + kk * 16 * 64, BN * 128);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs<DC / 2>(acc);
      }
      hopper::mbar_arrive(&empty[s]);
    }

    const float la = fmaxf(l_a, 1e-30f), lb = fmaxf(l_b, 1e-30f);
    E* ob = o + (size_t)bg * R * D;
#pragma unroll
    for (int i = 0; i < DC / 8; ++i) {
      const int col = c0 + i * 8 + 2 * tg;
      store2(ob, ra, R, col, D, acc[4 * i] / la, acc[4 * i + 1] / la);
      store2(ob, rb, R, col, D, acc[4 * i + 2] / lb, acc[4 * i + 3] / lb);
    }
    if (blockIdx.y == 0 && tg == 0) {
      if (ra < R) lse[(size_t)bg * R + ra] = m_a * LN2 + logf(la);
      if (rb < R) lse[(size_t)bg * R + rb] = m_b * LN2 + logf(lb);
    }
  }
}

// ---------------------------------------------------------------------------
// K5: dq. Grid (row blocks * BG, D chunks), heaviest row blocks first; the
// producer warpgroup, then NWG consumers of 64 rows each; the block walks
// key tiles of 64.
// ---------------------------------------------------------------------------

template <int DP_, int NWG_, int DC_>
struct DqLayout {
  static constexpr int DP = DP_, NWG = NWG_, DC = DC_, BM = 64 * NWG, BN = 64;
  static constexpr uint32_t ROW_BYTES = BM * DP * 2;  // Q, then dO
  static constexpr uint32_t TILE_BYTES = BN * DP * 2;  // K, then V
  static constexpr uint32_t STAGE_BYTES = 2 * TILE_BYTES;
  static constexpr uint32_t VEC_BYTES = 2 * BM * 4;  // lse, then delta
  static constexpr size_t SMEM = 1024 + 2 * ROW_BYTES + ST * STAGE_BYTES
                                 + VEC_BYTES + 8 * (1 + 2 * ST);
};

template <typename E, int DP, int NWG, int DC>
__global__ void __launch_bounds__(128 * (NWG + 1), 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tlse,
                    const __grid_constant__ CUtensorMap tdelta,
                    E* __restrict__ dq, int BG, int R, int T, int D,
                    int qpk, int causal, float scale_log2, float sm_scale) {
  using L = DqLayout<DP, NWG, DC>;
  constexpr int BM = L::BM, BN = L::BN;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  E* Qs = reinterpret_cast<E*>(smem);
  E* dOs = Qs + BM * DP;
  unsigned char* ring = smem + 2 * L::ROW_BYTES;
  float* vec = reinterpret_cast<float*>(ring + ST * L::STAGE_BYTES);
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(vec + 2 * BM);
  uint64_t* full = q_bar + 1;
  uint64_t* empty = full + ST;

  const int nm = (R + BM - 1) / BM;
  const int mb = causal ? nm - 1 - (int)(blockIdx.x / BG) : blockIdx.x / BG;
  const int bg = blockIdx.x % BG;
  const int m0 = mb * BM, c0 = blockIdx.y * DC;
  const int last = min(m0 + BM, R) - 1;
  const int kend = causal ? min(T, last / qpk + 1) : T;
  const int ntiles = (kend + BN - 1) / BN;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_bar, 1);
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 128 * NWG);  // every consumer thread
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: thread 0 issues every load
    if constexpr (NWG == 2) hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      hopper::mbar_expect_tx(q_bar, 2 * L::ROW_BYTES + L::VEC_BYTES);
      for (int p = 0; p < DP / 64; ++p) {
        hopper::tma_load_3d(Qs + p * BM * 64, &tq, q_bar, 64 * p, m0, bg);
        hopper::tma_load_3d(dOs + p * BM * 64, &tdo, q_bar, 64 * p, m0, bg);
      }
      hopper::tma_load_2d(vec, &tlse, q_bar, m0, bg);
      hopper::tma_load_2d(vec + BM, &tdelta, q_bar, m0, bg);
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % ST, n = i / ST;
        if (n > 0) hopper::mbar_wait(&empty[s], (n - 1) & 1);
        E* Ks = reinterpret_cast<E*>(ring + s * L::STAGE_BYTES);
        E* Vs = Ks + BN * DP;
        hopper::mbar_expect_tx(&full[s], L::STAGE_BYTES);
        for (int p = 0; p < DP / 64; ++p) {
          hopper::tma_load_3d(Ks + p * BN * 64, &tk, &full[s], 64 * p,
                              i * BN, bg);
          hopper::tma_load_3d(Vs + p * BN * 64, &tv, &full[s], 64 * p,
                              i * BN, bg);
        }
      }
    }
  } else {
    if constexpr (NWG == 2) hopper::setmaxnreg_inc<240>();
    const int cw = threadIdx.x / 128 - 1, t = threadIdx.x & 127;
    const int warp = t >> 5, lane = t & 31, g = lane >> 2, tg = lane & 3;
    const int w0 = m0 + cw * 64;  // this warpgroup's first row
    const int ra = w0 + warp * 16 + g, rb = ra + 8;
    const int pa = ra / qpk, pb = rb / qpk;
    // key tiles this warpgroup's rows reach (the block's other warpgroup
    // may reach more)
    const int wtiles =
        w0 >= R ? 0
                : causal ? (min(T, min(w0 + 63, R - 1) / qpk + 1) + BN - 1) / BN
                         : ntiles;
    // keys below `clean` are visible to every row of this warp
    const int clean = causal ? min(T, (w0 + warp * 16) / qpk + 1) : T;
    const E* Qw = Qs + cw * 64 * 64;
    const E* dOw = dOs + cw * 64 * 64;

    float acc[DC / 2];
#pragma unroll
    for (int i = 0; i < DC / 2; ++i) acc[i] = 0.f;

    hopper::mbar_wait(q_bar, 0);
    // rows past R read TMA's zero fill; their dq is never stored
    const float lse_a = vec[ra - m0] * LOG2E, lse_b = vec[rb - m0] * LOG2E;
    const float dl_a = vec[BM + ra - m0], dl_b = vec[BM + rb - m0];
    for (int i = 0; i < ntiles; ++i) {
      const int s = i % ST;
      hopper::mbar_wait(&full[s], (i / ST) & 1);
      if (i < wtiles) {
        const E* Ks = reinterpret_cast<const E*>(ring + s * L::STAGE_BYTES);
        const E* Vs = Ks + BN * DP;
        // S = Q K^T and dP = dO V^T, 64 rows x 64 keys, in two groups: P is
        // computed while dP's product runs
        float sc[32], dp[32];
#pragma unroll
        for (int j = 0; j < 32; ++j) sc[j] = dp[j] = 0.f;
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          mma_ss<64, E>(sc, k_slice(Qw, BM, kk), k_slice(Ks, BN, kk));
        hopper::wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          mma_ss<64, E>(dp, k_slice(dOw, BM, kk), k_slice(Vs, BN, kk));
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();
        hopper::fence_regs<32>(sc);

        // p = exp2(s - lse log2e); 0 above the diagonal and past T, which
        // only tiles straddling this warp's diagonal or T can hold
        const int n0 = i * BN;
        if (n0 + BN <= clean) {
#pragma unroll
          for (int j = 0; j < 32; j += 4) {
            sc[j] = exp2f(sc[j] * scale_log2 - lse_a);
            sc[j + 1] = exp2f(sc[j + 1] * scale_log2 - lse_a);
            sc[j + 2] = exp2f(sc[j + 2] * scale_log2 - lse_b);
            sc[j + 3] = exp2f(sc[j + 3] * scale_log2 - lse_b);
          }
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = n0 + j * 8 + 2 * tg + e;
              const bool ok = col < T;
              float& xa = sc[4 * j + e];
              float& xb = sc[4 * j + 2 + e];
              xa = (ok && (!causal || col <= pa))
                  ? exp2f(xa * scale_log2 - lse_a) : 0.f;
              xb = (ok && (!causal || col <= pb))
                  ? exp2f(xb * scale_log2 - lse_b) : 0.f;
            }
          }
        }
        hopper::wgmma_wait<0>();
        hopper::fence_regs<32>(dp);
        // dS = P (dP - delta), rounded to bf16 as the A of dQ += dS K
#pragma unroll
        for (int j = 0; j < 32; j += 4) {
          dp[j] = sc[j] * (dp[j] - dl_a);
          dp[j + 1] = sc[j + 1] * (dp[j + 1] - dl_a);
          dp[j + 2] = sc[j + 2] * (dp[j + 2] - dl_b);
          dp[j + 3] = sc[j + 3] * (dp[j + 3] - dl_b);
        }
        uint32_t as[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          c_to_a<E>(as[kk], dp + 8 * kk, dp + 8 * kk + 4);
        const E* Kc = Ks + (c0 / 64) * BN * 64;  // this block's columns
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          mma_rs<DC>(acc, as[kk], Kc + kk * 16 * 64, BN * 128);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs<DC / 2>(acc);
      }
      hopper::mbar_arrive(&empty[s]);
    }

    E* dqb = dq + (size_t)bg * R * D;
#pragma unroll
    for (int i = 0; i < DC / 8; ++i) {
      const int col = c0 + i * 8 + 2 * tg;
      store2(dqb, ra, R, col, D, acc[4 * i] * sm_scale,
             acc[4 * i + 1] * sm_scale);
      store2(dqb, rb, R, col, D, acc[4 * i + 2] * sm_scale,
             acc[4 * i + 3] * sm_scale);
    }
  }
}

// ---------------------------------------------------------------------------
// K6: dk and dv. Grid (key blocks * BG, D chunks), the key blocks with the
// most rows first; the producer warpgroup, then NWG consumers of 64 keys
// each; the block walks row tiles of 64.
// ---------------------------------------------------------------------------

template <int DP_, int NWG_, int DC_>
struct DkvLayout {
  static constexpr int DP = DP_, NWG = NWG_, DC = DC_, BN = 64 * NWG, BM = 64;
  static constexpr uint32_t KV_BYTES = BN * DP * 2;  // K, then V
  static constexpr uint32_t ROW_BYTES = BM * DP * 2;  // Q, then dO
  static constexpr uint32_t STAGE_BYTES = 2 * ROW_BYTES;
  static constexpr uint32_t VEC_BYTES = 2 * BM * 4;  // lse, then delta
  static constexpr size_t SMEM = 1024 + 2 * KV_BYTES + ST * STAGE_BYTES
                                 + ST * VEC_BYTES + 8 * (1 + 2 * ST);
};

template <typename E, int DP, int NWG, int DC>
__global__ void __launch_bounds__(128 * (NWG + 1), 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo,
                     const __grid_constant__ CUtensorMap tlse,
                     const __grid_constant__ CUtensorMap tdelta,
                     E* __restrict__ dk, E* __restrict__ dv, int BG,
                     int R, int T, int D, int qpk, int causal,
                     float scale_log2, float sm_scale) {
  using L = DkvLayout<DP, NWG, DC>;
  constexpr int BN = L::BN, BM = L::BM;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  E* Ks = reinterpret_cast<E*>(smem);
  E* Vs = Ks + BN * DP;
  unsigned char* ring = smem + 2 * L::KV_BYTES;
  float* vecs = reinterpret_cast<float*>(ring + ST * L::STAGE_BYTES);
  uint64_t* kv_bar = reinterpret_cast<uint64_t*>(vecs + ST * 2 * BM);
  uint64_t* full = kv_bar + 1;
  uint64_t* empty = full + ST;

  const int n0 = (blockIdx.x / BG) * BN, bg = blockIdx.x % BG;
  const int c0 = blockIdx.y * DC;
  // the first row tile that reaches this key block (rows before it see
  // none of its keys under the causal mask)
  const int rstart = causal ? (int)(((long long)n0 * qpk / BM) * BM) : 0;
  const int ntiles = max(0, (R - rstart + BM - 1) / BM);

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_bar, 1);
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 128 * NWG);  // every consumer thread
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: thread 0 issues every load
    if constexpr (NWG == 2) hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      hopper::mbar_expect_tx(kv_bar, 2 * L::KV_BYTES);
      for (int p = 0; p < DP / 64; ++p) {
        hopper::tma_load_3d(Ks + p * BN * 64, &tk, kv_bar, 64 * p, n0, bg);
        hopper::tma_load_3d(Vs + p * BN * 64, &tv, kv_bar, 64 * p, n0, bg);
      }
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % ST, n = i / ST, r0 = rstart + i * BM;
        if (n > 0) hopper::mbar_wait(&empty[s], (n - 1) & 1);
        E* Qs = reinterpret_cast<E*>(ring + s * L::STAGE_BYTES);
        E* dOs = Qs + BM * DP;
        float* vec = vecs + s * 2 * BM;
        hopper::mbar_expect_tx(&full[s], L::STAGE_BYTES + L::VEC_BYTES);
        for (int p = 0; p < DP / 64; ++p) {
          hopper::tma_load_3d(Qs + p * BM * 64, &tq, &full[s], 64 * p, r0, bg);
          hopper::tma_load_3d(dOs + p * BM * 64, &tdo, &full[s], 64 * p, r0,
                              bg);
        }
        hopper::tma_load_2d(vec, &tlse, &full[s], r0, bg);
        hopper::tma_load_2d(vec + BM, &tdelta, &full[s], r0, bg);
      }
    }
  } else {
    if constexpr (NWG == 2) hopper::setmaxnreg_inc<240>();
    const int cw = threadIdx.x / 128 - 1, t = threadIdx.x & 127;
    const int warp = t >> 5, lane = t & 31, g = lane >> 2, tg = lane & 3;
    const int kw0 = n0 + cw * 64;  // this warpgroup's first key
    const int ka = kw0 + warp * 16 + g, kb = ka + 8;
    const int kwarp_last = kw0 + warp * 16 + 15;
    const E* Kw = Ks + cw * 64 * 64;
    const E* Vw = Vs + cw * 64 * 64;

    float dka[DC / 2], dva[DC / 2];
#pragma unroll
    for (int i = 0; i < DC / 2; ++i) dka[i] = dva[i] = 0.f;

    hopper::mbar_wait(kv_bar, 0);
    for (int i = 0; i < ntiles; ++i) {
      const int s = i % ST, r0 = rstart + i * BM;
      hopper::mbar_wait(&full[s], (i / ST) & 1);
      // tiles whose rows see none of this warpgroup's keys are skipped
      const bool live = kw0 < T
          && (!causal || kw0 <= min(r0 + BM - 1, R - 1) / qpk);
      if (live) {
        const E* Qs = reinterpret_cast<const E*>(ring + s * L::STAGE_BYTES);
        const E* dOs = Qs + BM * DP;
        const float* lse_s = vecs + s * 2 * BM;
        const float* dl_s = lse_s + BM;
        // S^T = K Q^T and dP^T = V dO^T, 64 keys x 64 rows, in two groups,
        // each waited for only when its result is needed: P^T is computed
        // while dP^T runs, dS^T while dV's product runs
        float st[32], dpt[32];
#pragma unroll
        for (int j = 0; j < 32; ++j) st[j] = dpt[j] = 0.f;
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          mma_ss<64, E>(st, k_slice(Kw, BN, kk), k_slice(Qs, BM, kk));
        hopper::wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          mma_ss<64, E>(dpt, k_slice(Vw, BN, kk), k_slice(dOs, BM, kk));
        hopper::wgmma_commit();
        // P^T and dS^T are masked only where the tile straddles this
        // warp's diagonal or the ragged end of R
        const bool masked = r0 + BM > R || (causal && kwarp_last > r0 / qpk);
        hopper::wgmma_wait<1>();
        hopper::fence_regs<32>(st);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int ci = j * 8 + 2 * tg + (e & 1);
            const int row = r0 + ci;
            const int key = e < 2 ? ka : kb;
            const bool ok = !masked
                || (row < R && (!causal || key <= row / qpk));
            st[4 * j + e] = ok
                ? exp2f(st[4 * j + e] * scale_log2 - lse_s[ci] * LOG2E) : 0.f;
          }
        }
        const E* dOc = dOs + (c0 / 64) * BM * 64;
        const E* Qc = Qs + (c0 / 64) * BM * 64;
        uint32_t ap[4][4], as[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          c_to_a<E>(ap[kk], st + 8 * kk, st + 8 * kk + 4);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          mma_rs<DC>(dva, ap[kk], dOc + kk * 16 * 64, BM * 128);
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();
        hopper::fence_regs<32>(dpt);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int ci = j * 8 + 2 * tg + (e & 1);
            dpt[4 * j + e] = st[4 * j + e] * (dpt[4 * j + e] - dl_s[ci]);
          }
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          c_to_a<E>(as[kk], dpt + 8 * kk, dpt + 8 * kk + 4);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          mma_rs<DC>(dka, as[kk], Qc + kk * 16 * 64, BM * 128);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs<DC / 2>(dva);
        hopper::fence_regs<DC / 2>(dka);
      }
      hopper::mbar_arrive(&empty[s]);
    }

    const size_t koff = (size_t)bg * T * D;
#pragma unroll
    for (int i = 0; i < DC / 8; ++i) {
      const int col = c0 + i * 8 + 2 * tg;
      store2(dk + koff, ka, T, col, D, dka[4 * i] * sm_scale,
             dka[4 * i + 1] * sm_scale);
      store2(dk + koff, kb, T, col, D, dka[4 * i + 2] * sm_scale,
             dka[4 * i + 3] * sm_scale);
      store2(dv + koff, ka, T, col, D, dva[4 * i], dva[4 * i + 1]);
      store2(dv + koff, kb, T, col, D, dva[4 * i + 2], dva[4 * i + 3]);
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

// Opts a kernel in to `bytes` of dynamic shared memory (above 48 KB).
template <typename K>
int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int DP>
constexpr int chunk_cols() { return DP < 128 ? DP : 128; }

// K4: key tiles of 128 (64 at d 256); K5: 128 rows a block, K6: 128 keys
// a block (64 at d 256); output columns in chunks of at most 128.
template <int DP>
using FwdL = FwdLayout<DP, DP == 256 ? 64 : 128, chunk_cols<DP>()>;
template <int DP>
using DqL = DqLayout<DP, DP == 256 ? 1 : 2, chunk_cols<DP>()>;
template <int DP>
using DkvL = DkvLayout<DP, DP == 256 ? 1 : 2, chunk_cols<DP>()>;

template <typename E, int DP>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               void* lse, int BG, int R, int T, int D, int qpk, int causal,
               float sm_scale, cudaStream_t s) {
  using L = FwdL<DP>;
  constexpr int BN = L::BN, DC = L::DC;
  auto kern = flash_fwd_kernel<E, DP, BN, DC>;
  // once per instantiation: never inside a CUDA-graph capture after the
  // first (warm-up) launch
  static const int err = set_smem(kern, L::SMEM);
  if (err) return err;
  CUtensorMap tq, tk, tv;
  int e = hopper::map_3d<E>(&tq, q, D, R, BG, L::BM);
  if (!e) e = hopper::map_3d<E>(&tk, k, D, T, BG, BN);
  if (!e) e = hopper::map_3d<E>(&tv, v, D, T, BG, BN);
  if (e) return e;
  dim3 grid((R + L::BM - 1) / L::BM * BG, DP / DC);
  kern<<<grid, 384, L::SMEM, s>>>(tq, tk, tv, static_cast<E*>(o),
                                  static_cast<float*>(lse), BG, R, T, D, qpk,
                                  causal, sm_scale * LOG2E);
  return (int)cudaGetLastError();
}

template <typename E, int DP>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int BG, int R,
              int T, int D, int qpk, int causal, float sm_scale,
              cudaStream_t s) {
  using L = DqL<DP>;
  constexpr int NWG = L::NWG, DC = L::DC;
  auto kern = flash_bwd_dq_kernel<E, DP, NWG, DC>;
  // once per instantiation: never inside a CUDA-graph capture after the
  // first (warm-up) launch
  static const int err = set_smem(kern, L::SMEM);
  if (err) return err;
  CUtensorMap tq, tk, tv, tdo, tlse, tdelta;
  int e = hopper::map_3d<E>(&tq, q, D, R, BG, L::BM);
  if (!e) e = hopper::map_3d<E>(&tdo, dout, D, R, BG, L::BM);
  if (!e) e = hopper::map_3d<E>(&tk, k, D, T, BG, L::BN);
  if (!e) e = hopper::map_3d<E>(&tv, v, D, T, BG, L::BN);
  // lse and delta rows padded to a multiple of 4 values by the wrapper
  const int ld = (R + 3) / 4 * 4;
  if (!e) e = hopper::map_f32_rows(&tlse, lse, R, BG, ld, L::BM);
  if (!e) e = hopper::map_f32_rows(&tdelta, delta, R, BG, ld, L::BM);
  if (e) return e;
  dim3 grid((R + L::BM - 1) / L::BM * BG, DP / DC);
  kern<<<grid, 128 * (NWG + 1), L::SMEM, s>>>(
      tq, tk, tv, tdo, tlse, tdelta, static_cast<E*>(dq), BG, R, T, D,
      qpk, causal, sm_scale * LOG2E, sm_scale);
  return (int)cudaGetLastError();
}

template <typename E, int DP>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int BG,
               int R, int T, int D, int qpk, int causal, float sm_scale,
               cudaStream_t s) {
  using L = DkvL<DP>;
  constexpr int NWG = L::NWG, DC = L::DC;
  auto kern = flash_bwd_dkv_kernel<E, DP, NWG, DC>;
  // once per instantiation: never inside a CUDA-graph capture after the
  // first (warm-up) launch
  static const int err = set_smem(kern, L::SMEM);
  if (err) return err;
  CUtensorMap tq, tk, tv, tdo, tlse, tdelta;
  int e = hopper::map_3d<E>(&tq, q, D, R, BG, L::BM);
  if (!e) e = hopper::map_3d<E>(&tdo, dout, D, R, BG, L::BM);
  if (!e) e = hopper::map_3d<E>(&tk, k, D, T, BG, L::BN);
  if (!e) e = hopper::map_3d<E>(&tv, v, D, T, BG, L::BN);
  // lse and delta rows of each group start on 16-byte boundaries: the
  // wrapper pads them to a multiple of 4 values
  const int ld = (R + 3) / 4 * 4;
  if (!e) e = hopper::map_f32_rows(&tlse, lse, R, BG, ld, L::BM);
  if (!e) e = hopper::map_f32_rows(&tdelta, delta, R, BG, ld, L::BM);
  if (e) return e;
  dim3 grid((T + L::BN - 1) / L::BN * BG, DP / DC);
  kern<<<grid, 128 * (NWG + 1), L::SMEM, s>>>(
      tq, tk, tv, tdo, tlse, tdelta, static_cast<E*>(dk),
      static_cast<E*>(dv), BG, R, T, D, qpk, causal, sm_scale * LOG2E,
      sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o, dout, dq: (BG, R, D); k, v, dk, dv: (BG, T, D); all bf16, or all
// fp16 where `fp16` is 1; lse, delta: (BG, R) fp32 (for K5 and K6 each
// group's row padded to a multiple of 4 values); all contiguous and
// 16-byte aligned. R = s * qpk. The wrapper checks 8 <= D <= 256,
// D % 8 == 0, qpk >= 1. Each returns the cudaError_t of its launch (or of
// building its tensor maps).

// d padded to a tile width of 64, 128 or 256
#define HOPPER_DISPATCH(FN, E, ...)                      \
  if (D <= 64) return FN<E, 64>(__VA_ARGS__);            \
  if (D <= 128) return FN<E, 128>(__VA_ARGS__);          \
  return FN<E, 256>(__VA_ARGS__);

// the instantiation for q's type
#define FLASH_DISPATCH(FN, ...)                          \
  if (fp16) {                                            \
    HOPPER_DISPATCH(FN, __half, __VA_ARGS__)             \
  }                                                      \
  HOPPER_DISPATCH(FN, bf16, __VA_ARGS__)

// (the layouts take the same bytes for either type)
template <typename E, int DP>
int smem_of(int kernel) {
  if (kernel == 0) return (int)FwdL<DP>::SMEM;
  if (kernel == 1) return (int)DkvL<DP>::SMEM;
  return (int)DqL<DP>::SMEM;
}

// The dynamic shared memory of K4 (kernel 0), K6 (kernel 1) or K5 (kernel
// 2) at head size D, for the build report.
extern "C" int flash_attention_smem(int kernel, int D) {
  HOPPER_DISPATCH(smem_of, bf16, kernel)
}

extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse, int BG,
                                   int R, int T, int D, int qpk, int causal,
                                   int fp16, float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(launch_fwd, q, k, v, o, lse, BG, R, T, D, qpk, causal,
                 sm_scale, s)
}

extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dq, int BG, int R, int T, int D,
                                      int qpk, int causal, int fp16,
                                      float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(launch_dq, q, k, v, dout, lse, delta, dq, BG, R, T, D, qpk,
                 causal, sm_scale, s)
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv, int BG, int R,
                                       int T, int D, int qpk, int causal,
                                       int fp16, float sm_scale,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(launch_dkv, q, k, v, dout, lse, delta, dk, dv, BG, R, T, D,
                 qpk, causal, sm_scale, s)
}
