// Ragged paged attention on the tensor cores (sm_90a), bf16 q and bf16
// page pools: the engine's default pools, its window mode and the
// packed-document prefill, decode and mixed rounds alike, any qpk.
//
// Replaces the Pallas kernel `_paged_kernel` (megatron_llm_tpu/ops/
// prefill_attention.py:135, launched by `_paged_pallas` at :369) for those
// launches; `paged_attention.cu` keeps fp32 and int8 pools and page sizes
// that are not a multiple of 8. The wrapper picks the kernel by a pure
// function of dtypes and shapes (`paged_design`, ops/prefill_attention.py).
//
// What it computes (the same function as paged_attention.cu, whose header
// has it in full): chunk c is chunk_lens[c] tokens of one slot at cache
// positions starts[c] + t, its keys and values in pool pages
// page_table[c, pos / page_size]; folded rows r = t * qpk + h (head
// fastest) attend positions lo_r .. starts[c] + t, lo_r = max(0, starts[c]
// + t - (W - 1), doc_starts[c]); exp2-domain online softmax with fp32
// state, p rounded to bf16 before PV, out = acc / max(l, 1e-30); pad rows
// (t >= chunk_lens[c]) are exact zeros.
//
// What bounds it on the H100: a prefill chunk of C tokens does about C *
// qpk / 2 flops per K/V byte, so a chunk is bytes-bound at qpk 1 (C 256:
// ~128 flops a byte against the card's ~295) and operation-bound from
// qpk * C ~ 600 on; a decode row inside a mixed round reads its slot's
// pages for one row. The present kernel ran both products on CUDA cores
// in blocks of at most 16 folded rows, so a 256-token chunk at qpk 1 was
// 16 blocks a group, each reading the chunk's pages again: a mixed round
// took 14x and the three-document round 74x its bound.
//
// The design (K4's, with pages):
//   - a block owns one tile of 64 folded rows of one (chunk, group): grid
//     (ceil(C * qpk / 64), g, nc). Row r sits at position starts + r / qpk,
//     so a tile may cut across tokens and any qpk works. A tile whose rows
//     are all pad writes zeros and returns before anything else: a decode
//     row padded to a mixed round's width costs one working block a group.
//     64-row tiles (one consumer warpgroup) let two blocks share an SM, so
//     twice as many page walks are in flight as with K4's 128-row blocks;
//   - warpgroup 0 is the producer: its thread 0 reads the page table and
//     issues one TMA load per page segment into a 2-stage mbarrier ring of
//     K and V tiles of 64 positions, through 3-D tensor maps over the pools
//     (d, g, P * page_size) with boxes (64, 1, seg), 128-byte swizzled,
//     seg = gcd(page_size, 64): one load a tile at page 64 (4 at page 16),
//     and a segment never straddles a page or a tile. A segment lands on a
//     whole 8-row swizzle atom (page_size % 8 == 0), so the tile's panels
//     are exactly what a single 64-row box would have written. It loads
//     only segments inside [the block's first floor, its last valid row's
//     position], so a page-table entry outside them (reclaimed below a
//     window, parked on the null page, or past the chunk's reach) is never
//     read;
//   - the consumer warpgroup (setmaxnreg moves registers to it) stages Q
//     once with 16-byte loads into swizzled panels (the folded rows of a
//     (chunk, group) are strided in q's (nc, C, g, qpk, d) layout), then
//     per tile: S = Q K^T by wgmma, both operands from shared memory,
//     K-major; the online softmax on the accumulator; O += P V with A =
//     bf16(P) re-packed from the accumulator and B = V MN-major (the
//     transpose bit). Tiles inside every row's [lo_r, diagonal] of a warp
//     take a maskless branch. Key tiles are aligned to 64 positions, so the
//     first and last tile of a block may hold positions outside its range,
//     whose V rows are zeroed in shared memory (while S runs) before the
//     PV product reads them: a NaN there would otherwise reach the output
//     through 0 * NaN.
// Each output row is written once, by one block, from registers, and the
// sum over key tiles runs in a fixed order: two runs give the same bits,
// and a window that covers the context runs the no-window code with lo = 0.
//
// It launches on the caller's stream, allocates nothing, and returns the
// cudaError_t of the launch (or of building its tensor maps).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr float NEG_INF = -1e30f;
constexpr int ST = 2;   // stages of the TMA ring
constexpr int BM = 64;  // folded rows a block
constexpr int BN = 64;  // cache positions a key tile

using hopper::align1024;
using hopper::c_to_a;
using hopper::k_slice;
using hopper::mma_rs;
using hopper::mma_ss;
using hopper::quad_max;
using hopper::quad_sum;

template <int DP>
struct TcLayout {
  static constexpr uint32_t Q_BYTES = BM * DP * 2;   // DP / 64 panels
  static constexpr uint32_t KV_BYTES = BN * DP * 2;  // K, then V
  static constexpr uint32_t STAGE_BYTES = 2 * KV_BYTES;
  static constexpr size_t SMEM = 1024 + Q_BYTES + ST * STAGE_BYTES
                                 + 8 * 2 * ST;
};

// The first position row `pos`'s token may attend (pos >= 0).
__device__ __forceinline__ int floor_of(int pos, int doc, int window) {
  return max(doc, window > 0 ? pos - (window - 1) : 0);
}

// Grid (ceil(C * qpk / 64), G, nc); 256 threads: the producer warpgroup,
// then the consumer. Two blocks a multiprocessor at d <= 128: 128
// registers a thread at launch, then 24 for the producer and 232 for the
// consumer.
template <int DP>
__global__ void __launch_bounds__(256, 2)
paged_attn_tc_kernel(const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const bf16* __restrict__ q, bf16* __restrict__ out,
                     const int* __restrict__ page_table,
                     const int* __restrict__ starts,
                     const int* __restrict__ chunk_lens,
                     const int* __restrict__ doc_starts, int C, int G,
                     int qpk, int d, int page_size, int seg, int max_pages,
                     int window, float scale_log2) {
  using L = TcLayout<DP>;
  constexpr int NC = DP < 128 ? DP : 128;  // columns of one PV product
  const int c = blockIdx.z, gi = blockIdx.y;
  const int R = C * qpk;  // folded rows of one (chunk, group)
  const int r0 = blockIdx.x * BM;
  const int start = starts[c], clen = chunk_lens[c];
  const size_t tok_stride = (size_t)G * qpk * d;
  const size_t base = ((size_t)c * C * G + gi) * qpk * d;  // token 0, head 0
  const int nrows = min(BM, R - r0);

  if (r0 / qpk >= clen) {  // every row is pad: exact zeros, nothing read
    const int cpr = d / 8;
    for (int i = threadIdx.x; i < nrows * cpr; i += blockDim.x) {
      const int r = r0 + i / cpr;
      *reinterpret_cast<uint4*>(out + base + (size_t)(r / qpk) * tok_stride
                                + (size_t)(r % qpk) * d + (i % cpr) * 8) =
          make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  unsigned char* ring = smem + L::Q_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + ST * L::STAGE_BYTES);
  uint64_t* empty = full + ST;

  // the block's positions: from its first row's floor (the lowest) to its
  // last valid row's position (the highest)
  const int doc = doc_starts != nullptr ? doc_starts[c] : 0;
  const int t_last = min((r0 + nrows - 1) / qpk, clen - 1);
  const int lo_blk = floor_of(start + r0 / qpk, doc, window);
  const int hi_blk = start + t_last;
  const int j0 = lo_blk / BN;
  const int ntiles = hi_blk / BN - j0 + 1;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 128);  // every consumer thread
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: thread 0 issues every load, the rest of the warpgroup
    // hands its registers to the consumer and leaves
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      const int* pt = page_table + (size_t)c * max_pages;
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % ST, n = i / ST;
        if (n > 0) hopper::mbar_wait(&empty[s], (n - 1) & 1);
        bf16* Ks = reinterpret_cast<bf16*>(ring + s * L::STAGE_BYTES);
        bf16* Vs = Ks + BN * DP;
        const int n0 = (j0 + i) * BN;
        int nseg = 0;
        for (int p0 = n0; p0 < n0 + BN; p0 += seg)
          nseg += p0 + seg > lo_blk && p0 <= hi_blk;
        hopper::mbar_expect_tx(&full[s], (uint32_t)nseg * seg * DP * 2 * 2);
        for (int p0 = n0; p0 < n0 + BN; p0 += seg) {
          if (p0 + seg <= lo_blk || p0 > hi_blk) continue;
          const int row = pt[p0 / page_size] * page_size + p0 % page_size;
          for (int p = 0; p < DP / 64; ++p) {
            hopper::tma_load_3d(Ks + p * BN * 64 + (p0 - n0) * 64, &tk,
                                &full[s], 64 * p, gi, row);
            hopper::tma_load_3d(Vs + p * BN * 64 + (p0 - n0) * 64, &tv,
                                &full[s], 64 * p, gi, row);
          }
        }
      }
    }
    return;
  }

  hopper::setmaxnreg_inc<232>();
  const int t = threadIdx.x - 128;
  const int warp = t >> 5, lane = t & 31, g = lane >> 2, tg = lane & 3;

  // Q: the tile's rows into 128-byte-swizzled panels (16-byte chunk k of
  // row r at chunk k ^ (r % 8)); pad rows and columns past d are zeros
  for (int i = t; i < BM * (DP / 8); i += 128) {
    const int row = i / (DP / 8), col = (i % (DP / 8)) * 8;
    const int r = r0 + row, tok = r / qpk;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row < nrows && tok < clen && col < d)
      v = *reinterpret_cast<const uint4*>(q + base + (size_t)tok * tok_stride
                                          + (size_t)(r % qpk) * d + col);
    *reinterpret_cast<uint4*>(Qs + (col / 64) * BM * 64 + row * 64
                              + ((((col % 64) / 8) ^ (row & 7)) * 8)) = v;
  }
  hopper::fence_proxy_async();
  hopper::named_bar_sync(1, 128);

  // this thread's rows (ra, rb), their last and first visible positions;
  // a pad row's last is -1, so it sees nothing
  const int ra = r0 + warp * 16 + g, rb = ra + 8;
  const int pa = ra < R && ra / qpk < clen ? start + ra / qpk : -1;
  const int pb = rb < R && rb / qpk < clen ? start + rb / qpk : -1;
  const int la = floor_of(pa, doc, window), lb = floor_of(pb, doc, window);
  // positions every row of this warp sees: [w_lo, w_hi] when all 16 rows
  // are valid (the last row has the highest floor, the first the lowest
  // diagonal)
  const int wr0 = r0 + warp * 16, wr1 = wr0 + 15;
  const bool wfull = wr1 < R && wr1 / qpk < clen;
  const int w_lo = floor_of(start + wr1 / qpk, doc, window);
  const int w_hi = start + wr0 / qpk;

  float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

  for (int i = 0; i < ntiles; ++i) {
    const int s = i % ST;
    hopper::mbar_wait(&full[s], (i / ST) & 1);
    const bf16* Ks = reinterpret_cast<const bf16*>(ring + s * L::STAGE_BYTES);
    bf16* Vs = reinterpret_cast<bf16*>(ring + s * L::STAGE_BYTES) + BN * DP;
    const int n0 = (j0 + i) * BN;
    // S = Q K^T
    float sc[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) sc[j] = 0.f;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      mma_ss<64>(sc, k_slice(Qs, BM, kk), k_slice(Ks, BN, kk));
    hopper::wgmma_commit();
    // the first and last tile may hold positions outside [lo_blk, hi_blk]
    // (not loaded, or another slot's or a reclaimed page's rows): their V
    // rows become zeros before the PV product reads them
    if (n0 < lo_blk || n0 + BN - 1 > hi_blk) {
      for (int e = t; e < BN * (DP / 8); e += 128) {
        const int key = e / (DP / 8), ch = e % (DP / 8);
        if (n0 + key < lo_blk || n0 + key > hi_blk)
          *reinterpret_cast<uint4*>(Vs + (ch / 8) * BN * 64 + key * 64
                                    + (ch % 8) * 8) =
              make_uint4(0u, 0u, 0u, 0u);
      }
      hopper::fence_proxy_async();
      hopper::named_bar_sync(1, 128);
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs<32>(sc);

    float mx_a = NEG_INF, mx_b = NEG_INF;
    if (wfull && n0 >= w_lo && n0 + BN - 1 <= w_hi) {
#pragma unroll
      for (int j = 0; j < 32; j += 4) {
        sc[j] *= scale_log2; sc[j + 1] *= scale_log2;
        sc[j + 2] *= scale_log2; sc[j + 3] *= scale_log2;
        mx_a = fmaxf(mx_a, fmaxf(sc[j], sc[j + 1]));
        mx_b = fmaxf(mx_b, fmaxf(sc[j + 2], sc[j + 3]));
      }
    } else {  // a floor, a diagonal, a pad row or the block's edge
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + j * 8 + 2 * tg + e;
          float& xa = sc[4 * j + e];
          float& xb = sc[4 * j + 2 + e];
          xa = col >= la && col <= pa ? xa * scale_log2 : NEG_INF;
          xb = col >= lb && col <= pb ? xb * scale_log2 : NEG_INF;
          mx_a = fmaxf(mx_a, xa);
          mx_b = fmaxf(mx_b, xb);
        }
      }
    }
    const float mn_a = fmaxf(m_a, quad_max(mx_a));
    const float mn_b = fmaxf(m_b, quad_max(mx_b));
    // a row that has seen nothing yet keeps p = 0: its scores are NEG_INF
    const float mu_a = mn_a == NEG_INF ? 0.f : mn_a;
    const float mu_b = mn_b == NEG_INF ? 0.f : mn_b;
    const float al_a = exp2f(m_a - mn_a), al_b = exp2f(m_b - mn_b);
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < 32; j += 4) {
      sc[j] = exp2f(sc[j] - mu_a);
      sc[j + 1] = exp2f(sc[j + 1] - mu_a);
      sc[j + 2] = exp2f(sc[j + 2] - mu_b);
      sc[j + 3] = exp2f(sc[j + 3] - mu_b);
      sum_a += sc[j] + sc[j + 1];
      sum_b += sc[j + 2] + sc[j + 3];
    }
    l_a = al_a * l_a + quad_sum(sum_a);
    l_b = al_b * l_b + quad_sum(sum_b);
    m_a = mn_a;
    m_b = mn_b;
#pragma unroll
    for (int j = 0; j < DP / 2; j += 4) {
      acc[j] *= al_a; acc[j + 1] *= al_a;
      acc[j + 2] *= al_b; acc[j + 3] *= al_b;
    }
    // O += bf16(P) V, NC columns a product
    uint32_t pf[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      c_to_a(pf[kk], sc + 8 * kk, sc + 8 * kk + 4);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int h = 0; h < DP / NC; ++h)
        mma_rs<NC>(acc + h * NC / 2, pf[kk],
                   Vs + h * (NC / 64) * BN * 64 + kk * 16 * 64, BN * 128);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs<DP / 2>(acc);
    hopper::mbar_arrive(&empty[s]);
  }

  // out = acc / max(l, 1e-30); pad rows zeros
  const float la_ = fmaxf(l_a, 1e-30f), lb_ = fmaxf(l_b, 1e-30f);
  bf16* oa = out + base + (size_t)(ra / qpk) * tok_stride
             + (size_t)(ra % qpk) * d;
  bf16* ob = out + base + (size_t)(rb / qpk) * tok_stride
             + (size_t)(rb % qpk) * d;
#pragma unroll
  for (int i = 0; i < DP / 8; ++i) {
    const int col = i * 8 + 2 * tg;
    if (col < d) {
      if (ra < R)
        *reinterpret_cast<__nv_bfloat162*>(oa + col) = pa >= 0
            ? __floats2bfloat162_rn(acc[4 * i] / la_, acc[4 * i + 1] / la_)
            : __floats2bfloat162_rn(0.f, 0.f);
      if (rb < R)
        *reinterpret_cast<__nv_bfloat162*>(ob + col) = pb >= 0
            ? __floats2bfloat162_rn(acc[4 * i + 2] / lb_,
                                    acc[4 * i + 3] / lb_)
            : __floats2bfloat162_rn(0.f, 0.f);
    }
  }
}

template <int DP>
int launch(const void* q, const void* k_pages, const void* v_pages,
           void* out, const int* pt, const int* starts, const int* lens,
           const int* doc, int nc, int C, int G, int qpk, int d,
           int num_pages, int page_size, int max_pages, int window,
           float scale_log2, cudaStream_t stream) {
  using L = TcLayout<DP>;
  auto kern = paged_attn_tc_kernel<DP>;
  // once per instantiation: never inside a CUDA-graph capture after the
  // first (warm-up) launch
  static const int err = (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::SMEM);
  if (err) return err;
  CUtensorMap tk, tv;
  int seg = BN;  // positions a load brings: gcd(page_size, 64)
  while (page_size % seg) seg >>= 1;
  const int rows = num_pages * page_size;
  int e = hopper::map_bf16_3d(&tk, k_pages, d, G, rows, 1, seg);
  if (!e) e = hopper::map_bf16_3d(&tv, v_pages, d, G, rows, 1, seg);
  if (e) return e;
  dim3 grid((C * qpk + BM - 1) / BM, G, nc);
  kern<<<grid, 256, L::SMEM, stream>>>(
      tk, tv, static_cast<const bf16*>(q), static_cast<bf16*>(out), pt,
      starts, lens, doc, C, G, qpk, d, page_size, seg, max_pages, window,
      scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// The dynamic shared memory of the kernel at head size d, for the build
// report.
extern "C" int paged_attention_tc_smem(int d) {
  if (d <= 64) return (int)TcLayout<64>::SMEM;
  if (d <= 128) return (int)TcLayout<128>::SMEM;
  return (int)TcLayout<256>::SMEM;
}

// q, out: (nc, C, G, qpk, d) bf16 contiguous; k_pages, v_pages:
// (num_pages, page_size, G, d) bf16 contiguous and 16-byte aligned;
// page_table: (nc, max_pages) int32; starts, chunk_lens and doc_starts (or
// null): (nc,) int32; window: W, 0 for none. The wrapper checks d % 8 ==
// 0, d <= 256, qpk >= 1, C >= 1, page_size % 8 == 0 and doc_starts <=
// starts. Returns the cudaError_t of the launch.
extern "C" int ragged_paged_attention_tc_fwd(
    const void* q, const void* k_pages, const void* v_pages, void* out,
    const void* page_table, const void* starts, const void* chunk_lens,
    const void* doc_starts, int nc, int C, int G, int qpk, int d,
    int num_pages, int page_size, int max_pages, int window,
    float scale_log2, void* stream) {
  if (nc == 0) return 0;
  const int* pt = static_cast<const int*>(page_table);
  const int* st = static_cast<const int*>(starts);
  const int* ln = static_cast<const int*>(chunk_lens);
  const int* doc = static_cast<const int*>(doc_starts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 64)
    return launch<64>(q, k_pages, v_pages, out, pt, st, ln, doc, nc, C, G,
                      qpk, d, num_pages, page_size, max_pages, window,
                      scale_log2, s);
  if (d <= 128)
    return launch<128>(q, k_pages, v_pages, out, pt, st, ln, doc, nc, C, G,
                       qpk, d, num_pages, page_size, max_pages, window,
                       scale_log2, s);
  return launch<256>(q, k_pages, v_pages, out, pt, st, ln, doc, nc, C, G,
                     qpk, d, num_pages, page_size, max_pages, window,
                     scale_log2, s);
}
