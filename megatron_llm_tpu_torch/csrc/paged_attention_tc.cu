// Ragged paged attention on the tensor cores (sm_90a), bf16 q with bf16 or
// int8 page pools: the engine's default pools, its int8 pools, its window
// mode and the packed-document prefill, decode and mixed rounds alike,
// any qpk.
//
// Replaces the Pallas kernel `_paged_kernel` (megatron_llm_tpu/ops/
// prefill_attention.py:135, launched by `_paged_pallas` at :369; its int8
// branch `quantized=True` at :182-187 and :211-214) for those launches;
// `paged_attention.cu` keeps fp32 pools and page sizes that are not a
// multiple of 8. The wrapper picks the kernel by a pure function of dtypes
// and shapes (`paged_design`, ops/prefill_attention.py).
//
// What it computes (the same function as paged_attention.cu, whose header
// has it in full): chunk c is chunk_lens[c] tokens of one slot at cache
// positions starts[c] + t, its keys and values in pool pages
// page_table[c, pos / page_size]; folded rows r = t * qpk + h (head
// fastest) attend positions lo_r .. starts[c] + t, lo_r = max(0, starts[c]
// + t - (W - 1), doc_starts[c]); exp2-domain online softmax with fp32
// state, out = acc / max(l, 1e-30) in bf16; pad rows (t >= chunk_lens[c])
// are exact zeros. With bf16 pools p is rounded to bf16 before PV. With
// int8 pools K and V are dequantized against their per-(page, row, group)
// fp32 scales and p stays fp32, as in the Pallas int8 branch.
//
// What bounds it on the H100: a prefill chunk of C tokens does about C *
// qpk / 2 flops per K/V byte, so a chunk is bytes-bound at qpk 1 (C 256:
// ~128 flops a byte against the card's ~295) and operation-bound from
// qpk * C ~ 600 on; a decode row inside a mixed round reads its slot's
// pages for one row. Int8 pools halve the bytes. The present kernel ran
// both products on CUDA cores in blocks of at most 16 folded rows, so a
// 256-token chunk at qpk 1 was 16 blocks a group, each reading the chunk's
// pages again: a mixed round took 14x (int8: 24x) its bound.
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
//     issues one TMA load per page segment into a 2-stage mbarrier ring,
//     through 3-D tensor maps over the pools (d, g, P * page_size) with
//     boxes of seg = gcd(page_size, 64) positions: one load a tile at page
//     64 (4 at page 16), and a segment never straddles a page or a tile. It
//     loads only segments inside [the block's first floor, its last valid
//     row's position], so a page-table entry outside them (reclaimed below
//     a window, parked on the null page, or past the chunk's reach) is
//     never read;
//       bf16 pools: boxes (64, 1, seg), 128-byte swizzled, K and V tiles of
//     64 positions straight into the ring. A segment lands on a whole 8-row
//     swizzle atom (page_size % 8 == 0), so the tile's panels are exactly
//     what a single 64-row box would have written;
//       int8 pools: boxes (d, 1, seg) of plain d-byte rows into the ring;
//     the consumer turns each tile into one pair of bf16 swizzled panels
//     (every int8 value is exact in bf16; an integer, byte-permute and
//     fp32-add conversion, no int-to-float instruction), writes zeros for
//     rows outside the block's range, and puts the tile's 64 K and 64 V
//     scales beside the panels; the scales come by plain loads (a TMA box
//     cannot start a one-float-wide column of the (P, page, g) scale
//     pool), read a tile ahead and their page-table rows two ahead. The
//     scales stay out of the panels. Measured against a converter
//     warpgroup (the producer's 128 threads converting into a 2-stage
//     bf16 ring): no faster in one call (H100, PERF.md), more code;
//   - the consumer warpgroup (setmaxnreg moves registers to it) stages Q
//     once with 16-byte loads into swizzled panels (the folded rows of a
//     (chunk, group) are strided in q's (nc, C, g, qpk, d) layout), then
//     per tile: S = Q K^T by wgmma, both operands from shared memory,
//     K-major (on the raw integer K with int8 pools: column t of S is
//     then scaled by k_scale[t], the same function as dequantizing first
//     up to fp32 rounding); the online softmax on the accumulator; O += P V
//     with A re-packed from the accumulator and B = V MN-major (the
//     transpose bit). bf16 pools: A = bf16(P). Int8 pools: p stays fp32 in
//     the reference, so v_scale[t] is folded into p and the product runs
//     as three bf16 wgmmas on the raw integer V, one for each bf16 term of
//     p vs (the bf16 rounding of what the terms before it left): 24
//     significant bits, fp32's, where a hi/lo pair keeps 16; each term
//     times an integer is exact in the fp32 accumulator. Against the exact
//     (float64) answer its error equals the present design's (H100,
//     PERF.md). Tiles inside every row's [lo_r, diagonal] of a warp take a
//     maskless branch. Key tiles are aligned to 64 positions, so the first
//     and last tile of a block may hold positions outside its range, whose
//     V rows are zeros before the PV product reads them (bf16: zeroed by
//     the consumer while S runs; int8: converted as zeros): a NaN there
//     would otherwise reach the output through 0 * NaN.
//   - long walks are split across blocks: the grid's x dimension holds
//     nsplit blocks for each row tile, and split j walks key tiles [8 j,
//     8 j + 8) of the block's range (more tiles a split when 16 splits
//     would not cover the page table; the wrapper's `tc_split`, from the
//     table's width, the folded rows and the pool dtype: decode rounds and
//     int8 pools split, wider bf16 launches do not, whose row tiles fill
//     the card already). A decode round's longest walk (2047 positions, 32
//     tiles) was one block's 32 serial tiles, 2x the bytes bound; split,
//     it is 4 blocks of 8 side by side. Splits past a block's walk return
//     at once; the live splits write their rows' (m, l, acc) to a
//     workspace and the last to arrive at the row tile's counter merges
//     them in split order and resets the counter (K1's scheme).
// Each output row is written by one block, and every sum (over key tiles
// within a split, over splits in the merge) runs in a fixed order: two
// runs give the same bits, and a window that covers the context runs the
// no-window code with lo = 0.
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
constexpr int BM = 64;  // folded rows a block
constexpr int BN = 64;  // cache positions a key tile


using hopper::align1024;
using hopper::c_to_a;
using hopper::k_slice;
using hopper::mma_rs;
using hopper::mma_ss;
using hopper::quad_max;
using hopper::quad_sum;

// Shared memory: Q panels, the ring of ST stages that TMA fills (bf16
// pools: K and V panels; int8 pools: K and V rows), then with int8 pools
// the one pair of K and V panels the consumer converts each tile into and
// the tile's scales, and the barriers. Two blocks an SM at d <= 128.
template <int DP, bool Q8>
struct TcLayout {
  static constexpr int ST = 2;                       // stages of the ring
  static constexpr uint32_t Q_BYTES = BM * DP * 2;   // DP / 64 panels
  static constexpr uint32_t KV_BYTES = BN * DP * 2;  // bf16 K, then V
  static constexpr uint32_t STAGE_BYTES = Q8 ? 2 * BN * DP : 2 * KV_BYTES;
  static constexpr uint32_t PANEL_BYTES = Q8 ? 2 * KV_BYTES : 0;
  static constexpr uint32_t SCALE_BYTES = Q8 ? 2 * BN * 4 : 0;
  static constexpr uint32_t BAR_OFFSET = Q_BYTES + ST * STAGE_BYTES
                                         + PANEL_BYTES + SCALE_BYTES;
  static constexpr size_t SMEM = 1024 + BAR_OFFSET + 8 * 2 * ST + 16;
};

// The first position row `pos`'s token may attend (pos >= 0).
__device__ __forceinline__ int floor_of(int pos, int doc, int window) {
  return max(doc, window > 0 ? pos - (window - 1) : 0);
}

// Eight int8 values (two words) as eight bf16 values, exactly, with
// full-rate integer and fp32 operations (no int-to-float conversion
// instruction): a byte x, its sign bit flipped (x + 128), is placed under
// the exponent of 2^23 and 2^23 + 128 taken off, which is x in fp32; an
// integer of at most 8 significant bits is exact in bf16, whose bits are
// then the fp32's upper half.
__device__ __forceinline__ uint32_t i8x2_to_bf16x2(uint32_t u, int j) {
  const float a = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + j))
                  - 8388736.f;
  const float b = __uint_as_float(__byte_perm(u, 0x4B000000u,
                                              0x7440 + j + 1))
                  - 8388736.f;
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
}

__device__ __forceinline__ uint4 i8x8_to_bf16(uint2 w) {
  const uint32_t x = w.x ^ 0x80808080u, y = w.y ^ 0x80808080u;
  return make_uint4(i8x2_to_bf16x2(x, 0), i8x2_to_bf16x2(x, 2),
                    i8x2_to_bf16x2(y, 0), i8x2_to_bf16x2(y, 2));
}

// The A fragment of the next bf16 term of x (the C fragments c0, c1 as
// in c_to_a): each element's bf16 rounding, which is then taken off x.
__device__ __forceinline__ void split_to_a(uint32_t* a, float* c0, float* c1) {
  float* src[2] = {c0, c1};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float* x = src[i / 2] + 2 * (i % 2);
    const __nv_bfloat162 h = __floats2bfloat162_rn(x[0], x[1]);
    const float2 f = __bfloat1622float2(h);
    x[0] -= f.x;
    x[1] -= f.y;
    a[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
}

// Grid (ceil(C * qpk / 64), G, nc); 256 threads: the producer warpgroup,
// then the consumer. Two blocks a multiprocessor at d <= 128: 128
// registers a thread at launch, then 24 for the producer and 232 for the
// consumer. Q8: int8 pools; tk and tv then map int8 rows, and k_scales /
// v_scales are the (P, page_size, G) scale pools.
template <int DP, bool Q8>
__global__ void __launch_bounds__(256, 2)
paged_attn_tc_kernel(const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const bf16* __restrict__ q, bf16* __restrict__ out,
                     const float* __restrict__ k_scales,
                     const float* __restrict__ v_scales,
                     const int* __restrict__ page_table,
                     const int* __restrict__ starts,
                     const int* __restrict__ chunk_lens,
                     const int* __restrict__ doc_starts,
                     float* __restrict__ ws, unsigned* __restrict__ counters,
                     int C, int G, int qpk, int d, int page_size, int seg,
                     int max_pages, int window, float scale_log2, int nsplit,
                     int tps) {
  using L = TcLayout<DP, Q8>;
  constexpr int ST = L::ST;
  constexpr int NC = DP < 128 ? DP : 128;  // columns of one PV product
  const int c = blockIdx.z, gi = blockIdx.y;
  const int R = C * qpk;  // folded rows of one (chunk, group)
  const int rt = blockIdx.x / nsplit, split = blockIdx.x % nsplit;
  const int r0 = rt * BM;
  const int start = starts[c], clen = chunk_lens[c];
  const size_t tok_stride = (size_t)G * qpk * d;
  const size_t base = ((size_t)c * C * G + gi) * qpk * d;  // token 0, head 0
  const int nrows = min(BM, R - r0);

  if (r0 / qpk >= clen) {  // every row is pad: exact zeros, nothing read
    if (split > 0) return;
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
  bf16* panels = reinterpret_cast<bf16*>(ring + ST * L::STAGE_BYTES);
  float* scales = reinterpret_cast<float*>(ring + ST * L::STAGE_BYTES
                                           + L::PANEL_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFFSET);
  uint64_t* empty = full + ST;

  // the block's positions: from its first row's floor (the lowest) to its
  // last valid row's position (the highest)
  const int doc = doc_starts != nullptr ? doc_starts[c] : 0;
  const int t_last = min((r0 + nrows - 1) / qpk, clen - 1);
  const int lo_blk = floor_of(start + r0 / qpk, doc, window);
  const int hi_blk = start + t_last;
  // this split's key tiles: tps of the block's walk from the split-th on
  const int ntiles_all = hi_blk / BN - lo_blk / BN + 1;
  const int nlive = (ntiles_all + tps - 1) / tps;
  if (split >= nlive) return;  // reads nothing, writes nothing
  const int j0 = lo_blk / BN + split * tps;
  const int ntiles = min(tps, ntiles_all - split * tps);
  const int* pt = page_table + (size_t)c * max_pages;

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
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % ST, n = i / ST;
        if (n > 0) hopper::mbar_wait(&empty[s], (n - 1) & 1);
        unsigned char* stage = ring + s * L::STAGE_BYTES;
        const int n0 = (j0 + i) * BN;
        int nseg = 0;
        for (int p0 = n0; p0 < n0 + BN; p0 += seg)
          nseg += p0 + seg > lo_blk && p0 <= hi_blk;
        // bf16: a segment is DP / 64 panel boxes of K and of V; int8: one
        // box of d-byte rows each
        hopper::mbar_expect_tx(&full[s], (uint32_t)nseg * seg
                                             * (Q8 ? d : DP * 2) * 2);
        for (int p0 = n0; p0 < n0 + BN; p0 += seg) {
          if (p0 + seg <= lo_blk || p0 > hi_blk) continue;
          const int row = pt[p0 / page_size] * page_size + p0 % page_size;
          if constexpr (Q8) {
            hopper::tma_load_3d(stage + (p0 - n0) * d, &tk, &full[s], 0, gi,
                                row);
            hopper::tma_load_3d(stage + BN * DP + (p0 - n0) * d, &tv,
                                &full[s], 0, gi, row);
          } else {
            bf16* Ks = reinterpret_cast<bf16*>(stage);
            bf16* Vs = Ks + BN * DP;
            for (int p = 0; p < DP / 64; ++p) {
              hopper::tma_load_3d(Ks + p * BN * 64 + (p0 - n0) * 64, &tk,
                                  &full[s], 64 * p, gi, row);
              hopper::tma_load_3d(Vs + p * BN * 64 + (p0 - n0) * 64, &tv,
                                  &full[s], 64 * p, gi, row);
            }
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

  // int8 pools: thread t's scale (t < 64: key t's K scale, else key t -
  // 64's V scale), read a tile ahead of its use, its pool row two ahead
  const float* scale_pool = t < BN ? k_scales : v_scales;
  auto row_of = [&](int i) {
    const int pos = (j0 + i) * BN + t % BN;
    return i >= ntiles || pos < lo_blk || pos > hi_blk ? -1
        : pt[pos / page_size] * page_size + pos % page_size;
  };
  auto scale_at = [&](int row) {
    return row < 0 ? 0.f : scale_pool[(size_t)row * G + gi];
  };
  float scale_next = 0.f;
  int row_next = -1;
  if constexpr (Q8) {
    scale_next = scale_at(row_of(0));
    row_next = row_of(1);
  }

  float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

  for (int i = 0; i < ntiles; ++i) {
    const int s = i % ST;
    const int n0 = (j0 + i) * BN;
    hopper::mbar_wait(&full[s], (i / ST) & 1);
    const bf16* Ks;
    bf16* Vs;
    if constexpr (Q8) {
      // the int8 rows into the one pair of panels (every warp is done with
      // the last tile's products: each waited for its own), zeros outside
      // [lo_blk, hi_blk], and this tile's scales beside them
      const float scale = scale_next;
      scale_next = scale_at(row_next);
      row_next = row_of(i + 2);
      hopper::named_bar_sync(1, 128);
      const unsigned char* K8 = ring + s * L::STAGE_BYTES;
      const unsigned char* V8 = K8 + BN * DP;
      Ks = panels;
      Vs = panels + BN * DP;
      scales[t] = scale;
      for (int e = t; e < BN * (DP / 8); e += 128) {
        const int key = e / (DP / 8), ch = e % (DP / 8);
        const int pos = n0 + key;
        uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
        if (pos >= lo_blk && pos <= hi_blk && ch * 8 < d) {
          kv = i8x8_to_bf16(*reinterpret_cast<const uint2*>(
              K8 + key * d + ch * 8));
          vv = i8x8_to_bf16(*reinterpret_cast<const uint2*>(
              V8 + key * d + ch * 8));
        }
        const int off = (ch / 8) * BN * 64 + key * 64
                        + (((ch % 8) ^ (key & 7)) * 8);
        *reinterpret_cast<uint4*>(panels + off) = kv;
        *reinterpret_cast<uint4*>(panels + BN * DP + off) = vv;
      }
      hopper::fence_proxy_async();
      hopper::named_bar_sync(1, 128);
      hopper::mbar_arrive(&empty[s]);  // the int8 stage is free
    } else {
      Ks = reinterpret_cast<const bf16*>(ring + s * L::STAGE_BYTES);
      Vs = reinterpret_cast<bf16*>(ring + s * L::STAGE_BYTES) + BN * DP;
    }
    // S = Q K^T
    float sc[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) sc[j] = 0.f;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      mma_ss<64>(sc, k_slice(Qs, BM, kk), k_slice(Ks, BN, kk));
    hopper::wgmma_commit();
    // bf16 pools: the first and last tile may hold positions outside
    // [lo_blk, hi_blk] (not loaded, or another slot's or a reclaimed
    // page's rows): their V rows become zeros before the PV product reads
    // them (int8 pools: converted as zeros already)
    if (!Q8 && (n0 < lo_blk || n0 + BN - 1 > hi_blk)) {
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
    if constexpr (Q8) {  // column t of S times k_scale[t]
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float kscale = scales[j * 8 + 2 * tg + e];
          sc[4 * j + e] *= kscale;
          sc[4 * j + 2 + e] *= kscale;
        }
      }
    }

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
    if constexpr (!Q8) {
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
    } else {
      // O += (p vs) V_int, p vs split into three bf16 terms (each the
      // bf16 rounding of what the terms before it left): 24 significant
      // bits, fp32's, and each term times an integer of V is exact
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float vscale = scales[BN + j * 8 + 2 * tg + e];
          sc[4 * j + e] *= vscale;
          sc[4 * j + 2 + e] *= vscale;
        }
      }
      if constexpr (DP <= 128) {
        // all three terms' products at once, the smallest term first
        uint32_t pf[3][4][4];
#pragma unroll
        for (int term = 0; term < 3; ++term)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            split_to_a(pf[term][kk], sc + 8 * kk, sc + 8 * kk + 4);
        hopper::wgmma_fence();
#pragma unroll
        for (int term = 2; term >= 0; --term)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int h = 0; h < DP / NC; ++h)
              mma_rs<NC>(acc + h * NC / 2, pf[term][kk],
                         Vs + h * (NC / 64) * BN * 64 + kk * 16 * 64,
                         BN * 128);
      } else {  // d 256: one term's products at a time (registers)
#pragma unroll
        for (int term = 0; term < 3; ++term) {
          uint32_t pf[4][4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            split_to_a(pf[kk], sc + 8 * kk, sc + 8 * kk + 4);
          hopper::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int h = 0; h < DP / NC; ++h)
              mma_rs<NC>(acc + h * NC / 2, pf[kk],
                         Vs + h * (NC / 64) * BN * 64 + kk * 16 * 64,
                         BN * 128);
          if (term < 2) {
            hopper::wgmma_commit();
            hopper::wgmma_wait<0>();
            hopper::fence_regs<DP / 2>(acc);
          }
        }
      }
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs<DP / 2>(acc);
    if constexpr (!Q8) hopper::mbar_arrive(&empty[s]);  // the stage is free
  }

  // out = acc / max(l, 1e-30); pad rows zeros
  bf16* oa = out + base + (size_t)(ra / qpk) * tok_stride
             + (size_t)(ra % qpk) * d;
  bf16* ob = out + base + (size_t)(rb / qpk) * tok_stride
             + (size_t)(rb % qpk) * d;
  if (nlive == 1) {
    const float la_ = fmaxf(l_a, 1e-30f), lb_ = fmaxf(l_b, 1e-30f);
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
    return;
  }

  // Split walks: each valid row's (m, l, acc) of this split to the
  // workspace (parts ((c * G + gi) * R + r) * nsplit + split: (m, l)
  // pairs, then acc rows of d), then the last split of the row tile to
  // arrive merges every live split in split order and resets its counter.
  const size_t nparts = (size_t)gridDim.z * G * R * nsplit;
  float* wacc = ws + 2 * nparts;
  const size_t part0 = ((size_t)c * G + gi) * R;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = h ? rb : ra;
    if ((h ? pb : pa) < 0) continue;  // pad or past R: nothing to merge
    const size_t part = (part0 + r) * nsplit + split;
    if (tg == 0) {
      ws[2 * part] = h ? m_b : m_a;
      ws[2 * part + 1] = h ? l_b : l_a;
    }
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      const int col = i * 8 + 2 * tg;
      if (col < d)
        *reinterpret_cast<float2*>(wacc + part * d + col) =
            make_float2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
    }
  }
  __threadfence();
  hopper::named_bar_sync(1, 128);
  int* last = reinterpret_cast<int*>(smem + L::BAR_OFFSET + 8 * 2 * ST);
  unsigned* counter = counters + ((size_t)c * G + gi) * gridDim.x / nsplit
                      + rt;
  if (t == 0) *last = atomicAdd(counter, 1u) == (unsigned)(nlive - 1);
  hopper::named_bar_sync(1, 128);
  if (!*last) return;
  __threadfence();
  if (t == 0) *counter = 0u;
  // each row's split weights (its splits' maxima against their largest)
  // and sum, in the (now idle) Q panels; then every element's nlive
  // partial values, independent loads
  float* w_s = reinterpret_cast<float*>(Qs);  // [BM][nlive]
  float* l_s = w_s + BM * nlive;              // [BM]
  for (int i = t; i < nrows * nlive; i += 128) {
    const int r = r0 + i / nlive;
    if (r / qpk < clen)
      w_s[i] = __ldcg(ws + 2 * ((part0 + r) * nsplit + i % nlive));
  }
  hopper::named_bar_sync(1, 128);
  if (t < nrows && (r0 + t) / qpk < clen) {
    const size_t p0 = (part0 + r0 + t) * nsplit;
    float mx = NEG_INF;
    for (int j = 0; j < nlive; ++j) mx = fmaxf(mx, w_s[t * nlive + j]);
    float l = 0.f;
    for (int j = 0; j < nlive; ++j) {
      const float w = exp2f(w_s[t * nlive + j] - mx);
      l += __ldcg(ws + 2 * (p0 + j) + 1) * w;
      w_s[t * nlive + j] = w;
    }
    l_s[t] = fmaxf(l, 1e-30f);
  }
  hopper::named_bar_sync(1, 128);
  for (int i = t; i < nrows * d; i += 128) {
    const int rr = i / d, col = i % d, r = r0 + rr;
    bf16* o = out + base + (size_t)(r / qpk) * tok_stride
              + (size_t)(r % qpk) * d + col;
    if (r / qpk >= clen) {
      *o = __float2bfloat16(0.f);
      continue;
    }
    const float* ap = wacc + (part0 + r) * nsplit * d + col;
    float a = 0.f;
#pragma unroll 4
    for (int j = 0; j < nlive; ++j) a += __ldcg(ap + (size_t)j * d) * w_s[rr * nlive + j];
    *o = __float2bfloat16(a / l_s[rr]);
  }
}

struct Args {
  const void *q, *k_pages, *v_pages;
  const float *k_scales, *v_scales;
  void* out;
  const int *pt, *starts, *lens, *doc;
  float* ws;
  unsigned* counters;
  int nc, C, G, qpk, d, num_pages, page_size, max_pages, window;
  float scale_log2;
  int nsplit, tps;
};

template <int DP, bool Q8>
int launch(const Args& a, cudaStream_t stream) {
  using L = TcLayout<DP, Q8>;
  auto kern = paged_attn_tc_kernel<DP, Q8>;
  // once per instantiation: never inside a CUDA-graph capture after the
  // first (warm-up) launch
  static const int err = (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::SMEM);
  if (err) return err;
  CUtensorMap tk, tv;
  int seg = BN;  // positions a load brings: gcd(page_size, 64)
  while (a.page_size % seg) seg >>= 1;
  const int rows = a.num_pages * a.page_size;
  int e;
  if constexpr (Q8) {
    e = hopper::map_i8_3d(&tk, a.k_pages, a.d, a.G, rows, seg);
    if (!e) e = hopper::map_i8_3d(&tv, a.v_pages, a.d, a.G, rows, seg);
  } else {
    e = hopper::map_bf16_3d(&tk, a.k_pages, a.d, a.G, rows, 1, seg);
    if (!e) e = hopper::map_bf16_3d(&tv, a.v_pages, a.d, a.G, rows, 1, seg);
  }
  if (e) return e;
  dim3 grid((a.C * a.qpk + BM - 1) / BM * a.nsplit, a.G, a.nc);
  kern<<<grid, 256, L::SMEM, stream>>>(
      tk, tv, static_cast<const bf16*>(a.q), static_cast<bf16*>(a.out),
      a.k_scales, a.v_scales, a.pt, a.starts, a.lens, a.doc, a.ws,
      a.counters, a.C, a.G, a.qpk, a.d, a.page_size, seg, a.max_pages,
      a.window, a.scale_log2, a.nsplit, a.tps);
  return (int)cudaGetLastError();
}

template <bool Q8>
int dispatch_d(const Args& a, cudaStream_t s) {
  if (a.d <= 64) return launch<64, Q8>(a, s);
  if (a.d <= 128) return launch<128, Q8>(a, s);
  return launch<256, Q8>(a, s);
}

}  // namespace

// The dynamic shared memory of the kernel at head size d, with bf16 pools
// (int8 = 0) or int8 pools (int8 = 1), for the build report.
extern "C" int paged_attention_tc_smem(int d, int int8) {
  if (int8) {
    if (d <= 64) return (int)TcLayout<64, true>::SMEM;
    if (d <= 128) return (int)TcLayout<128, true>::SMEM;
    return (int)TcLayout<256, true>::SMEM;
  }
  if (d <= 64) return (int)TcLayout<64, false>::SMEM;
  if (d <= 128) return (int)TcLayout<128, false>::SMEM;
  return (int)TcLayout<256, false>::SMEM;
}

// q, out: (nc, C, G, qpk, d) bf16 contiguous; k_pages, v_pages:
// (num_pages, page_size, G, d) bf16, or int8 when k_scales and v_scales
// (num_pages, page_size, G) fp32 are given, contiguous and 16-byte aligned;
// page_table: (nc, max_pages) int32; starts, chunk_lens and doc_starts (or
// null): (nc,) int32; window: W, 0 for none. A block's walk is cut into
// splits of `tps` key tiles, `nsplit` of them (1: no split); with nsplit
// > 1, ws holds (2 + d) fp32 for each of nc * G * C * qpk * nsplit parts
// and counters one unsigned, zero, for each of nc * G * ceil(C * qpk /
// 64) row tiles (the merging block leaves it zero); the wrapper sizes both
// and needs nsplit <= 16. The wrapper checks d % 8 == 0 (d % 16 == 0 for
// int8 pools), d <= 256, qpk >= 1, C >= 1, page_size % 8 == 0 and
// doc_starts <= starts. Returns the cudaError_t of the launch.
extern "C" int ragged_paged_attention_tc_fwd(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, void* out,
    const void* page_table, const void* starts, const void* chunk_lens,
    const void* doc_starts, void* ws, void* counters, int nc, int C, int G,
    int qpk, int d, int num_pages, int page_size, int max_pages, int window,
    float scale_log2, int nsplit, int tps, void* stream) {
  if (nc == 0) return 0;
  const Args a{q, k_pages, v_pages, static_cast<const float*>(k_scales),
               static_cast<const float*>(v_scales), out,
               static_cast<const int*>(page_table),
               static_cast<const int*>(starts),
               static_cast<const int*>(chunk_lens),
               static_cast<const int*>(doc_starts), static_cast<float*>(ws),
               static_cast<unsigned*>(counters), nc, C, G, qpk, d,
               num_pages, page_size, max_pages, window, scale_log2, nsplit,
               tps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return k_scales != nullptr ? dispatch_d<true>(a, s)
                             : dispatch_d<false>(a, s);
}
