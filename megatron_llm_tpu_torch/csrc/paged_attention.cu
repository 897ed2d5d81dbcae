// Ragged paged attention for Hopper (sm_90a): the continuous-batching
// engine's one attention, over per-layer page pools; K7's "present"
// design, on CUDA cores.
//
// Replaces the Pallas kernel `_paged_kernel` (megatron_llm_tpu/ops/
// prefill_attention.py:135, launched by `_paged_pallas` at :369): fp and
// int8 pools, and the sliding-window and packed-document lower bounds.
// Since the tensor-core design (`paged_attention_tc.cu`) took bf16 q with
// bf16 or int8 pools, this kernel serves what that design does not take:
// fp32 pools (with fp32 q, or int8 pools under fp32 q), and bf16 or int8
// pools whose page size is not a multiple of 8; the wrapper's
// `paged_design` picks from dtypes and page size alone. Every one of its
// instantiations stays reachable (bf16 and int8 pools at other page sizes
// still need each row count and head size).
//
// What it computes. Chunk c is chunk_lens[c] tokens of one slot at cache
// positions starts[c] + t; its keys and values live in pool pages
// page_table[c, pos / page_size] at row pos % page_size, group gi. For
// each (chunk, group) the group's qpk query heads are folded into rows
// r = t * qpk + h (head fastest), and row r attends cache positions
// lo_r .. starts[c] + t, where lo_r = max(0, starts[c] + t - (W - 1),
// doc_starts[c]) (W = 0 and doc_starts = null switch those bounds off):
//   s = (q . k) * sm_scale * log2(e) in fp32, exp2-domain online softmax
//   with fp32 state, p cast to v's dtype before the PV product (kept in
//   fp32 for int8 pools, as the Pallas int8 branch does),
//   out = acc / max(l, 1e-30), in q's dtype.
// Int8 pools carry one fp32 scale per (page, row, group) in two scale
// pools; each key and value row is dequantized in registers (k * ks,
// v * vs), so device memory sees only the int8 bytes and the scales.
// Rows with t >= chunk_lens[c] (pad rows, every row of an idle chunk)
// are exact zeros. A block reads only positions [lo, starts[c] + its
// last valid token], lo being its first row's floor, and no page-table
// entry outside them: entries below the window (reclaimed, parked on
// the null page) are never dereferenced, so decode traffic is O(W), not
// O(context). With both bounds off lo = 0 and the kernel is the fp one,
// bit for bit; W >= context leaves lo = 0 too.
//
// What bounds it on the H100 (each input read once, each output written
// once; the card needs ~295 bf16 flops per byte before the tensor cores,
// not HBM at 3.35 TB/s, are the limit):
//   - a decode row (C == 1) does 4 * qpk flops per K/V element of its
//     slot's pages: bound by the bytes of those pages (int8 pools move
//     (d + 4) / (2 d) of the bf16 bytes: data plus scales);
//   - a prefill chunk of C tokens starting at 0 does about C * qpk / 2
//     flops per K/V byte: bytes-bound at the Llama-2-7B shape (qpk 1,
//     C 256: ~128), operation-bound at the bf16 tensor-core peak
//     (989 TFLOP/s) from qpk * C of about 600 on, as at the Llama-2-70B
//     shape (qpk 8: ~1024). A chunk that starts deep in its slot reads
//     its whole cache for few rows and stays bytes-bound.
//
// The design:
//   - one block per (q block of bq tokens, group, chunk); bq * qpk <= 16
//     rows, so a block reads each K/V page once for all its rows and all
//     qpk heads of the group (GQA folded). The grid comes from host
//     shapes only (C, g, nc); a block whose tokens are all pad writes
//     zeros and returns at once, so a decode row padded to a mixed
//     round's width costs one block per group, not a walk of its pages;
//   - the block's warps take 32-key tiles from lo on, round-robin; a warp
//     copies its tile of K and V into its own shared-memory buffer with
//     16-byte cp.async (one key row per lane afterwards, rows padded by
//     16 bytes against bank conflicts), looking the page index up in the
//     page table itself (no scalar prefetch on the card); with int8
//     pools each lane also loads its key's two scales;
//   - each lane scores its own key against every row of the block
//     (q staged in shared memory as fp32), the warp reduces max and sum
//     with shuffles, and each lane accumulates E = ceil(d / 32) output
//     columns of every row in registers;
//   - the row loops stop at the block's last valid row, so the decode rows
//     of a mixed round (one valid row in a 16-row block) cost one row;
//   - at the end the warps' (m, l, acc) states merge through shared
//     memory in warp order (deterministic run to run).
// What it leaves on the table (the tensor-core design answers the first
// four for bf16 pools): CUDA cores, not wgmma, for the two products
// (prefill chunks run far below the operation bound); no pipelining of
// the next tile's copy behind the current tile's math; blocks of at most
// 16 folded rows, so qpk > 16 is refused; each q block of a prefill chunk
// reads the chunk's pages again (from L2 mostly); no split of a long
// cache over several blocks (a decode block walks all of its slot's pages
// with 4 warps); the int8 scales are read one 4-byte word per key and
// group (a 32-byte sector each).
//
// It launches on the caller's stream, allocates nothing, and returns the
// cudaError_t of the launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int KT = 32;         // keys per warp tile: one per lane
constexpr int MAX_ROWS = 16;   // folded rows per block
constexpr int MAX_WARPS = 4;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(int8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// p rounded to the value dtype, as the TPU kernel feeds its PV matmul;
// int8 pools keep p in fp32 (the Pallas int8 branch passes no p dtype)
template <typename KV> __device__ __forceinline__ float round_like(float p) {
  return to_float(from_float<KV>(p));
}
template <> __device__ __forceinline__ float round_like<int8_t>(float p) { return p; }

// Eight consecutive elements from aligned shared memory as fp32.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ void load8(const int8_t* p, float* out) {
  const int2 v = *reinterpret_cast<const int2*>(p);
  const char4 a = *reinterpret_cast<const char4*>(&v.x);
  const char4 b = *reinterpret_cast<const char4*>(&v.y);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

// 16-byte global -> shared copy; with pred false it reads nothing and
// fills the 16 bytes with zeros.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  return x;
}

// Bytes of the fp32 part of shared memory (q, acc, per-warp m and l,
// merged m and l), rounded up to 16 so the K/V staging after it stays
// aligned for cp.async.
__host__ __device__ inline size_t stats_bytes(int rows_cap, int d) {
  const size_t b = sizeof(float) * (2 * (size_t)rows_cap * d
                                    + 2 * (size_t)MAX_WARPS * rows_cap
                                    + 2 * (size_t)rows_cap);
  return (b + 15) & ~(size_t)15;
}

// T: q and output type. KV: pool type (T, or int8_t with scale pools).
// ROWS: folded rows per block rounded up to a power of two (register
// arrays are sized by it). E: output columns per lane, a power of two
// >= d / 32.
template <typename T, typename KV, int ROWS, int E>
__global__ void __launch_bounds__(MAX_WARPS * 32)
ragged_paged_attn_kernel(const T* __restrict__ q, const KV* __restrict__ kp,
                         const KV* __restrict__ vp,
                         const float* __restrict__ ks,
                         const float* __restrict__ vs, T* __restrict__ out,
                         const int* __restrict__ page_table,
                         const int* __restrict__ starts,
                         const int* __restrict__ chunk_lens,
                         const int* __restrict__ doc_starts, int C, int G,
                         int qpk, int d, int page_size, int max_pages,
                         int window, int bq, float scale_log2) {
  constexpr int VEC = 16 / sizeof(KV);  // elements per 16-byte copy
  constexpr bool QUANT = sizeof(KV) == 1;
  const int qb = blockIdx.x;
  const int gi = blockIdx.y;
  const int c = blockIdx.z;
  const int nw = blockDim.x >> 5;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  const int start = starts[c];
  const int clen = chunk_lens[c];
  const int t0 = qb * bq;
  const int rows = bq * qpk;
  const int nvalid = min(bq, clen - t0);  // valid tokens of this block
  const size_t tok_stride = (size_t)G * qpk * d;
  const size_t base_off = ((size_t)c * C * G + gi) * qpk * d;

  if (nvalid <= 0) {  // every row is pad: exact zeros, no page is read
    const int ntok = min(bq, C - t0);
    for (int i = tid; i < ntok * qpk * d; i += blockDim.x) {
      const int tb = i / (qpk * d);
      out[base_off + (size_t)(t0 + tb) * tok_stride + i % (qpk * d)] = from_float<T>(0.f);
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);  // [ROWS][d]
  float* acc_s = q_s + ROWS * d;                    // [ROWS][d]
  float* m_s = acc_s + ROWS * d;                    // [MAX_WARPS][ROWS]
  float* l_s = m_s + MAX_WARPS * ROWS;              // [MAX_WARPS][ROWS]
  float* stat_s = l_s + MAX_WARPS * ROWS;           // [2][ROWS]
  const int ld = d + VEC;                           // staging row stride
  KV* k_w = reinterpret_cast<KV*>(smem_raw + stats_bytes(ROWS, d))
            + (size_t)warp * 2 * KT * ld;
  KV* v_w = k_w + KT * ld;

  for (int i = tid; i < ROWS * d; i += blockDim.x) {
    const int r = i / d;
    const int tb = r / qpk;
    float x = 0.f;
    if (r < rows && tb < nvalid)
      x = to_float(q[base_off + (size_t)(t0 + tb) * tok_stride
                     + (size_t)(r % qpk) * d + i % d]);
    q_s[i] = x;
    acc_s[i] = 0.f;
  }
  __syncthreads();

  // the lower bounds: the document floor of the chunk, and per row the
  // window floor (0 when off)
  const int doc = doc_starts != nullptr ? doc_starts[c] : 0;
  // first and last visible cache position per row; lim -1 for pad rows
  int lo_r[ROWS], lim[ROWS];
  float m[ROWS], l[ROWS], s[ROWS], acc[ROWS][E];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    lim[r] = (r < rows && r / qpk < nvalid) ? start + t0 + r / qpk : -1;
    lo_r[r] = max(doc, window > 0 ? lim[r] - (window - 1) : 0);
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.f;
  }

  // keys [kv_lo, kv_len) are needed: the first row's floor has the
  // lowest position, the last valid row the highest
  const int kv_lo = max(0, max(doc, window > 0 ? start + t0 - (window - 1) : 0));
  const int kv_len = start + t0 + nvalid;
  // valid rows of this block: the loops below stop there, so a decode row
  // padded to a wide chunk pays for one row, not ROWS (block-uniform)
  const int vrows = nvalid * qpk;
  const int ntiles = (kv_len - kv_lo + KT - 1) / KT;
  const int cpr = d / VEC;  // 16-byte copies per key row
  const int* pt_row = page_table + (size_t)c * max_pages;

  for (int tile = warp; tile < ntiles; tile += nw) {
    const int base = kv_lo + tile * KT;
    for (int i = lane; i < KT * cpr; i += 32) {
      const int kr = i / cpr;
      const int ch = i - kr * cpr;
      const int pos = base + kr;
      const bool ok = pos < kv_len;
      size_t off = 0;
      if (ok) {
        const int page = pt_row[pos / page_size];
        off = (((size_t)page * page_size + pos % page_size) * G + gi) * d
              + (size_t)ch * VEC;
      }
      cp_async16(k_w + kr * ld + ch * VEC, kp + off, ok);
      cp_async16(v_w + kr * ld + ch * VEC, vp + off, ok);
    }
    // this lane's key: its position and, for int8 pools, its scales
    const int pos = base + lane;
    float k_sc = 1.f, v_sc = 1.f;
    if (QUANT && pos < kv_len) {
      const size_t srow = ((size_t)pt_row[pos / page_size] * page_size
                           + pos % page_size) * G + gi;
      k_sc = ks[srow];
      v_sc = vs[srow];
    }
    cp_async_wait_all();
    __syncwarp();

    // scores of this lane's key against every row
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r] = 0.f;
    const KV* krow = k_w + lane * ld;
    for (int j = 0; j < d; j += 8) {
      float kf[8];
      load8(krow + j, kf);
      if (QUANT) {
#pragma unroll
        for (int i = 0; i < 8; ++i) kf[i] *= k_sc;
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (r >= vrows) break;
        const float4 a = *reinterpret_cast<const float4*>(q_s + r * d + j);
        const float4 b = *reinterpret_cast<const float4*>(q_s + r * d + j + 4);
        float acc_s8 = s[r];
        acc_s8 = fmaf(a.x, kf[0], acc_s8);
        acc_s8 = fmaf(a.y, kf[1], acc_s8);
        acc_s8 = fmaf(a.z, kf[2], acc_s8);
        acc_s8 = fmaf(a.w, kf[3], acc_s8);
        acc_s8 = fmaf(b.x, kf[4], acc_s8);
        acc_s8 = fmaf(b.y, kf[5], acc_s8);
        acc_s8 = fmaf(b.z, kf[6], acc_s8);
        acc_s8 = fmaf(b.w, kf[7], acc_s8);
        s[r] = acc_s8;
      }
    }

    // online softmax; s[r] becomes this lane's p, rounded like v
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (r >= vrows) break;
      const bool vis = pos <= lim[r] && pos >= lo_r[r];
      const float sc = vis ? s[r] * scale_log2 : -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(sc));
      if (m_new == -INFINITY) {  // nothing visible to this row yet
        s[r] = 0.f;
        continue;
      }
      const float alpha = m[r] == -INFINITY ? 0.f : exp2f(m[r] - m_new);
      const float p = vis ? exp2f(sc - m_new) : 0.f;
      l[r] = l[r] * alpha + warp_sum(p);
#pragma unroll
      for (int e = 0; e < E; ++e) acc[r][e] *= alpha;
      m[r] = m_new;
      s[r] = round_like<KV>(p);
    }

    // acc[r][:] += sum_k p[r][k] * v[k][lane's columns]
    const int nkeys = min(KT, kv_len - base);
    for (int k = 0; k < nkeys; ++k) {
      float vf[E];
      const KV* vrow = v_w + k * ld + lane * E;
      const float vsk = QUANT ? __shfl_sync(FULL, v_sc, k) : 1.f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        vf[e] = lane * E + e < d ? to_float(vrow[e]) : 0.f;
        if (QUANT) vf[e] *= vsk;
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (r >= vrows) break;
        const float pk = __shfl_sync(FULL, s[r], k);
#pragma unroll
        for (int e = 0; e < E; ++e) acc[r][e] = fmaf(pk, vf[e], acc[r][e]);
      }
    }
    __syncwarp();  // the staging buffer is refilled next tile
  }

  // merge the warps' states in warp order
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      m_s[warp * ROWS + r] = m[r];
      l_s[warp * ROWS + r] = l[r];
    }
  }
  __syncthreads();
  if (tid < ROWS) {
    float mx = -INFINITY;
    for (int w = 0; w < nw; ++w) mx = fmaxf(mx, m_s[w * ROWS + tid]);
    float sum = 0.f;
    for (int w = 0; w < nw; ++w) {
      const float mw = m_s[w * ROWS + tid];
      if (mw != -INFINITY) sum += l_s[w * ROWS + tid] * exp2f(mw - mx);
    }
    stat_s[tid] = mx;
    stat_s[ROWS + tid] = sum;
  }
  __syncthreads();
  for (int w = 0; w < nw; ++w) {
    if (warp == w) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float sc = m[r] == -INFINITY ? 0.f : exp2f(m[r] - stat_s[r]);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int col = lane * E + e;
          if (col < d) acc_s[r * d + col] += acc[r][e] * sc;
        }
      }
    }
    __syncthreads();
  }

  const int ntok = min(bq, C - t0);
  for (int i = tid; i < ntok * qpk * d; i += blockDim.x) {
    const int r = i / d;
    const int tb = r / qpk;
    float x = 0.f;
    if (tb < nvalid) x = acc_s[i] / fmaxf(stat_s[ROWS + r], 1e-30f);
    out[base_off + (size_t)(t0 + tb) * tok_stride + i % (qpk * d)] = from_float<T>(x);
  }
}

struct Args {
  const void *q, *kp, *vp;
  const float *ks, *vs;
  void* out;
  const int *pt, *starts, *lens, *doc;
  int nc, C, G, qpk, d, page_size, max_pages, window, bq;
  float scale_log2;
  cudaStream_t stream;
};

template <typename T, typename KV, int ROWS, int E>
int launch(const Args& a) {
  // 4 warps unless their staging does not fit the 227 KB a block may use
  // (fp32 pools at d > 128)
  const size_t per_warp = 2 * (size_t)KT * (a.d + 16 / sizeof(KV)) * sizeof(KV);
  int nw = MAX_WARPS;
  while (nw > 1 && stats_bytes(ROWS, a.d) + nw * per_warp > 200 * 1024) nw >>= 1;
  const size_t smem = stats_bytes(ROWS, a.d) + nw * per_warp;
  auto kernel = ragged_paged_attn_kernel<T, KV, ROWS, E>;
  static size_t smem_set = 0;  // the attribute is raised once per size
  if (smem > 48 * 1024 && smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  dim3 grid((a.C + a.bq - 1) / a.bq, a.G, a.nc);
  kernel<<<grid, nw * 32, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const KV*>(a.kp),
      static_cast<const KV*>(a.vp), a.ks, a.vs, static_cast<T*>(a.out), a.pt,
      a.starts, a.lens, a.doc, a.C, a.G, a.qpk, a.d, a.page_size,
      a.max_pages, a.window, a.bq, a.scale_log2);
  return (int)cudaGetLastError();
}

template <typename T, typename KV, int ROWS>
int dispatch_e(const Args& a) {
  if (a.d <= 32) return launch<T, KV, ROWS, 1>(a);
  if (a.d <= 64) return launch<T, KV, ROWS, 2>(a);
  if (a.d <= 128) return launch<T, KV, ROWS, 4>(a);
  return launch<T, KV, ROWS, 8>(a);
}

template <typename T, typename KV>
int dispatch_rows(Args a) {
  int bq = MAX_ROWS / a.qpk;
  if (bq > a.C) bq = a.C;
  if (bq < 1) bq = 1;
  a.bq = bq;
  const int rows = bq * a.qpk;
  if (rows <= 1) return dispatch_e<T, KV, 1>(a);
  if (rows <= 2) return dispatch_e<T, KV, 2>(a);
  if (rows <= 4) return dispatch_e<T, KV, 4>(a);
  if (rows <= 8) return dispatch_e<T, KV, 8>(a);
  return dispatch_e<T, KV, 16>(a);
}

}  // namespace

// q, out: (nc, C, G, qpk, d) contiguous; k_pages, v_pages: (P, page_size,
// G, d) contiguous and 16-byte aligned, of q's dtype or (kv_int8) int8
// with k_scales, v_scales (P, page_size, G) fp32; page_table: (nc,
// max_pages) int32; starts, chunk_lens and doc_starts (or null): (nc,)
// int32; window: W, 0 for none. dtype: 0 = float32, 1 = bfloat16. The
// wrapper checks d % 8 == 0 (d % 16 for int8), d <= 256, 1 <= qpk <= 16,
// C >= 1 and doc_starts <= starts. Returns the cudaError_t of the launch.
extern "C" int ragged_paged_attention_fwd(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, void* out,
    const void* page_table, const void* starts, const void* chunk_lens,
    const void* doc_starts, int nc, int C, int G, int qpk, int d,
    int page_size, int max_pages, int window, float scale_log2, int dtype,
    int kv_int8, void* stream) {
  if (nc == 0) return 0;
  Args a{q, k_pages, v_pages, static_cast<const float*>(k_scales),
         static_cast<const float*>(v_scales), out,
         static_cast<const int*>(page_table), static_cast<const int*>(starts),
         static_cast<const int*>(chunk_lens),
         static_cast<const int*>(doc_starts), nc, C, G, qpk, d, page_size,
         max_pages, window, 1, scale_log2, static_cast<cudaStream_t>(stream)};
  if (dtype == 1)
    return kv_int8 ? dispatch_rows<__nv_bfloat16, int8_t>(a)
                   : dispatch_rows<__nv_bfloat16, __nv_bfloat16>(a);
  return kv_int8 ? dispatch_rows<float, int8_t>(a)
                 : dispatch_rows<float, float>(a);
}
