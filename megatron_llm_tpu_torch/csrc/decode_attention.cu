// Decode attention for Hopper (sm_90a): one query token per sequence
// attends over a dense per-layer KV cache, with the cache length split
// across blocks.
//
// Replaces the Pallas kernel `_decode_kernel` (megatron_llm_tpu/ops/
// decode_attention.py:115, launched by `_decode_pallas` at :238), in both
// of its cache layouts and at its row count (qpk up to MAX_DECODE_ROWS =
// 128).
//
// What it computes, per (batch b, KV group g), for the group's qpk query
// heads (GQA folded: every K/V row a block reads serves all its heads):
//   s[h, t] = (q[h] . k[t]) * sm_scale * log2(e)      fp32, t < length
//   exp2-domain online softmax over t, p rounded to v's dtype before the
//   PV product, fp32 accumulation, out[h] = acc[h] / max(l[h], 1e-30).
// Cache positions at or past `length` are never read (the TPU kernel's
// clamped index map did the same with its DMAs). K and V are addressed
// through batch, group and position strides, so the "gtd" layout (b, g,
// T, d) and the "tgd" layout (b, T, g, d), one layer's slice of a stacked
// (L, b, T, g, d) cache, are both read in place. `length` is a host int
// or an int32 on the card (read by every block), so one launch, whose grid
// depends on the allocated T and the shapes alone, can be captured in a
// CUDA graph and replayed at any length.
//
// What bounds it on the H100: bytes. Per call it must read 2*b*g*length*d
// elements of K/V; its arithmetic is 4 * qpk flops per element. One block
// per (b, g), the earlier design, put 128 blocks on 132 SMs at b 4, g 32,
// each walking its cache alone with 32 rows in flight, its dot products
// reduced across lanes with shuffles: latency, not bandwidth, set its time
// (2.45x the bound), and at qpk 8 the shuffles and per-row softmax
// updates on CUDA cores cost more than the bytes. This design:
//   - grid (nsplit, g * nhc, b): the cache dimension is cut into nsplit
//     splits of S positions, and the heads of a group into nhc chunks of
//     at most 16 (qpk 1..128; a group of qpk > 16 reads its K/V once per
//     chunk, from L2 after the first);
//   - the split rule (`plan`): aim at 6 x 132 blocks for bf16 (4 x 132
//     for fp32), so that every SM has several splits in flight whatever b
//     and g are: nsplit = ceil(target / (b * g * nhc)), at most 64 and at
//     most ceil(T / R), where R is the positions a block covers in one
//     pass (64 for bf16); then S = ceil(T / nsplit) rounded up to a
//     multiple of R, and nsplit = ceil(T / S);
//   - bf16 (the serving path), on the tensor cores: the block's 16 query
//     rows are the chunk's heads; each of its 4 warps streams a quarter of
//     the split in steps of 16 positions through two shared-memory stages
//     of its own (cp.async, 16 bytes a copy) and runs S = Q K^T and O +=
//     bf16(P) V on mma.sync m16n8k16 (V through ldmatrix .trans), the
//     online softmax on the S fragments; a row that is not a head of the
//     chunk is zeros. The warps' states merge through shared memory in
//     warp order;
//   - fp32, on CUDA cores (every product in fp32, as the reference): `lpr`
//     lanes cover one row of d elements with 16-byte loads, a warp holds
//     32 / lpr rows, each lane loads U rows before it computes on them;
//     every row group keeps an online-softmax state per head in registers,
//     merged across the row groups of a warp with shuffles, then across
//     warps in warp order;
//   - blocks whose split starts at or past `length` return before reading
//     anything. The only live split writes the output itself; otherwise
//     each live split writes its fp32 (m, l, acc) per head to a workspace
//     the wrapper allocates, and a merge combines the live splits in split
//     order (the same bits run to run): the last block of each (b, g,
//     head chunk) to finish, found with an arrival counter that it resets
//     to 0 (so that graph replays start clean). A second, small merge
//     launch was measured slower at every timed shape (PERF.md).
// The kernels launch on the caller's stream and allocate nothing.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int NW = 4;            // warps a block
constexpr int MAX_SPLITS = 64;
constexpr int MAX_HEADS = 16;    // heads a block: one chunk of the group
constexpr int TARGET_BLOCKS_PER_SM = 4;  // fp32 (CUDA cores)
constexpr int MMA_BLOCKS_PER_SM = 6;     // bf16 (tensor cores)

template <typename T> struct VecN;
template <> struct VecN<float> { static constexpr int value = 4; };
template <> struct VecN<__nv_bfloat16> { static constexpr int value = 8; };

__device__ __forceinline__ void unpack(const uint4& v, float* out, float) {
  out[0] = __uint_as_float(v.x); out[1] = __uint_as_float(v.y);
  out[2] = __uint_as_float(v.z); out[3] = __uint_as_float(v.w);
}

__device__ __forceinline__ void unpack(const uint4& v, float* out,
                                       __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// p rounded to the value dtype, as the TPU kernel feeds its PV matmul
template <typename T> __device__ __forceinline__ float round_like(float p) {
  return to_float(from_float<T>(p));
}

// Weight of a softmax state with running max m when the merged max is mx.
__device__ __forceinline__ float rescale(float m, float mx) {
  return m == -INFINITY ? 0.f : exp2f(m - mx);
}

struct Shape {
  int B, G, qpk, d, T_alloc, S, nsplit, nhc;
  long long sb, sg, st;  // K/V strides in elements: batch, group, position
  float scale_log2;
};

// The valid length, clamped to [0, T_alloc], and the splits it reaches
// (at least one, so that length 0 still writes its zeros).
__device__ __forceinline__ void live(const int* len_ptr, int length,
                                     const Shape& sh, int& len, int& nlive) {
  len = len_ptr != nullptr ? *len_ptr : length;
  len = min(max(len, 0), sh.T_alloc);
  nlive = max(1, (len + sh.S - 1) / sh.S);
}

// Workspace of fp32: the (m, l) pairs of every part, then their acc rows
// of d; part = ((b * G + g) * qpk + h) * nsplit + split.
__device__ __forceinline__ size_t part_of(const Shape& sh, int b, int g,
                                          int h) {
  return (((size_t)b * sh.G + g) * sh.qpk + h) * sh.nsplit;
}

__device__ __forceinline__ size_t acc_base(const Shape& sh) {
  return 2 * (size_t)sh.B * sh.G * sh.qpk * sh.nsplit;
}

// out for heads [h0, h0 + nh) of (b, g): the live splits' partial states
// merged in split order, by the whole block: each head's weights (its
// splits' maxima against their largest) and sum go to shared memory once,
// then every element reads its nlive partial values, which are
// independent loads.
template <typename T>
__device__ void merge_splits(const float* __restrict__ ws,
                             T* __restrict__ out, const Shape& sh, int b,
                             int g, int h0, int nh, int nlive, int tid,
                             int nthreads) {
  __shared__ float w_s[MAX_HEADS][MAX_SPLITS];
  __shared__ float l_s[MAX_HEADS];
  for (int i = tid; i < nh * nlive; i += nthreads)
    w_s[i / nlive][i % nlive] =
        __ldcg(ws + 2 * (part_of(sh, b, g, h0 + i / nlive) + i % nlive));
  __syncthreads();
  if (tid < nh) {
    const size_t p0 = part_of(sh, b, g, h0 + tid);
    float mx = -INFINITY;
    for (int s = 0; s < nlive; ++s) mx = fmaxf(mx, w_s[tid][s]);
    float l = 0.f;
    for (int s = 0; s < nlive; ++s) {
      const float w = rescale(w_s[tid][s], mx);
      l += __ldcg(ws + 2 * (p0 + s) + 1) * w;
      w_s[tid][s] = w;
    }
    l_s[tid] = fmaxf(l, 1e-30f);
  }
  __syncthreads();
  const float* acc = ws + acc_base(sh);
  T* op = out + ((size_t)b * sh.G + g) * sh.qpk * sh.d;
  for (int i = tid; i < nh * sh.d; i += nthreads) {
    const int h = i / sh.d, c = i % sh.d;
    const float* ap = acc + part_of(sh, b, g, h0 + h) * sh.d + c;
    float a = 0.f;
#pragma unroll 8
    for (int s = 0; s < nlive; ++s) a += __ldcg(ap + (size_t)s * sh.d) * w_s[h][s];
    op[(size_t)(h0 + h) * sh.d + c] = from_float<T>(a / l_s[h]);
  }
}

// The end of a split's block (NT threads), once its combined state is in
// shared memory: acc of head h at acc_s[h * ld + c], its max and sum at
// mx_s[h] and sum_s[h]. The only live split normalises and writes the
// output; otherwise the split's partial state goes to the workspace and
// the last block of its (b, g, head chunk) to arrive merges every live
// split in split order and resets the arrival counter.
template <typename T>
__device__ void finish_split(const float* acc_s, int ld, const float* mx_s,
                             const float* sum_s, T* __restrict__ out,
                             float* __restrict__ ws,
                             unsigned* __restrict__ counters, const Shape& sh,
                             int bi, int gi, int h0, int nh, int split,
                             int nlive, int* last_s) {
  const int d = sh.d, tid = threadIdx.x, nt = blockDim.x;
  if (nlive == 1) {  // the only live split: normalise and write
    T* op = out + (((size_t)bi * sh.G + gi) * sh.qpk + h0) * d;
    for (int i = tid; i < nh * d; i += nt)
      op[i] = from_float<T>(acc_s[(i / d) * ld + i % d]
                            / fmaxf(sum_s[i / d], 1e-30f));
    return;
  }
  for (int i = tid; i < nh * d; i += nt) {
    const size_t p = part_of(sh, bi, gi, h0 + i / d) + split;
    ws[acc_base(sh) + p * d + i % d] = acc_s[(i / d) * ld + i % d];
    if (i % d == 0) {
      ws[2 * p] = mx_s[i / d];
      ws[2 * p + 1] = sum_s[i / d];
    }
  }
  __threadfence();
  __syncthreads();
  unsigned* counter = counters + (size_t)bi * sh.G * sh.nhc + blockIdx.y;
  if (tid == 0) *last_s = atomicAdd(counter, 1u) == (unsigned)(nlive - 1);
  __syncthreads();
  if (!*last_s) return;
  __threadfence();
  if (tid == 0) *counter = 0u;
  merge_splits<T>(ws, out, sh, bi, gi, h0, nh, nlive, tid, nt);
}

// The CUDA-core design. T: element type. QPK: heads a block, a power of two
// <= 16 (registers are sized by it; heads past the chunk's are skipped).
// MAXC: 16-byte chunks a lane owns of a row. U: rows a lane loads before computing on them.
template <typename T, int QPK, int MAXC, int U>
__global__ void __launch_bounds__(NW * 32)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ out,
                    float* __restrict__ ws, unsigned* __restrict__ counters,
                    const int* __restrict__ len_ptr, int length,
                    Shape sh) {
  constexpr int VEC = VecN<T>::value;
  constexpr int E = MAXC * VEC;  // elements of a row one lane owns
  const int d = sh.d;
  extern __shared__ float smem[];
  float* q_s = smem;                     // [QPK * d]
  float* acc_s = q_s + QPK * d;          // [QPK * d]
  float* m_s = acc_s + QPK * d;          // [NW * QPK]
  float* l_s = m_s + NW * QPK;           // [NW * QPK]
  float* stat_s = l_s + NW * QPK;        // [2 * QPK]: merged max, sum
  __shared__ int last_s;

  int len, nlive;
  live(len_ptr, length, sh, len, nlive);
  const int split = blockIdx.x;
  if (split >= nlive) return;  // reads nothing, writes nothing
  const int gi = blockIdx.y / sh.nhc, hc = blockIdx.y % sh.nhc;
  const int bi = blockIdx.z;
  const int h0 = hc * MAX_HEADS;
  const int nh = min(QPK, sh.qpk - h0);
  const int p0 = split * sh.S, p1 = min(p0 + sh.S, len);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int nchunk = d / VEC;
  int lpr = 1;  // lanes per row: power of two with lpr * MAXC >= nchunk
  while (lpr * MAXC < nchunk) lpr <<= 1;
  const int rpw = 32 / lpr;  // rows in flight per warp and pass of u
  const int sub = lane % lpr;
  const int row = lane / lpr;
  const int step = NW * rpw * U;  // positions a block covers in one pass

  const size_t bg = (size_t)bi * sh.G + gi;
  const T* qp = q + (bg * sh.qpk + h0) * d;
  const T* kp = k + (size_t)bi * sh.sb + (size_t)gi * sh.sg;
  const T* vp = v + (size_t)bi * sh.sb + (size_t)gi * sh.sg;

  // rows u of the pass at `base` into kr / vr (zeros past p1)
  uint4 kr[U][MAXC], vr[U][MAXC];
  auto load_pass = [&](int base) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int pos = base + (u * NW + warp) * rpw + row;
#pragma unroll
      for (int j = 0; j < MAXC; ++j) {
        const int c = sub + j * lpr;
        if (pos < p1 && c < nchunk) {
          const size_t off = (size_t)pos * sh.st + c * VEC;
          kr[u][j] = *reinterpret_cast<const uint4*>(kp + off);
          vr[u][j] = *reinterpret_cast<const uint4*>(vp + off);
        } else {
          kr[u][j] = make_uint4(0u, 0u, 0u, 0u);
          vr[u][j] = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    }
  };
  load_pass(p0);  // in flight while q is staged

  for (int i = tid; i < QPK * d; i += NW * 32) {
    q_s[i] = i < nh * d ? to_float(qp[i]) : 0.f;
    acc_s[i] = 0.f;
  }
  __syncthreads();

  float m[QPK], l[QPK], acc[QPK][E];
#pragma unroll
  for (int h = 0; h < QPK; ++h) {
    m[h] = -INFINITY;
    l[h] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[h][e] = 0.f;
  }

  // Warp-uniform trip count: every lane runs the shuffles of every pass;
  // rows at or past p1 are neither read nor accumulated.
  for (int base = p0; base < p1; base += step) {
    if (base > p0) load_pass(base);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int pos = base + (u * NW + warp) * rpw + row;
      const bool valid = pos < p1;
      float kf[E], vf[E];
#pragma unroll
      for (int j = 0; j < MAXC; ++j) {
        unpack(kr[u][j], kf + j * VEC, T());
        unpack(vr[u][j], vf + j * VEC, T());
      }
#pragma unroll
      for (int h = 0; h < QPK; ++h) {
        if (h >= nh) break;  // uniform across the block
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < MAXC; ++j) {
          const int c = sub + j * lpr;
          if (c < nchunk) {
            const float* qh = q_s + h * d + c * VEC;
#pragma unroll
            for (int e = 0; e < VEC; ++e) s = fmaf(qh[e], kf[j * VEC + e], s);
          }
        }
        for (int off = lpr >> 1; off > 0; off >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        if (valid) {
          s *= sh.scale_log2;
          const float m_new = fmaxf(m[h], s);
          const float alpha = rescale(m[h], m_new);
          const float p = exp2f(s - m_new);
          l[h] = l[h] * alpha + p;
          const float pc = round_like<T>(p);
#pragma unroll
          for (int e = 0; e < E; ++e) acc[h][e] = fmaf(pc, vf[e], acc[h][e] * alpha);
          m[h] = m_new;
        }
      }
    }
  }

  // Merge the row groups of this warp: lanes lane and lane^off own the
  // same chunk of a row in two different groups.
  for (int off = lpr; off < 32; off <<= 1) {
#pragma unroll
    for (int h = 0; h < QPK; ++h) {
      const float m_o = __shfl_xor_sync(0xffffffffu, m[h], off);
      const float l_o = __shfl_xor_sync(0xffffffffu, l[h], off);
      const float mx = fmaxf(m[h], m_o);
      const float a = rescale(m[h], mx);
      const float b = rescale(m_o, mx);
      l[h] = l[h] * a + l_o * b;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float acc_o = __shfl_xor_sync(0xffffffffu, acc[h][e], off);
        acc[h][e] = acc[h][e] * a + acc_o * b;
      }
      m[h] = mx;
    }
  }

  // Merge across warps in warp order.
  if (lane == 0) {
#pragma unroll
    for (int h = 0; h < QPK; ++h) {
      m_s[warp * QPK + h] = m[h];
      l_s[warp * QPK + h] = l[h];
    }
  }
  __syncthreads();
  if (tid < QPK) {
    float mx = -INFINITY;
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, m_s[w * QPK + tid]);
    float sum = 0.f;
    for (int w = 0; w < NW; ++w) sum += l_s[w * QPK + tid] * rescale(m_s[w * QPK + tid], mx);
    stat_s[tid] = mx;
    stat_s[QPK + tid] = sum;
  }
  __syncthreads();
  for (int w = 0; w < NW; ++w) {
    if (warp == w && lane < lpr) {
#pragma unroll
      for (int h = 0; h < QPK; ++h) {
        if (h >= nh) break;
        const float sc = rescale(m[h], stat_s[h]);
#pragma unroll
        for (int j = 0; j < MAXC; ++j) {
          const int c = sub + j * lpr;
          if (c < nchunk) {
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              acc_s[h * d + c * VEC + e] += acc[h][j * VEC + e] * sc;
          }
        }
      }
    }
    __syncthreads();
  }

  finish_split<T>(acc_s, d, stat_s, stat_s + QPK, out, ws, counters, sh, bi,
                  gi, h0, nh, split, nlive, &last_s);
}

// --- bf16: the products on the tensor cores (mma.sync m16n8k16) ---------

typedef __nv_bfloat16 bf16;
constexpr int MW = 4;    // warps of a tensor-core block
constexpr int MT = 16;   // positions a warp takes a step
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(hopper::smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Two B fragments (k16 x n8 each, n-tiles side by side) of a row-major
// [k][n] tile in shared memory, transposed on the way (ldmatrix .trans):
// lane l gives the address of row (l & 7) + 8 ((l >> 3) & 1) of column
// block l >> 4.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(hopper::smem_u32(p)));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int DP>
struct MmaLayout {
  static constexpr int PITCH = DP + 8;  // bf16 a shared row: no bank conflicts
  static constexpr int Q_ELEMS = 16 * PITCH;
  static constexpr int WARP_ELEMS = 2 * 2 * MT * PITCH;  // 2 stages of K, V
  static constexpr size_t SMEM = 2 * (size_t)(Q_ELEMS + MW * WARP_ELEMS);
};

// Grid (nsplit, g * nhc, b); MW warps. The block's 16 query rows are the
// head chunk's heads (rows past the chunk's are zeros); warp w streams the
// w-th quarter of the split in steps of 16 positions through its own two
// shared-memory stages (cp.async, 16 bytes a copy; rows at or past the
// split's end are zeros, never read), and per step runs S = Q K^T (two
// n8 tiles) and O += bf16(P) V (V through ldmatrix .trans) on mma.sync,
// with the online softmax on the S fragments. The four warps' states then
// merge in warp order through shared memory.
template <int DP>
__global__ void __launch_bounds__(MW * 32)
decode_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ out,
                  float* __restrict__ ws, unsigned* __restrict__ counters,
                  const int* __restrict__ len_ptr, int length, Shape sh) {
  using L = MmaLayout<DP>;
  constexpr int P = L::PITCH;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  __shared__ float m_s[MW][16], l_s[MW][16], mx_s[16], sum_s[16];
  __shared__ int last_s;

  int len, nlive;
  live(len_ptr, length, sh, len, nlive);
  const int split = blockIdx.x;
  if (split >= nlive) return;  // reads nothing, writes nothing
  const int gi = blockIdx.y / sh.nhc, hc = blockIdx.y % sh.nhc;
  const int bi = blockIdx.z;
  const int h0 = hc * MAX_HEADS;
  const int nh = min(MAX_HEADS, sh.qpk - h0);
  const int d = sh.d;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int p0 = split * sh.S, p1 = min(p0 + sh.S, len);
  const int quarter = sh.S / MW;  // a multiple of MT
  const int w0 = p0 + warp * quarter, w1 = min(w0 + quarter, p1);
  const int nsteps = w1 > w0 ? (w1 - w0 + MT - 1) / MT : 0;

  const bf16* kp = k + (size_t)bi * sh.sb + (size_t)gi * sh.sg;
  const bf16* vp = v + (size_t)bi * sh.sb + (size_t)gi * sh.sg;
  bf16* Ws = Qs + L::Q_ELEMS + warp * L::WARP_ELEMS;

  // K and V rows [t0, t0 + 16) of this warp into stage st; rows at or
  // past w1 and columns past d are zeros
  auto load_step = [&](int st, int t0) {
    for (int e = lane; e < 2 * MT * (DP / 8); e += 32) {
      const int which = e / (MT * (DP / 8));
      const int r = (e / (DP / 8)) % MT, col = (e % (DP / 8)) * 8;
      const int pos = t0 + r;
      bf16* dst = Ws + ((st * 2 + which) * MT + r) * P + col;
      if (pos < w1 && col < d)
        cp_async16(dst, (which ? vp : kp) + (size_t)pos * sh.st + col);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  };
  if (nsteps > 0) load_step(0, w0);
  cp_async_commit();

  const bf16* qp = q + (((size_t)bi * sh.G + gi) * sh.qpk + h0) * d;
  for (int i = tid; i < 16 * (DP / 8); i += MW * 32) {
    const int row = i / (DP / 8), col = (i % (DP / 8)) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (row < nh && col < d)
      x = *reinterpret_cast<const uint4*>(qp + (size_t)row * d + col);
    *reinterpret_cast<uint4*>(Qs + row * P + col) = x;
  }
  __syncthreads();

  const int nk = (d + 15) / 16;  // 16-deep slices of the head dimension
  float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;
  float acc[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int i = 0; i < nsteps; ++i) {
    const int t0 = w0 + i * MT;
    if (i + 1 < nsteps) load_step((i + 1) & 1, t0 + MT);
    cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();
    const bf16* Ks = Ws + ((i & 1) * 2) * MT * P;
    const bf16* Vs = Ks + MT * P;

    float s0[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      if (kk < nk) {
        const bf16* qa = Qs + kk * 16 + 2 * tg;
        const uint32_t a[4] = {ld32(qa + g * P), ld32(qa + (g + 8) * P),
                               ld32(qa + g * P + 8),
                               ld32(qa + (g + 8) * P + 8)};
        const bf16* kb = Ks + kk * 16 + 2 * tg;
        const uint32_t b0[2] = {ld32(kb + g * P), ld32(kb + g * P + 8)};
        const uint32_t b1[2] = {ld32(kb + (g + 8) * P),
                                ld32(kb + (g + 8) * P + 8)};
        mma_bf16(s0, a, b0);
        mma_bf16(s1, a, b1);
      }
    }
    // positions t0 + 2 tg + e (s0) and + 8 (s1); rows g (x[0..1]) and
    // g + 8 (x[2..3])
    float mx_a = NEG_INF, mx_b = NEG_INF;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool v0 = t0 + 2 * tg + e < w1, v1 = t0 + 8 + 2 * tg + e < w1;
      s0[e] = v0 ? s0[e] * sh.scale_log2 : NEG_INF;
      s0[2 + e] = v0 ? s0[2 + e] * sh.scale_log2 : NEG_INF;
      s1[e] = v1 ? s1[e] * sh.scale_log2 : NEG_INF;
      s1[2 + e] = v1 ? s1[2 + e] * sh.scale_log2 : NEG_INF;
      mx_a = fmaxf(mx_a, fmaxf(s0[e], s1[e]));
      mx_b = fmaxf(mx_b, fmaxf(s0[2 + e], s1[2 + e]));
    }
    const float mn_a = fmaxf(m_a, hopper::quad_max(mx_a));
    const float mn_b = fmaxf(m_b, hopper::quad_max(mx_b));
    const float al_a = exp2f(m_a - mn_a), al_b = exp2f(m_b - mn_b);
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s0[e] = exp2f(s0[e] - mn_a);
      s1[e] = exp2f(s1[e] - mn_a);
      s0[2 + e] = exp2f(s0[2 + e] - mn_b);
      s1[2 + e] = exp2f(s1[2 + e] - mn_b);
      sum_a += s0[e] + s1[e];
      sum_b += s0[2 + e] + s1[2 + e];
    }
    l_a = al_a * l_a + hopper::quad_sum(sum_a);
    l_b = al_b * l_b + hopper::quad_sum(sum_b);
    m_a = mn_a;
    m_b = mn_b;
    uint32_t pa[4];  // p rounded to bf16, the A operand of PV
    hopper::c_to_a(pa, s0, s1);
    const int vrow = (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int j = 0; j < DP / 8; j += 2) {
      acc[j][0] *= al_a; acc[j][1] *= al_a; acc[j][2] *= al_b; acc[j][3] *= al_b;
      acc[j + 1][0] *= al_a; acc[j + 1][1] *= al_a;
      acc[j + 1][2] *= al_b; acc[j + 1][3] *= al_b;
      if (j * 8 < d) {
        uint32_t b[4];
        ldsm_x4_trans(b, Vs + vrow * P + (j + (lane >> 4)) * 8);
        mma_bf16(acc[j], pa, b);
        mma_bf16(acc[j + 1], pa, b + 2);
      }
    }
    __syncwarp();  // every lane is done with this stage before it refills
  }
  cp_async_wait<0>();

  // the warps' states, merged in warp order; each warp's acc goes to its
  // own (now idle) stages as fp32 [16][DP]
  float* accw = reinterpret_cast<float*>(Ws);
  if (tg == 0) {
    m_s[warp][g] = m_a; m_s[warp][g + 8] = m_b;
    l_s[warp][g] = l_a; l_s[warp][g + 8] = l_b;
  }
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int col = j * 8 + 2 * tg;
    accw[g * DP + col] = acc[j][0];
    accw[g * DP + col + 1] = acc[j][1];
    accw[(g + 8) * DP + col] = acc[j][2];
    accw[(g + 8) * DP + col + 1] = acc[j][3];
  }
  __syncthreads();
  if (tid < 16) {
    float mx = NEG_INF;
    for (int w = 0; w < MW; ++w) mx = fmaxf(mx, m_s[w][tid]);
    float sum = 0.f;
    for (int w = 0; w < MW; ++w) sum += l_s[w][tid] * exp2f(m_s[w][tid] - mx);
    mx_s[tid] = mx;
    sum_s[tid] = sum;
  }
  __syncthreads();
  // the block's acc into warp 0's region, element by element
  float* acc0 = reinterpret_cast<float*>(Qs + L::Q_ELEMS);
  for (int i = tid; i < nh * d; i += MW * 32) {
    const int h = i / d, c = i % d;
    float a = 0.f;
    for (int w = 0; w < MW; ++w)
      a += reinterpret_cast<const float*>(Qs + L::Q_ELEMS
                                          + w * L::WARP_ELEMS)[h * DP + c]
           * exp2f(m_s[w][h] - mx_s[h]);
    acc0[h * DP + c] = a;
  }
  __syncthreads();
  finish_split<bf16>(acc0, DP, mx_s, sum_s, out, ws, counters, sh, bi, gi,
                     h0, nh, split, nlive, &last_s);
}

// The CUDA-core design: heads a block holds (QPK), 16-byte chunks a lane
// owns (MAXC), rows a lane loads ahead (U), and the positions a block
// covers in one pass.
struct Config {
  int qpk_t, u, step;
};

Config config(int qpk, int d, int dtype) {
  Config c;
  c.qpk_t = qpk <= 1 ? 1 : qpk <= 2 ? 2 : qpk <= 4 ? 4 : qpk <= 8 ? 8 : 16;
  c.u = c.qpk_t <= 2 ? 4 : c.qpk_t <= 8 ? 2 : 1;
  const int maxc = dtype == 1 ? 1 : 2;
  const int nchunk = d / (dtype == 1 ? 8 : 4);
  int lpr = 1;
  while (lpr * maxc < nchunk) lpr <<= 1;
  c.step = NW * (32 / lpr) * c.u;
  return c;
}

int sm_count() {
  static const int n = [] {
    int dev = 0, v = 0;
    if (cudaGetDevice(&dev) != cudaSuccess
        || cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev)
               != cudaSuccess || v <= 0)
      return 132;
    return v;
  }();
  return n;
}

// The split rule of the source note; fills nsplit and S. mma: 1 for the
// tensor-core design, 0 for the CUDA-core one.
void plan(int B, int G, int qpk, int d, int T_alloc, int dtype, int mma,
          int* nsplit, int* S) {
  const int step = mma ? MW * MT : config(qpk, d, dtype).step;
  const int per_sm = mma ? MMA_BLOCKS_PER_SM : TARGET_BLOCKS_PER_SM;
  const long long bgh = (long long)B * G * ((qpk + MAX_HEADS - 1) / MAX_HEADS);
  const long long target = (long long)per_sm * sm_count();
  long long n = (target + bgh - 1) / bgh;
  const long long most = (T_alloc + step - 1) / step;
  n = n < 1 ? 1 : n;
  n = n > MAX_SPLITS ? MAX_SPLITS : n;
  n = n > most ? most : n;
  const int per = (int)((T_alloc + n - 1) / n);
  *S = (per + step - 1) / step * step;
  *nsplit = (T_alloc + *S - 1) / *S;
}

template <typename T, int QPK, int MAXC, int U>
int launch_cuda_cores(const void* q, const void* k, const void* v, void* out,
                      void* ws, void* counters, const int* len_ptr,
                      int length, const Shape& sh, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * (size_t)QPK * sh.d + 2 * NW * QPK
                                       + 2 * QPK);
  dim3 grid(sh.nsplit, sh.G * sh.nhc, sh.B);
  decode_split_kernel<T, QPK, MAXC, U><<<grid, NW * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(ws), static_cast<unsigned*>(counters), len_ptr,
      length, sh);
  return (int)cudaGetLastError();
}

template <typename T, int MAXC, int U2>  // U2: rows ahead at qpk <= 2
int dispatch_cuda_cores(int qpk_t, const void* q, const void* k,
                        const void* v, void* out, void* ws, void* counters,
                        const int* lp, int length, const Shape& sh,
                        cudaStream_t s) {
  switch (qpk_t) {
    case 1: return launch_cuda_cores<T, 1, MAXC, U2>(q, k, v, out, ws, counters, lp, length, sh, s);
    case 2: return launch_cuda_cores<T, 2, MAXC, U2>(q, k, v, out, ws, counters, lp, length, sh, s);
    case 4: return launch_cuda_cores<T, 4, MAXC, 2>(q, k, v, out, ws, counters, lp, length, sh, s);
    case 8: return launch_cuda_cores<T, 8, MAXC, 2>(q, k, v, out, ws, counters, lp, length, sh, s);
    default: return launch_cuda_cores<T, 16, MAXC, 1>(q, k, v, out, ws, counters, lp, length, sh, s);
  }
}

template <int DP>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                void* ws, void* counters, const int* len_ptr, int length,
                const Shape& sh, cudaStream_t stream) {
  using L = MmaLayout<DP>;
  auto kern = decode_mma_kernel<DP>;
  // once per instantiation: never inside a CUDA-graph capture after the
  // first (warm-up) launch
  static const int attr = (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::SMEM);
  if (attr) return attr;
  dim3 grid(sh.nsplit, sh.G * sh.nhc, sh.B);
  kern<<<grid, MW * 32, L::SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out),
      static_cast<float*>(ws), static_cast<unsigned*>(counters), len_ptr,
      length, sh);
  return (int)cudaGetLastError();
}

}  // namespace

// The split plan of a launch: writes nsplit and the split size S (in
// positions). The wrapper sizes the workspace, 2 + d floats for each of
// the b * g * qpk * nsplit parts (none when nsplit is 1), and the counters,
// one unsigned for each of the b * g * ceil(qpk / 16) head chunks, zero
// before the first launch (the merging block leaves them zero).
extern "C" void decode_attention_plan(int B, int G, int qpk, int d,
                                      int T_alloc, int dtype, int mma,
                                      int* nsplit, int* S) {
  plan(B, G, qpk, d, T_alloc, dtype, mma, nsplit, S);
}

// q, out: (B, 1, G, qpk, d) contiguous; k, v: element (b, g, t, c) at
// b * sb + g * sg + t * st + c, every row 16-byte aligned; len_ptr: an
// int32 on the card holding the length, or null for `length`. dtype: 0 =
// float32, 1 = bfloat16; mma: 1 = the tensor-core design (bf16 only), 0 =
// the CUDA-core one. The wrapper checks d % 8 == 0, d <= 256, 1 <= qpk <= 128,
// alignment, and 1 <= length <= T_alloc for a host length (a length on the
// card is clamped to [0, T_alloc]). Returns the cudaError_t of the
// launch.
extern "C" int decode_attention_fwd(const void* q, const void* k,
                                    const void* v, void* out, void* ws,
                                    void* counters, const void* len_ptr,
                                    int length, int B, int G, int qpk, int d,
                                    int T_alloc, long long sb, long long sg,
                                    long long st, float scale_log2,
                                    int dtype, int mma,
                                    void* stream) {
  Shape sh;
  sh.B = B; sh.G = G; sh.qpk = qpk; sh.d = d; sh.T_alloc = T_alloc;
  sh.nhc = (qpk + MAX_HEADS - 1) / MAX_HEADS;
  sh.sb = sb; sh.sg = sg; sh.st = st; sh.scale_log2 = scale_log2;
  plan(B, G, qpk, d, T_alloc, dtype, mma, &sh.nsplit, &sh.S);
  const int* lp = static_cast<const int*>(len_ptr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mma) {
    if (d <= 64) return launch_bf16<64>(q, k, v, out, ws, counters, lp, length, sh, s);
    if (d <= 128) return launch_bf16<128>(q, k, v, out, ws, counters, lp, length, sh, s);
    return launch_bf16<256>(q, k, v, out, ws, counters, lp, length, sh, s);
  }
  const int qpk_t = config(qpk, d, dtype).qpk_t;
  if (dtype == 1)
    return dispatch_cuda_cores<__nv_bfloat16, 1, 4>(qpk_t, q, k, v, out, ws, counters, lp, length, sh, s);
  return dispatch_cuda_cores<float, 2, 4>(qpk_t, q, k, v, out, ws, counters, lp, length, sh, s);
}
