// Decode attention for Hopper (sm_90a): one query token per sequence
// attends over a dense per-layer KV cache in the "gtd" layout.
//
// Replaces the Pallas kernel `_decode_kernel` (megatron_llm_tpu/ops/
// decode_attention.py:115, launched by `_decode_pallas` at :238).
//
// What it computes, per (batch b, KV group g), for the group's qpk query
// heads (GQA folded: every K/V row is read once and serves all heads):
//   s[h, t] = (q[h] . k[t]) * sm_scale * log2(e)      fp32, t < length
//   exp2-domain online softmax over t, p cast to v's dtype before the PV
//   product, fp32 accumulation, out[h] = acc[h] / max(l[h], 1e-30).
// Cache positions at or past `length` are never read (the TPU kernel's
// clamped index map did the same with its DMAs).
//
// What bounds it on the H100: bytes. Per call it must read 2*b*g*length*d
// elements of K/V; its arithmetic is ~4 flops per element, far below the
// card's ~295 flops/byte balance point. The design therefore aims at
// streaming K/V once with wide loads:
//   - one block per (b, g); its warps split the valid positions
//     [0, length) round-robin, so neighbouring warps read neighbouring rows;
//   - within a warp, `lpr` lanes cover one row of d elements with 16-byte
//     loads and the warp holds 32/lpr rows in flight; each row group keeps
//     its own online-softmax state (m, l, acc) per head in registers;
//   - the states merge first across the row groups of a warp with
//     shuffles, then across warps through shared memory in warp order (so
//     the result is deterministic run to run).
// The query block is staged in shared memory as fp32. The kernel launches
// on the caller's stream and allocates nothing.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

template <typename T> struct VecN;
template <> struct VecN<float> { static constexpr int value = 4; };
template <> struct VecN<__nv_bfloat16> { static constexpr int value = 8; };

__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
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

// T: element type. QPK: qpk rounded up to a power of two (registers are
// sized by it; heads >= qpk are skipped). MAXC: 16-byte chunks per lane
// per row. NW: warps per block.
template <typename T, int QPK, int MAXC, int NW>
__global__ void __launch_bounds__(NW * 32)
decode_attn_gtd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       int G, int qpk, int d, int T_alloc, int length,
                       float scale_log2) {
  constexpr int VEC = VecN<T>::value;
  constexpr int E = MAXC * VEC;  // elements of a row one lane owns
  extern __shared__ float smem[];
  float* q_s = smem;                     // [qpk * d]
  float* acc_s = q_s + qpk * d;          // [qpk * d]
  float* m_s = acc_s + qpk * d;          // [NW * QPK]
  float* l_s = m_s + NW * QPK;           // [NW * QPK]
  float* stat_s = l_s + NW * QPK;        // [2 * QPK]: merged max, sum

  const int gi = blockIdx.x;
  const int bi = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int nchunk = d / VEC;
  int lpr = 1;  // lanes per row: power of two with lpr * MAXC >= nchunk
  while (lpr * MAXC < nchunk) lpr <<= 1;
  const int rpw = 32 / lpr;  // rows in flight per warp
  const int sub = lane % lpr;
  const int row = lane / lpr;
  const int ngroups = NW * rpw;

  const size_t bg = (size_t)bi * G + gi;
  const T* qp = q + bg * qpk * d;
  const T* kp = k + bg * T_alloc * d;
  const T* vp = v + bg * T_alloc * d;

  for (int i = tid; i < qpk * d; i += NW * 32) {
    q_s[i] = to_float(qp[i]);
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

  // Warp-uniform trip count: every lane runs the shuffles of every
  // iteration; rows past `length` are neither read nor accumulated.
  for (int base = warp * rpw; base < length; base += ngroups) {
    const int pos = base + row;
    const bool valid = pos < length;
    float kf[E], vf[E];
#pragma unroll
    for (int j = 0; j < MAXC; ++j) {
      const int c = sub + j * lpr;
      if (valid && c < nchunk) {
        load16(kp + (size_t)pos * d + c * VEC, kf + j * VEC);
        load16(vp + (size_t)pos * d + c * VEC, vf + j * VEC);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) { kf[j * VEC + e] = 0.f; vf[j * VEC + e] = 0.f; }
      }
    }
#pragma unroll
    for (int h = 0; h < QPK; ++h) {
      if (h >= qpk) break;  // uniform across the block
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
        s *= scale_log2;
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
  if (tid < qpk) {
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
        if (h >= qpk) break;
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

  T* op = out + bg * qpk * d;
  for (int i = tid; i < qpk * d; i += NW * 32) {
    const float den = fmaxf(stat_s[QPK + i / d], 1e-30f);
    op[i] = from_float<T>(acc_s[i] / den);
  }
}

template <typename T, int QPK, int MAXC>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int G, int qpk, int d, int T_alloc, int length, float scale_log2,
           cudaStream_t stream) {
  // More warps per block where the per-lane state is small; the register
  // budget of a 16-head group needs a smaller block.
  constexpr int NW = QPK <= 2 ? 16 : (QPK <= 8 ? 8 : 4);
  const size_t smem = sizeof(float) * (2 * (size_t)qpk * d + 2 * NW * QPK + 2 * QPK);
  dim3 grid(G, B);
  decode_attn_gtd_kernel<T, QPK, MAXC, NW><<<grid, NW * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), G, qpk, d, T_alloc,
      length, scale_log2);
  return (int)cudaGetLastError();
}

template <typename T, int MAXC>
int dispatch_qpk(const void* q, const void* k, const void* v, void* out,
                 int B, int G, int qpk, int d, int T_alloc, int length,
                 float scale_log2, cudaStream_t s) {
  if (qpk <= 1) return launch<T, 1, MAXC>(q, k, v, out, B, G, qpk, d, T_alloc, length, scale_log2, s);
  if (qpk <= 2) return launch<T, 2, MAXC>(q, k, v, out, B, G, qpk, d, T_alloc, length, scale_log2, s);
  if (qpk <= 4) return launch<T, 4, MAXC>(q, k, v, out, B, G, qpk, d, T_alloc, length, scale_log2, s);
  if (qpk <= 8) return launch<T, 8, MAXC>(q, k, v, out, B, G, qpk, d, T_alloc, length, scale_log2, s);
  return launch<T, 16, MAXC>(q, k, v, out, B, G, qpk, d, T_alloc, length, scale_log2, s);
}

}  // namespace

// q, out: (B, 1, G, qpk, d) contiguous; k, v: (B, G, T_alloc, d)
// contiguous; all 16-byte aligned. dtype: 0 = float32, 1 = bfloat16.
// The wrapper checks d % 8 == 0, d <= 256, 1 <= qpk <= 16 and
// 1 <= length <= T_alloc. Returns the cudaError_t of the launch.
extern "C" int decode_attention_gtd(const void* q, const void* k,
                                    const void* v, void* out, int B, int G,
                                    int qpk, int d, int T_alloc, int length,
                                    float scale_log2, int dtype,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch_qpk<__nv_bfloat16, 1>(q, k, v, out, B, G, qpk, d, T_alloc, length, scale_log2, s);
  return dispatch_qpk<float, 2>(q, k, v, out, B, G, qpk, d, T_alloc, length, scale_log2, s);
}
