// Hopper (sm_90a) building blocks as inline PTX: shared-memory mbarriers,
// TMA tile loads (cp.async.bulk.tensor; 16-bit tiles swizzled, int8 rows
// plain), wgmma shared-memory descriptors
// for 128-byte-swizzled tiles, the wgmma products the flash and paged
// attention kernels issue, the proxy fence and named barrier that hand
// thread-written shared memory to wgmma, and setmaxnreg. Host side:
// cuTensorMapEncodeTiled, looked up once through the runtime's driver
// entry point so the library links without -lcuda.
//
// The 16-bit helpers take the element type E, bf16 (`__nv_bfloat16`, the
// default) or fp16 (`__half`): the products' PTX type, the rounding of a
// register fragment and the tensor map's data type follow it.
//
// A tile that TMA loads with CU_TENSOR_MAP_SWIZZLE_128B is stored in
// "panels" of 64 16-bit columns (128 bytes a row), each panel a run of rows
// of 128 bytes, 16-byte chunks XOR-swizzled by the row's index mod 8, so 8
// rows (1024 bytes) form one swizzle atom. Every panel starts on a
// 1024-byte boundary, which wgmma's descriptors (base offset 0) assume.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarriers --------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// Makes the barriers' initialisation visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One arrival that also tells the barrier to expect `bytes` from TMA.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Spins until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}

// --- TMA --------------------------------------------------------------------

// The box of `map` at element coordinates (c0 innermost, c1, c2) into dst;
// completion (the box's full size in bytes, out-of-bounds elements zero
// filled) is reported to `bar`.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// --- shared memory written by threads, read by wgmma -------------------------

// Makes this thread's generic-proxy shared-memory writes visible to the
// async proxy (wgmma, TMA); the writers then meet at a barrier before any
// of them issues the product that reads the data.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Named barrier `id` (1..15; 0 is __syncthreads) over `n` threads, a
// multiple of 32.
__device__ __forceinline__ void named_bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// --- register hand-off between warpgroups -----------------------------------

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// --- wgmma ------------------------------------------------------------------

// Descriptor of a K-major operand in a 128-byte-swizzled panel: rows of 64
// bf16 along K, 8-row groups 1024 bytes apart (SBO); the 16-deep slice at
// column 16 k of the panel starts 32 k bytes in.
__device__ __forceinline__ uint64_t desc_k_major(const void* p) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// Descriptor of an MN-major operand (the transposed B of a 16-bit wgmma)
// in 128-byte-swizzled panels: each K row holds 64 consecutive MN elements
// of a panel, 8-row groups along K are 1024 bytes apart (SBO), and the
// next 64 MN elements are the next panel, `panel_bytes` on (LBO).
__device__ __forceinline__ uint64_t desc_mn_major(const void* p,
                                                  uint32_t panel_bytes) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | ((uint64_t)(panel_bytes >> 4) << 16)
         | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N committed groups of this warpgroup are pending
// (groups complete in order).
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous products that own it.
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// The accumulator of m64nN: warp w of the warpgroup holds rows 16 w + g
// and 16 w + g + 8 (g = lane / 4); d[4 j + e] and d[4 j + 2 + e] are
// column 8 j + 2 (lane % 4) + e of those rows, as mma.sync's m16n8 C
// fragment repeated N / 8 times. A from registers is mma.sync's m16n8k16 A
// fragment of each warp's 16 rows.

// D (64 x 64, fp32) += A (64 x 16, shared, K-major) B^T (64 x 16, shared, K-major)
#define HOPPER_WGMMA_SS_N64(TY) \
  asm volatile( \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" \
  "%0, %1, %2, %3, %4, %5, %6, %7," \
  "%8, %9, %10, %11, %12, %13, %14, %15," \
  "%16, %17, %18, %19, %20, %21, %22, %23," \
  "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n" \
  : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
  "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
  "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
  : "l"(da), "l"(db), "r"(1))

template <typename E = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db) {
  if constexpr (std::is_same<E, __half>::value) HOPPER_WGMMA_SS_N64("f16");
  else HOPPER_WGMMA_SS_N64("bf16");
}

// D (64 x 128, fp32) += A (64 x 16, shared, K-major) B^T (128 x 16, shared, K-major)
#define HOPPER_WGMMA_SS_N128(TY) \
  asm volatile( \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {" \
  "%0, %1, %2, %3, %4, %5, %6, %7," \
  "%8, %9, %10, %11, %12, %13, %14, %15," \
  "%16, %17, %18, %19, %20, %21, %22, %23," \
  "%24, %25, %26, %27, %28, %29, %30, %31," \
  "%32, %33, %34, %35, %36, %37, %38, %39," \
  "%40, %41, %42, %43, %44, %45, %46, %47," \
  "%48, %49, %50, %51, %52, %53, %54, %55," \
  "%56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n" \
  : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
  "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
  "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
  "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
  "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
  "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
  "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
  "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
  : "l"(da), "l"(db), "r"(1))

template <typename E = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da, uint64_t db) {
  if constexpr (std::is_same<E, __half>::value) HOPPER_WGMMA_SS_N128("f16");
  else HOPPER_WGMMA_SS_N128("bf16");
}

// D (64 x 64, fp32) += A (64 x 16, 16-bit registers) B (16 x 64, shared, MN-major)
#define HOPPER_WGMMA_RS_N64(TY) \
  asm volatile( \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" \
  "%0, %1, %2, %3, %4, %5, %6, %7," \
  "%8, %9, %10, %11, %12, %13, %14, %15," \
  "%16, %17, %18, %19, %20, %21, %22, %23," \
  "%24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n" \
  : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
  "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
  "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
  : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

template <typename E = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t db) {
  if constexpr (std::is_same<E, __half>::value) HOPPER_WGMMA_RS_N64("f16");
  else HOPPER_WGMMA_RS_N64("bf16");
}

// D (64 x 128, fp32) += A (64 x 16, 16-bit registers) B (16 x 128, shared, MN-major)
#define HOPPER_WGMMA_RS_N128(TY) \
  asm volatile( \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {" \
  "%0, %1, %2, %3, %4, %5, %6, %7," \
  "%8, %9, %10, %11, %12, %13, %14, %15," \
  "%16, %17, %18, %19, %20, %21, %22, %23," \
  "%24, %25, %26, %27, %28, %29, %30, %31," \
  "%32, %33, %34, %35, %36, %37, %38, %39," \
  "%40, %41, %42, %43, %44, %45, %46, %47," \
  "%48, %49, %50, %51, %52, %53, %54, %55," \
  "%56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n" \
  : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
  "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
  "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
  "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
  "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
  "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
  "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
  "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
  : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

template <typename E = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a, uint64_t db) {
  if constexpr (std::is_same<E, __half>::value) HOPPER_WGMMA_RS_N128("f16");
  else HOPPER_WGMMA_RS_N128("bf16");
}

// --- operands and fragments of the attention kernels -------------------------

// The dynamic shared memory rounded up to the 1024-byte boundary that the
// 128-byte swizzle's atoms need.
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// Two fp32 values rounded to E (to nearest even) in one 32-bit register,
// `lo` in the low half.
template <typename E = __nv_bfloat16>
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  if constexpr (std::is_same<E, __half>::value) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// The C fragments of two adjacent 8-wide tiles, rounded to E, as the A
// operand of the next product (16 rows x 16 deep).
template <typename E = __nv_bfloat16>
__device__ __forceinline__ void c_to_a(uint32_t* a, const float* c0,
                                       const float* c1) {
  a[0] = pack<E>(c0[0], c0[1]);
  a[1] = pack<E>(c0[2], c0[3]);
  a[2] = pack<E>(c1[0], c1[1]);
  a[3] = pack<E>(c1[2], c1[3]);
}

// Max and sum over the 4 lanes that hold one accumulator row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The 16-deep slice kk of a K-major operand whose rows start at `rows`
// inside panels of `panel_rows` rows (64 columns each).
template <typename E>
__device__ __forceinline__ uint64_t k_slice(const E* rows, int panel_rows,
                                            int kk) {
  return desc_k_major(rows + (kk >> 2) * panel_rows * 64 + (kk & 3) * 16);
}

// D (64 x N) += A B^T, both from shared memory, K-major, of type E.
template <int N, typename E = __nv_bfloat16>
__device__ __forceinline__ void mma_ss(float* d, uint64_t da, uint64_t db) {
  if constexpr (N == 64) wgmma_ss_n64<E>(d, da, db);
  else wgmma_ss_n128<E>(d, da, db);
}

// D (64 x N) += A (registers) B (shared memory, MN-major, panels of 64
// columns `panel_bytes` apart).
template <int N, typename E>
__device__ __forceinline__ void mma_rs(float* d, const uint32_t* a,
                                       const E* b, uint32_t panel_bytes) {
  const uint64_t db = desc_mn_major(b, panel_bytes);
  if constexpr (N == 64) wgmma_rs_n64<E>(d, a, db);
  else wgmma_rs_n128<E>(d, a, db);
}

// --- host: tensor maps ------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, looked up at the first call (the
// warm-up launch, outside any CUDA-graph capture); null if unavailable.
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess
        || q != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiledFn>(nullptr);
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// A (n2, n1, n0) row-major tensor of 16-bit elements of type `type` (n0
// innermost, a multiple of 8) read in boxes of 64 x `box1` x `box2`
// elements (box2 <= 256), 128-byte swizzled, zero past every edge. A box
// lands as box1 * box2 rows of 128 bytes in the order (n2 outer, n1
// inner).
inline int map_16bit_3d(CUtensorMap* m, CUtensorMapDataType type,
                        const void* ptr, int n0, int n1, int n2, int box1,
                        int box2 = 1) {
  const EncodeTiledFn enc = encode_tiled();
  if (!enc) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)n0, (cuuint64_t)n1, (cuuint64_t)n2};
  const cuuint64_t strides[2] = {(cuuint64_t)n0 * 2, (cuuint64_t)n0 * n1 * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box1, (cuuint32_t)box2};
  const cuuint32_t step[3] = {1, 1, 1};
  return enc(m, type, 3, const_cast<void*>(ptr), dims, strides, box, step,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? 0 : (int)cudaErrorInvalidValue;
}

// map_16bit_3d for E = bf16 or fp16.
template <typename E = __nv_bfloat16>
inline int map_3d(CUtensorMap* m, const void* ptr, int n0, int n1, int n2,
                  int box1, int box2 = 1) {
  return map_16bit_3d(m, std::is_same<E, __half>::value
                             ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                             : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                      ptr, n0, n1, n2, box1, box2);
}

inline int map_bf16_3d(CUtensorMap* m, const void* ptr, int n0, int n1, int n2,
                       int box1, int box2 = 1) {
  return map_3d<__nv_bfloat16>(m, ptr, n0, n1, n2, box1, box2);
}

// A (n2, n1, n0) int8 row-major tensor (n0 innermost, a multiple of 16 and
// at most 256) read in boxes of n0 x 1 x `box2` bytes, unswizzled: a box
// lands as box2 rows of n0 bytes, one after the other.
inline int map_i8_3d(CUtensorMap* m, const void* ptr, int n0, int n1, int n2,
                     int box2) {
  const EncodeTiledFn enc = encode_tiled();
  if (!enc) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)n0, (cuuint64_t)n1, (cuuint64_t)n2};
  const cuuint64_t strides[2] = {(cuuint64_t)n0, (cuuint64_t)n0 * n1};
  const cuuint32_t box[3] = {(cuuint32_t)n0, 1, (cuuint32_t)box2};
  const cuuint32_t step[3] = {1, 1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(ptr),
             dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? 0 : (int)cudaErrorInvalidValue;
}

// A (n1, n0) fp32 tensor whose rows lie `ld` values apart (ld % 4 == 0)
// read in boxes of `box` x 1 values, zero past every edge. TMA starts a box
// only on a 16-byte aligned address, so a box never starts inside a row.
inline int map_f32_rows(CUtensorMap* m, const void* ptr, int n0, int n1,
                        int ld, int box) {
  const EncodeTiledFn enc = encode_tiled();
  if (!enc) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)n0, (cuuint64_t)n1};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 4};
  const cuuint32_t boxd[2] = {(cuuint32_t)box, 1};
  const cuuint32_t step[2] = {1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(ptr),
             dims, strides, boxd, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace hopper
