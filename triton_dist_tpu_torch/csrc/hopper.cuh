// Hopper building blocks for the port's warp-specialised kernels
// (the wgmma bodies of allgather_gemm.cu, gemm_reduce_scatter.cu and
// flash_prefill.cu) and the bulk bodies of all_to_all.cu and p2p.cu:
// mbarriers, TMA tensor loads, bulk copies (bulk_stream), the
// async-proxy fence, wgmma on shared-memory descriptors and register
// rebalancing. Written by hand from the PTX ISA (sm_90a); no CUTLASS
// collective is instantiated.
//
// Shared-memory operands use the 128-byte swizzle that a TMA box with
// CU_TENSOR_MAP_SWIZZLE_128B writes: rows of 128 bytes (64 bf16), the
// 16-byte chunks of row r XOR-ed with r % 8, 8-row atoms of 1024 bytes.
// A K-major operand (A: rows of K) is described by SBO = 1024 (the
// stride of 8-row groups; LBO unused), a k16 slice at +32 bytes. An
// MN-major operand (B as (K, N), N contiguous: 64-column boxes of K
// rows) by LBO = the stride of the 64-column boxes and SBO = 1024 (the
// stride of 8-row K groups), a k16 slice at +16 rows (2048 bytes).
//
// Every wait is bounded like shmem.cuh's spins, but traps past
// kWaitBoundNs without printing what it waited for: these are the waits
// of kernels that issue wgmma, where a call (printf) would make ptxas
// serialize every wgmma (see mbar_wait_quiet).

#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: the encoder is looked up
#include <cuda_runtime.h>
#include <stdint.h>

#include "shmem.cuh"

namespace hopper {

// ---- tensor maps (host) ---------------------------------------------------

// cuTensorMapEncodeTiled, looked up at run time through the CUDA
// runtime's entry point query: no -lcuda at link time
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A tensor of `rank` dimensions (sizes innermost first; strides of
// dimensions 1.. in bytes) as a map of `box`-sized boxes of `type`, zero
// fill past every bound, L2 lines promoted to `promo` on a fetch. False
// when the encoder is missing or refuses the map. encode_bf16: bf16,
// 128-byte swizzle (box[0] must be 64: one 128-byte row).
inline bool encode_map(CUtensorMap* map, CUtensorMapDataType type,
                       CUtensorMapSwizzle swizzle, const void* p, int rank,
                       const uint64_t* dims, const uint64_t* strides,
                       const uint32_t* box, CUtensorMapL2promotion promo) {
  const EncodeTiled fn = tensor_map_encoder();
  if (fn == nullptr || rank < 1 || rank > 5) return false;
  cuuint64_t d[5], s[4];
  cuuint32_t b[5], e[5];
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    b[i] = box[i];
    e[i] = 1;
    if (i + 1 < rank) s[i] = strides[i];
  }
  return fn(map, type, rank, const_cast<void*>(p), d, s, b, e,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, promo,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline bool encode_bf16(
    CUtensorMap* map, const void* p, int rank, const uint64_t* dims,
    const uint64_t* strides, const uint32_t* box,
    CUtensorMapL2promotion promo = CU_TENSOR_MAP_L2_PROMOTION_L2_256B) {
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                    CU_TENSOR_MAP_SWIZZLE_128B, p, rank, dims, strides, box,
                    promo);
}

// The byte variant: a tensor of bytes (a wire image), boxes landing
// unswizzled (box[0] a multiple of 16 bytes), zero fill past every bound
inline bool encode_bytes(
    CUtensorMap* map, const void* p, int rank, const uint64_t* dims,
    const uint64_t* strides, const uint32_t* box,
    CUtensorMapL2promotion promo = CU_TENSOR_MAP_L2_PROMOTION_L2_128B) {
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8,
                    CU_TENSOR_MAP_SWIZZLE_NONE, p, rank, dims, strides, box,
                    promo);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ----------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

// make the initialised barriers visible to the async proxy and the block
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// arrive and announce `bytes` of TMA transactions for this phase
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// The waits and signals of a kernel that issues wgmma. ptxas serializes
// every wgmma of a function that makes any call (warning C7510), printf
// included, in whatever branch, and every wgmma when it has to place its
// warpgroup dependencies in control flow it cannot prove warp-uniform
// (C7518): a C++ wait loop, or an `if` that one thread takes. So these
// keep their loops and their single-thread predicates inside the PTX,
// as CUTLASS's barriers do, and trap without a message past
// kWaitBoundNs; such a kernel divides with __fdividef (the IEEE division
// calls a slow-path subroutine).
__device__ __forceinline__ void mbar_wait_quiet(uint32_t bar,
                                                uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .u64 t0, t1;\n"
      "mov.u64 t0, %%globaltimer;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "mov.u64 t1, %%globaltimer;\n"
      "sub.u64 t1, t1, t0;\n"
      "setp.gt.u64 p, t1, %2;\n"
      "@p trap;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity), "l"(shmem::kWaitBoundNs)
      : "memory");
}

// an arrive on `bar` by the threads whose `pred` is set
__device__ __forceinline__ void mbar_arrive_if(uint32_t bar, bool pred) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n"
      "}\n" ::"r"(bar),
      "r"(int(pred))
      : "memory");
}

// the threads whose `pred` is set: a gpu-scope fence, then a release add
// of v to *flag (shmem.cuh's signal order: stores, a barrier, one
// thread's fence and release)
__device__ __forceinline__ void signal_add_if(int* flag, int v, bool pred) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %2, 0;\n"
      "@p fence.acq_rel.gpu;\n"
      "@p red.release.gpu.global.add.s32 [%0], %1;\n"
      "}\n" ::"l"(flag),
      "r"(v), "r"(int(pred))
      : "memory");
}

// the threads whose `pred` is set wait (acquire spin) until *flag == v,
// then store 0 to it: the owner's wait for exactly v arrivals, which
// leaves the counter at zero for the next call
__device__ __forceinline__ void wait_eq_reset_if(int* flag, int v,
                                                 bool pred) {
  asm volatile(
      "{\n"
      ".reg .pred p, q;\n"
      ".reg .s32 x;\n"
      ".reg .u64 t0, t1;\n"
      "setp.ne.b32 p, %2, 0;\n"
      "@!p bra DONE;\n"
      "mov.u64 t0, %%globaltimer;\n"
      "SPIN:\n"
      "ld.acquire.gpu.global.s32 x, [%0];\n"
      "setp.eq.s32 q, x, %1;\n"
      "@q bra HIT;\n"
      "nanosleep.u32 64;\n"
      "mov.u64 t1, %%globaltimer;\n"
      "sub.u64 t1, t1, t0;\n"
      "setp.gt.u64 q, t1, %3;\n"
      "@q trap;\n"
      "bra SPIN;\n"
      "HIT:\n"
      "st.relaxed.gpu.global.s32 [%0], 0;\n"
      "DONE:\n"
      "}\n" ::"l"(flag),
      "r"(v), "r"(int(pred)), "l"(shmem::kWaitBoundNs)
      : "memory");
}

// the threads whose `pred` is set wait (acquire spin) until *flag == v,
// leaving it as it is: a counter that several waiters read (the ring
// arrivals of allgather_gemm.cu, which a fresh pool brings at zero; the
// SP flash prefill's segment flags, which the launch's last block
// clears)
__device__ __forceinline__ void wait_eq_if(const int* flag, int v,
                                           bool pred) {
  asm volatile(
      "{\n"
      ".reg .pred p, q;\n"
      ".reg .s32 x;\n"
      ".reg .u64 t0, t1;\n"
      "setp.ne.b32 p, %2, 0;\n"
      "@!p bra DONE;\n"
      "mov.u64 t0, %%globaltimer;\n"
      "SPIN:\n"
      "ld.acquire.gpu.global.s32 x, [%0];\n"
      "setp.eq.s32 q, x, %1;\n"
      "@q bra DONE;\n"
      "nanosleep.u32 64;\n"
      "mov.u64 t1, %%globaltimer;\n"
      "sub.u64 t1, t1, t0;\n"
      "setp.gt.u64 q, t1, %3;\n"
      "@q trap;\n"
      "bra SPIN;\n"
      "DONE:\n"
      "}\n" ::"l"(flag),
      "r"(v), "r"(int(pred)), "l"(shmem::kWaitBoundNs)
      : "memory");
}

// 16 zero bytes to shared address `addr` by the threads whose `pred` is
// set
__device__ __forceinline__ void st_zero16_if(uint32_t addr, bool pred) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %1, 0;\n"
      "@p st.shared.v4.u32 [%0], {%2, %2, %2, %2};\n"
      "}\n" ::"r"(addr),
      "r"(int(pred)), "r"(0)
      : "memory");
}

// ---- TMA ----------------------------------------------------------------

// Order this thread's earlier generic-proxy accesses (and what its
// acquires made visible) before its later async-proxy (TMA) accesses of
// global memory: rows another SM stored with ordinary stores, read
// next by TMA.
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;" ::: "memory");
}

// one box of a 2-D / 3-D tensor map into shared memory at dst,
// completing `bar`'s transactions; coordinates innermost first
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const void* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// ---- bulk copies (no tensor map): 16-byte-aligned addresses, a multiple
// of 16 bytes -------------------------------------------------------------

// `bytes` of global memory at src into shared memory at dst, completing
// `bar`'s transactions
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// `bytes` of shared memory at src to global memory at dst, in this
// thread's current bulk group
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
          dst),
      "r"(src), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// until at most N of this thread's bulk groups still read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}

// until every bulk group of this thread has completed (its global
// writes performed)
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// The staged bulk copy of the data-movement kernels (the all-to-all's
// and p2p_send's bulk bodies): one thread streams tiles of at most
// kBulkStageBytes through kBulkStages shared-memory stages at `stages`
// (a block's dynamic shared memory, kBulkStages * kBulkStageBytes), each
// on its mbarrier at bars + 8 s (initialised with count 1).
constexpr int kBulkStages = 4;
constexpr int kBulkStageBytes = 16384;

// tile(j, &src, &dst0, &dst1) gives tile j's source, its end and a
// second end or nullptr, and returns its bytes (a multiple of 16, at
// most kBulkStageBytes; 16-byte-aligned addresses). Tile j is loaded
// global -> shared on its stage's mbarrier, then stored shared -> global
// to each end in a bulk group; the load of tile j + kBulkStages - 1 is
// issued once the stores of tile j - 1 have read its stage. At the end
// every store has completed and the async proxy is fenced, so the
// caller's generic-proxy publication may follow. `phase` keeps each
// stage's mbarrier parity across calls on the same stages.
template <typename Tile>
__device__ __forceinline__ void bulk_stream(int tiles, Tile tile,
                                            uint32_t stages, uint32_t bars,
                                            uint32_t* phase) {
  auto load = [&](int j) {
    const void* src;
    void* d0;
    void* d1;
    const uint32_t bytes = tile(j, &src, &d0, &d1);
    const int s = j % kBulkStages;
    mbar_expect_tx(bars + 8 * s, bytes);
    bulk_load(stages + s * kBulkStageBytes, src, bytes, bars + 8 * s);
  };
  for (int j = 0; j < min(kBulkStages, tiles); ++j) load(j);
  for (int j = 0; j < tiles; ++j) {
    const int s = j % kBulkStages;
    mbar_wait_quiet(bars + 8 * s, (*phase >> s) & 1u);
    *phase ^= 1u << s;
    const void* src;
    void* d0;
    void* d1;
    const uint32_t bytes = tile(j, &src, &d0, &d1);
    bulk_store(d0, stages + s * kBulkStageBytes, bytes);
    if (d1) bulk_store(d1, stages + s * kBulkStageBytes, bytes);
    bulk_commit();
    if (j >= 1 && j - 1 + kBulkStages < tiles) {
      bulk_wait_read<1>();
      load(j - 1 + kBulkStages);
    }
  }
  bulk_wait_all();
  fence_proxy_async_global();
}

// Order this thread's generic-proxy writes of shared memory before later
// async-proxy reads of it (a wgmma operand written with ordinary stores)
__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// a barrier of `threads` threads (whole warps) under id 1..15 (0 is
// __syncthreads'): one warpgroup, or the consumers of a block
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// arrive at named barrier `id` of `threads` threads without waiting
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const void* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// ---- wgmma --------------------------------------------------------------

// a shared-memory matrix descriptor of a 128-byte-swizzled operand
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) |
         (uint64_t((lbo & 0x3FFFF) >> 4) << 16) |
         (uint64_t((sbo & 0x3FFFF) >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator accesses across a wgmma
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// register rebalancing between warpgroups (all 4 warps execute it)
template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(R));
}

// bf16 x bf16 -> f32 products of a warpgroup: A from a K-major
// descriptor, B from an MN-major one (imm-trans-b 1). Lane l of warp w
// holds rows 16 w + l / 4 (+ 8) and columns 8 i + 2 (l % 4) (+ 1):
// d[4 i + 2 h + c] is row 16 w + l / 4 + 8 h, column 8 i + 2 (l % 4) + c.

// D (64 x 64, f32) = D * (scale_d != 0) + A (64 x 16, K-major)
// * B (16 x 64, MN-major)
__device__ __forceinline__ void wgmma_n64(float* d, uint64_t da, uint64_t db,
                                          int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31},"
      " %32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 128, f32) = D * (scale_d != 0) + A (64 x 16, K-major)
// * B (16 x 128, MN-major)
__device__ __forceinline__ void wgmma_n128(float* d, uint64_t da, uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 192, f32) = D * (scale_d != 0) + A (64 x 16, K-major)
// * B (16 x 192, MN-major)
__device__ __forceinline__ void wgmma_n192(float* d, uint64_t da, uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69,"
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89,"
      "%90, %91, %92, %93, %94, %95},"
      " %96, %97, p, 1, 1, 0, 1;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 256, f32) = D * (scale_d != 0) + A (64 x 16, K-major)
// * B (16 x 256, MN-major)
__device__ __forceinline__ void wgmma_n256(float* d, uint64_t da, uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69,"
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89,"
      "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99,"
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109,"
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, f32) = D * (scale_d != 0) + A (64 x 16, K-major)
// * B (16 x 64, K-major: the 64 columns stored as rows of K, as a K/V
// tile's keys are; imm-trans-b 0). Its descriptor is an A operand's:
// SBO = 1024, a k16 slice at +32 bytes of a 128-byte row.
__device__ __forceinline__ void wgmma_n64_kb(float* d, uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31"
      "},"
      " %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 128, f32) = D * (scale_d != 0) + A (64 x 16, bf16 pairs in
// registers) * B (16 x 128, MN-major). A's registers are laid out as
// mma.sync's m16n8k16 A fragment a warp (warp w: rows 16 w ..): a[0]
// (row l / 4, columns 2 (l % 4) + {0, 1}), a[1] (row + 8), a[2] (columns
// + 8), a[3] (both), so the accumulator of an earlier product (d[4 i +
// 2 h + c] above) packs into it two 8-column groups at a time.
__device__ __forceinline__ void wgmma_n128_rs(float* d, const uint32_t* a,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63"
      "},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

// D (64 x N) += A (64 x 16) B (16 x N) for N in {64, 128, 192, 256}
template <int N>
__device__ __forceinline__ void wgmma(float* d, uint64_t da, uint64_t db,
                                      int scale_d) {
  static_assert(N == 64 || N == 128 || N == 192 || N == 256, "wgmma N");
  if (N == 64) wgmma_n64(d, da, db, scale_d);
  if (N == 128) wgmma_n128(d, da, db, scale_d);
  if (N == 192) wgmma_n192(d, da, db, scale_d);
  if (N == 256) wgmma_n256(d, da, db, scale_d);
}

}  // namespace hopper
