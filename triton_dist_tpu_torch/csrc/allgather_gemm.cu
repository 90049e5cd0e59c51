// Fused AllGather + GEMM over the virtual world of one card, sm_90a.
//
// Replaces the Pallas TPU kernel `_ag_gemm_kernel` reached through
// `ag_gemm` in triton_dist_tpu/kernels/allgather_gemm.py (dense and
// grouped forms on the native wire, the dense form on the quantized
// wire; the plain and the silu_pair epilogues; rank and arrival order of
// C). Same function, rank-stacked: a (n, m, K)
// holds rank r's shard at [r], b (n, K, N) rank r's weight; rank r's
// result is C[r] = AllGather(a) @ b[r], (n*m, N). With silu_pair, b is a
// pair (gate, up) of that shape and C[r] = silu(A @ gate[r]) *
// (A @ up[r]), f32 math on the f32 accumulators, rounded once to the
// output dtype.
//
// The grouped (MoE) form: each rank's m rows are E blocks of cap rows
// (moe_utils.pack_by_expert), b is (n, E, K, N) and row block e of every
// gathered chunk multiplies b[r][e]. B is read through strides (a row
// stride ldb >= N, an expert and a rank stride), so the gate and up
// halves are views of one [w_gate | w_up] stack (ldb = 2N) and no
// weight is copied. In ag_gemm_kernel, row tiles are cut per block of
// cap rows, so a tile never spans two experts (nor two ring steps): a
// block of cap < 128 rows is one tile with its rows past cap predicated
// off, and the tile's expert e = block % E picks its B. The dense form is
// the grouped form with E = 1 and cap = n*m, the same tiles and the same
// addresses. With counts (the live rows of each block), the grouped form
// runs ag_gemm_grouped_wgmma_kernel (its own section below).
//
// The gather. Each rank's gathered A lives in the workspace, heap((n*m,
// K)) of every rank: partition [r], row block c = chunk c. It travels
// the ring of csrc/allgather.cu: at step s, rank me puts chunk
// (me - s) mod n into the same row block of its right neighbour's
// partition, and adds one to that neighbour's arrival counter of step
// s. The first kProducers blocks of every rank do the ring, each a
// contiguous share of every chunk; a producer forwards step s's chunk
// only after the counter of step s - 1 shows every producer's share of
// it arrived. Step 0 forwards the own shard, which needs no wait, and
// also publishes it into the own partition, so the workspace ends as
// the gathered A (return_gathered).
//
// The product. The consumer walks C's tiles over the ARRIVAL-ordered gathered
// A (row block s = chunk (me - s) mod n, s = ring step), row tiles outermost
// (the wgmma body below: column by column, each column's row tiles in that
// order), so tiles of early steps come first: the own shard (step 0) is read
// straight from `a` and needs no wait; a tile whose rows reach step s >= 1
// waits on the arrival counter of step s - 1 before its A loads. A row tile
// need not align with a chunk (m = 1 at decode, 64 in a serve step): it waits
// on every step its rows cover, and B is read once per row tile, not once per
// step. Every block, producers included once their ring share is done, takes
// tiles from a per-rank counter (dynamic scheduling, tiles in increasing
// order). The store puts row R at R (c_order "arrival") or at its chunk's
// rank-order row (c_order "rank").
//
// No deadlock: producers wait only on producers of an earlier step of
// the same ring, a chain that ends at step 0, which waits on nothing;
// consumers wait only on producers, and a producer never waits on a
// consumer. All n ranks run in one cooperative launch (shmem.cuh), so
// every block is resident; every spin is bounded and traps.
//
// Tile bodies. The main path's dense form (native wire, bf16 in, m a
// multiple of 64) and the dense form on a quantized wire at the same
// shapes run ag_gemm_wgmma_kernel below: TMA, wgmma and warp
// specialisation (on the wire, transform warps dequantize A in the
// pipeline); the grouped form with counts (bf16 in, n <= 8) runs
// ag_gemm_grouped_wgmma_kernel. Every other call runs ag_gemm_kernel
// with one of two bodies. bf16: 128 x 128 output tiles (128 x 64 per half with silu_pair,
// two accumulators, the same 64 f32 registers a thread as one 128 x 128
// tile), 8 warps, mma.sync m16n8k16 with f32 accumulation, A and B staged
// with cp.async in a three-stage ring, the fragment code of
// gemm_reduce_scatter.cu (tile.cuh). f32: 64 x 64 tiles on the CUDA cores
// with FMA, so the kernel can be held to a tight tolerance. The output
// dtype may differ from the input's (the JAX out_dtype): bf16 in, bf16 or
// f32 out; f32 in, f32 out.
//
// The quantized wire (dense form; JAX `a_dequant`, allgather_gemm.py:
// 273-283): a holds each rank's packed A shard, the wire image of
// wire/codec.py (K payload bytes, e4m3 or int8, then the row's f32 scale
// at byte K, padded to kw bytes; per-row scales, K a multiple of 128).
// The ring forwards (m, kw) image rows on the same protocol, and the
// workspace is heap((n*m, kw)) int8. Each A tile is dequantized right
// before its product, every row through the codec, the own shard
// included, so A is bitwise the codec's roundtrip (wire.unpack): in the
// wgmma body by its transform warps (its section below); in the mma.sync
// body the thread that would cp.async 8 elements of a row loads its 8
// bytes, multiplies each decoded byte by the row's scale in f32
// (__fmul_rn) and rounds to the input dtype, and stores them into the
// shared tile ldmatrix reads (B keeps its cp.async).
//
// What bounds it on an H100: operations, 2 * n * (n*m) * K * N (twice
// that with silu_pair) at the bf16 tensor-core peak, at the prefill
// shapes; bytes (B, n * K * N, read at least once) at a serve step's.
// The TPU kernel's VMEM strip cache, grid-step restructuring and tile
// fitting are TPU concerns and are not carried over. The grouped kernel
// over the live rows is bound by bytes (its own section). Not done yet:
// the wgmma body for the f32 form; a finer arrival granularity than one
// counter per step.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "shmem.cuh"
#include "tile.cuh"

namespace {

constexpr int kProducers = 8;  // ring blocks a rank
constexpr int kThreads = 256;

__device__ __forceinline__ float silu_mul(float g, float u) {
  return g * (1.f / (1.f + expf(-g))) * u;
}

// silu_mul in a kernel that issues wgmma: the IEEE division calls a
// slow-path subroutine, and any call makes ptxas serialize the kernel's
// wgmma (hopper.cuh), so the reciprocal is __fdividef's (2 ulp in f32;
// 1 / inf = 0 as before)
__device__ __forceinline__ float silu_mul_wg(float g, float u) {
  return g * __fdividef(1.f, 1.f + expf(-g)) * u;
}

// outputs: one element, or two adjacent ones (8-byte aligned for f32)
__device__ __forceinline__ void put_one(float v, float* p) { *p = v; }
__device__ __forceinline__ void put_one(float v, unsigned short* p) {
  *p = __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ __forceinline__ void put_pair(float v0, float v1,
                                         unsigned short* p) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(v0, v1);
}
__device__ __forceinline__ void put_pair(float v0, float v1, float* p) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}

// A's wire format (W): 0 native, 1 e4m3, 2 int8. A payload byte decoded
// to f32 (exact for both), and the row's f32 scale at byte K.
template <int W>
__device__ __forceinline__ float wire_dequant(signed char q) {
  if (W == 1) {
    const __half_raw h = __nv_cvt_fp8_to_halfraw(
        static_cast<__nv_fp8_storage_t>(q), __NV_E4M3);
    return __half2float(__half(h));
  }
  return static_cast<float>(q);
}

__device__ __forceinline__ float wire_scale(const char* row, int K) {
  return __ldcg(reinterpret_cast<const float*>(row + K));
}

// One rank's view of the gathered A and of its C. Row R of the
// arrival-ordered gathered A is row R % m of step s = R / m, which holds
// chunk (me - s) mod n. A rows are row_bytes apart: K elements, or a
// wire image row of kw bytes.
template <typename O>
struct Gathered {
  const char* a;   // my shard (m rows)
  const char* ws;  // my workspace partition (n*m rows), chunk c at rows c*m
  O* c;            // my C (n*m, N)
  int n, me, m, K, N, arrival;
  int ldb;         // B's row stride (elements)
  int row_bytes;

  __device__ __forceinline__ const char* a_row(int R) const {
    const int s = R / m, lr = R - s * m;
    if (s == 0) return a + size_t(lr) * row_bytes;
    return ws + (size_t((me - s + n) % n) * m + lr) * row_bytes;
  }
  __device__ __forceinline__ O* c_row(int R) const {
    if (arrival) return c + size_t(R) * N;
    const int s = R / m, lr = R - s * m;
    return c + (size_t((me - s + n) % n) * m + lr) * N;
  }
};

// ---- bf16 tile body: mma.sync on the tensor cores ------------------------

template <int H, int W, typename OT>  // H = 2: silu_pair, an accumulator a half
struct Bf16Body {
  typedef unsigned short S;  // bf16 bits
  typedef OT O;
  static constexpr int BM = 128, BN = H == 1 ? 128 : 64, BK = 32;
  static constexpr int kStages = 3;
  static constexpr int AST = BK + 8;  // smem row strides (+16 bytes)
  static constexpr int BST = BN + 8;
  static constexpr int kStage = BM * AST + H * BK * BST;  // bf16 per stage
  static constexpr size_t kSmem = sizeof(bf16) * kStage * kStages;
  static constexpr int WN = BN / 4, NI = WN / 8;  // warp columns, n8 frags
  static constexpr int kBq = BK * BN / 8 / kThreads;  // B chunks a thread

  // C rows [R0, R0 + rows) x columns [j0, j0 + cols) of my C, edges
  // zero-filled on load and masked on store; K, N multiples of 8
  static __device__ __forceinline__ void tile(const Gathered<O>& g, int R0,
                                              int rows, int j0, int cols,
                                              const S* const* b, void* smem) {
    const int K = g.K;
    bf16* sm = static_cast<bf16*>(smem);
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int wm = (warp >> 2) * 64, wn = (warp & 3) * WN;
    const int KT = (K + BK - 1) / BK;
    const bf16* base = reinterpret_cast<const bf16*>(b[0]);
    // the two A rows this thread loads: tid / 4 and tid / 4 + 64 (and,
    // on the wire, their scales)
    const char* arow[2];
    float asc[2] = {0.f, 0.f};
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int r = (tid >> 2) + 64 * q;
      arow[q] = r < rows ? g.a_row(R0 + r) : nullptr;
      if (W != 0 && arow[q] != nullptr) asc[q] = wire_scale(arow[q], K);
    }
    const int kc = (tid & 3) * 8;

    auto load = [&](int kt, int stage) {
      bf16* as = sm + stage * kStage;
      const int k0 = kt * BK;
#pragma unroll
      for (int q = 0; q < 2; ++q) {  // A: 128 rows x 4 chunks of 8
        const int r = (tid >> 2) + 64 * q;
        const bool ok = arow[q] != nullptr && k0 + kc < K;
        if (W == 0) {
          cp_async16(as + r * AST + kc,
                     ok ? reinterpret_cast<const bf16*>(arow[q]) + k0 + kc
                        : base,
                     ok);
        } else {  // the consume edge: 8 bytes -> 8 dequantized bf16
          uint4 pk = make_uint4(0u, 0u, 0u, 0u);
          if (ok) {
            const uint2 raw =
                __ldcg(reinterpret_cast<const uint2*>(arow[q] + k0 + kc));
            const signed char* qb = reinterpret_cast<const signed char*>(&raw);
            uint32_t* pw = reinterpret_cast<uint32_t*>(&pk);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              pw[e] = pack_bf16(
                  __fmul_rn(wire_dequant<W>(qb[2 * e]), asc[q]),
                  __fmul_rn(wire_dequant<W>(qb[2 * e + 1]), asc[q]));
          }
          *reinterpret_cast<uint4*>(as + r * AST + kc) = pk;
        }
      }
#pragma unroll
      for (int h = 0; h < H; ++h) {  // B: 32 rows x BN / 8 chunks of 8
        bf16* bs = as + BM * AST + h * BK * BST;
        const bf16* B = reinterpret_cast<const bf16*>(b[h]) + j0;
#pragma unroll
        for (int q = 0; q < kBq; ++q) {
          const int idx = tid + q * kThreads;
          const int r = idx / (BN / 8), nc = (idx % (BN / 8)) * 8;
          const bool ok = k0 + r < K && nc < cols;
          cp_async16(bs + r * BST + nc,
                     ok ? B + size_t(k0 + r) * g.ldb + nc : base, ok);
        }
      }
    };

    float acc[H][4][NI][4];
#pragma unroll
    for (int h = 0; h < H; ++h)
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[h][mi][ni][e] = 0.f;

#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < KT) load(s, s);
      cp_async_commit();
    }
    for (int kt = 0; kt < KT; ++kt) {
      cp_async_wait<kStages - 2>();  // stage kt has landed
      __syncthreads();               // and every warp is done with kt - 1
      if (kt + kStages - 1 < KT)
        load(kt + kStages - 1, (kt + kStages - 1) % kStages);
      cp_async_commit();  // possibly empty: keeps the group count uniform
      const bf16* as = sm + (kt % kStages) * kStage;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t af[4][4], bfr[H][NI / 2][4];
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
          ldsm_x4(af[mi], as + (wm + mi * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * AST +
                              kk * 16 + 8 * (lane >> 4));
#pragma unroll
        for (int h = 0; h < H; ++h) {
          const bf16* bs = as + BM * AST + h * BK * BST;
#pragma unroll
          for (int nj = 0; nj < NI / 2; ++nj)
            ldsm_x4_trans(bfr[h][nj], bs + (kk * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * BST +
                                          wn + nj * 16 + 8 * (lane >> 4));
        }
#pragma unroll
        for (int h = 0; h < H; ++h)
#pragma unroll
          for (int mi = 0; mi < 4; ++mi)
#pragma unroll
            for (int ni = 0; ni < NI; ++ni)
              mma_bf16(acc[h][mi][ni], af[mi], bfr[h][ni >> 1][(ni & 1) * 2],
                       bfr[h][ni >> 1][(ni & 1) * 2 + 1]);
      }
    }
    cp_async_wait<0>();

#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = wm + mi * 16 + (lane >> 2) + 8 * hr;
        if (row >= rows) continue;
        O* D = g.c_row(R0 + row) + j0;
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
          const int col = wn + ni * 8 + (lane & 3) * 2;
          if (col >= cols) continue;
          float v0 = acc[0][mi][ni][2 * hr], v1 = acc[0][mi][ni][2 * hr + 1];
          if (H == 2) {
            v0 = silu_mul(v0, acc[H - 1][mi][ni][2 * hr]);
            v1 = silu_mul(v1, acc[H - 1][mi][ni][2 * hr + 1]);
          }
          put_pair(v0, v1, D + col);
        }
      }
  }
};

// ---- f32 tile body: FMA on the CUDA cores --------------------------------

template <int H, int W, typename OT>
struct F32Body {
  typedef float S;
  typedef OT O;
  static constexpr int BM = 64, BN = 64, BK = 16;
  static constexpr size_t kSmem = sizeof(float) * BK * (BM + H * BN);

  static __device__ __forceinline__ void tile(const Gathered<O>& g, int R0,
                                              int rows, int j0, int cols,
                                              const S* const* b, void* smem) {
    const int K = g.K;
    float* as = static_cast<float*>(smem);  // [BK][BM], A transposed
    float* bs = as + BK * BM;               // [H][BK][BN]
    const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15, ak = tid & 15;
    const char* arow[4];  // rows tid / 16 + 16 q (and their wire scales)
    float asc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = (tid >> 4) + 16 * q;
      arow[q] = r < rows ? g.a_row(R0 + r) : nullptr;
      if (W != 0 && arow[q] != nullptr) asc[q] = wire_scale(arow[q], K);
    }
    float acc[H][4][4];
#pragma unroll
    for (int h = 0; h < H; ++h)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[h][i][j] = 0.f;
    for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = (tid >> 4) + 16 * q;
        // A rows may have been delivered by another rank: __ldcg
        float av = 0.f;
        if (arow[q] != nullptr && k0 + ak < K)
          av = W == 0 ? __ldcg(reinterpret_cast<const float*>(arow[q]) + k0 +
                               ak)
                      : __fmul_rn(wire_dequant<W>(__ldcg(
                                      reinterpret_cast<const signed char*>(
                                          arow[q]) + k0 + ak)),
                                  asc[q]);
        as[ak * BM + r] = av;
      }
#pragma unroll
      for (int h = 0; h < H; ++h)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int idx = tid + q * kThreads;
          const int bk = idx >> 6, bc = idx & 63;  // B element (k0 + bk, bc)
          bs[(h * BK + bk) * BN + bc] =
              k0 + bk < K && bc < cols
                  ? b[h][size_t(k0 + bk) * g.ldb + j0 + bc]
                  : 0.f;
        }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        float av[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = as[k * BM + ty * 4 + i];
#pragma unroll
        for (int h = 0; h < H; ++h) {
          float bv[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = bs[(h * BK + k) * BN + tx * 4 + j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[h][i][j] = fmaf(av[i], bv[j], acc[h][i][j]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty * 4 + i;
      if (row >= rows) continue;
      O* D = g.c_row(R0 + row) + j0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx * 4 + j;
        if (col < cols)
          put_one(H == 2 ? silu_mul(acc[0][i][j], acc[H - 1][i][j])
                         : acc[0][i][j],
                  D + col);
      }
    }
  }
};

// Block-wide copy of words [lo, hi), four loads in flight a thread; src
// may be data another rank delivered (__ldcg, shmem.cuh's rule).
__device__ __forceinline__ void copy_words(uint4* dst, const uint4* src,
                                           long long lo, long long hi) {
  constexpr int U = 4;
  const int step = blockDim.x;
  long long i = lo + threadIdx.x;
  for (; i + (U - 1) * step < hi; i += U * step) {
    uint4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) v[u] = __ldcg(src + i + u * step);
#pragma unroll
    for (int u = 0; u < U; ++u) dst[i + u * step] = v[u];
  }
  for (; i < hi; i += step) dst[i] = __ldcg(src + i);
}

// The ring of the gather, run by the first `producers` blocks of rank
// me (the whole block): step 0 publishes the own shard into the own
// partition and forwards it; step s forwards chunk (me - s) mod n once
// the counter of step s - 1 shows every producer's share of it arrived.
// flags of a rank: [0] the tile counter, [1 + s] arrivals of step s.
// The straggling rank's producers stall straggle_ns on entry first.
// Quiet: the wait of a kernel that issues wgmma (hopper::wait_eq_if,
// which traps past the bound without printf's call).
template <bool Quiet>
__device__ __forceinline__ void ring_forward(const char* a, char* ws,
                                             int* flags, size_t chunk,
                                             int producers, int straggle_rank,
                                             long long straggle_ns) {
  const int n = gridDim.y, me = blockIdx.y, right = (me + 1) % n;
  int* mine = flags + size_t(me) * n;
  shmem::straggler_delay(straggle_rank, me, straggle_ns);
  const long long words = (long long)(chunk / 16);
  const long long lo = words * blockIdx.x / producers;
  const long long hi = words * (blockIdx.x + 1) / producers;
  const uint4* own = reinterpret_cast<const uint4*>(a + me * chunk);
  copy_words(reinterpret_cast<uint4*>(ws + (size_t(me) * n + me) * chunk),
             own, lo, hi);
  for (int s = 0; s < n - 1; ++s) {
    const int ch = (me - s + n) % n;  // the chunk this step forwards
    if (s > 0) {  // chunk ch arrived from the left at step s - 1
      if constexpr (Quiet) {
        hopper::wait_eq_if(mine + s, producers, threadIdx.x == 0);
        __syncthreads();
      } else {
        shmem::signal_wait_until(mine + s, shmem::kEq, producers, "ag_gemm",
                                 me, s);
      }
    }
    const uint4* src =
        s == 0 ? own
               : reinterpret_cast<const uint4*>(ws + (size_t(me) * n + ch) *
                                                         chunk);
    copy_words(
        reinterpret_cast<uint4*>(ws + (size_t(right) * n + ch) * chunk), src,
        lo, hi);
    shmem::signal_add(flags + size_t(right) * n + 1 + s, 1);
  }
}

// ---- the kernel: ring producers, then tiles in arrival order --------------

// flags of a rank: [0] the tile counter, [1 + s] arrivals of step s.
// Row blocks of cap rows (cap divides m; E blocks a chunk, block q
// multiplies expert q % E); B of rank r, expert e at b + r * b_rs +
// e * b_es, rows ldb apart. A rows are row_bytes apart (a multiple of
// 16): a is (n, m) such rows, ws (n, n*m).
template <class Body>
__global__ void __launch_bounds__(kThreads, 2)
ag_gemm_kernel(const char* a, const typename Body::S* b0,
               const typename Body::S* b1, char* ws, typename Body::O* c,
               int* flags, int m, int K, int N, int row_bytes, int arrival,
               int cap, int E, int ldb, long long b_es, long long b_rs,
               int straggle_rank, long long straggle_ns) {
  typedef typename Body::S S;
  typedef typename Body::O O;
  constexpr int BM = Body::BM, BN = Body::BN;
  extern __shared__ uint4 smem[];
  __shared__ int next_tile;
  const int n = gridDim.y, me = blockIdx.y;
  const int producers = min(kProducers, int(gridDim.x));
  const size_t chunk = size_t(m) * row_bytes;  // bytes of a shard
  int* mine = flags + size_t(me) * n;

  if (int(blockIdx.x) < producers)
    ring_forward<false>(a, ws, flags, chunk, producers, straggle_rank,
                        straggle_ns);

  const Gathered<O> g{a + me * chunk, ws + size_t(me) * n * chunk,
                      c + size_t(me) * n * m * N, n, me, m, K, N, arrival,
                      ldb, row_bytes};
  const int M = n * m, nt = (N + BN - 1) / BN;
  const int tpb = (cap + BM - 1) / BM;  // row tiles a block of cap rows
  const int total = (M / cap) * tpb * nt;
  for (;;) {
    if (threadIdx.x == 0) next_tile = atomicAdd(mine, 1);
    __syncthreads();
    const int t = next_tile;
    __syncthreads();
    if (t >= total) break;
    const int rt = t / nt, q = rt / tpb, w = rt - q * tpb;
    const int R0 = q * cap + w * BM, j0 = (t % nt) * BN;
    const int rows = min(BM, cap - w * BM);
    const int e = q % E;
    const S* b[2] = {b0 + me * b_rs + e * b_es, b1 + me * b_rs + e * b_es};
    // the steps this tile's rows come from; step s >= 1 arrived with
    // flag 1 + (s - 1)
    for (int s = max(1, R0 / m); s <= (R0 + rows - 1) / m; ++s)
      shmem::signal_wait_until(mine + s, shmem::kEq, producers, "ag_gemm", me,
                               s);
    Body::tile(g, R0, rows, j0, min(BN, N - j0), b, smem);
  }
}

struct Geometry {  // the row blocks, A's row bytes, B's strides; a delay
  int cap, E, ldb, row_bytes;
  long long b_es, b_rs;
  int straggle_rank;  // this rank's ring producers stall straggle_ns
  long long straggle_ns;
};

template <class Body>
cudaError_t launch(const void* a, const void* b0, const void* b1, void* ws,
                   void* c, int* flags, int n, int m, int K, int N,
                   int arrival, Geometry geo, int* info, cudaStream_t st) {
  typedef typename Body::S S;
  typedef typename Body::O O;
  const int tiles = (n * m / geo.cap) *
                    ((geo.cap + Body::BM - 1) / Body::BM) *
                    ((N + Body::BN - 1) / Body::BN);
  return shmem::launch_world(
      ag_gemm_kernel<Body>, n, tiles > kProducers ? tiles : kProducers,
      kThreads, Body::kSmem, st, info, static_cast<const char*>(a),
      static_cast<const S*>(b0), static_cast<const S*>(b1),
      static_cast<char*>(ws), static_cast<O*>(c), flags, m, K, N,
      geo.row_bytes, arrival, geo.cap, geo.E, geo.ldb, geo.b_es, geo.b_rs,
      geo.straggle_rank, geo.straggle_ns);
}

// the bf16 bodies by output dtype (0 = float32, 1 = bfloat16)
template <int H, int W>
cudaError_t launch_bf16(int out_dtype, const void* a, const void* b0,
                        const void* b1, void* ws, void* c, int* fl, int n,
                        int m, int K, int N, int arrival, Geometry geo,
                        int* inf, cudaStream_t st) {
  if (out_dtype == 0)
    return launch<Bf16Body<H, W, float>>(a, b0, b1, ws, c, fl, n, m, K, N,
                                         arrival, geo, inf, st);
  if (out_dtype == 1)
    return launch<Bf16Body<H, W, unsigned short>>(a, b0, b1, ws, c, fl, n, m,
                                                  K, N, arrival, geo, inf, st);
  return cudaErrorInvalidValue;
}

// dtype / out_dtype: 0 = float32, 1 = bfloat16 (f32 in, f32 out); W: A's
// wire format (0 native, 1 e4m3, 2 int8; not with pair)
int launch_any(const void* a, const void* b0, const void* b1, void* ws,
               void* c, void* flags, int n, int m, int K, int N, int dtype,
               int out_dtype, int W, int pair, int arrival, Geometry geo,
               void* info, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* fl = static_cast<int*>(flags);
  int* inf = static_cast<int*>(info);
  if (pair && W != 0) return int(cudaErrorInvalidValue);
  if (dtype == 0) {
    if (out_dtype != 0) return int(cudaErrorInvalidValue);
    if (pair)
      return int(launch<F32Body<2, 0, float>>(a, b0, b1, ws, c, fl, n, m, K,
                                              N, arrival, geo, inf, st));
    if (W == 0)
      return int(launch<F32Body<1, 0, float>>(a, b0, b1, ws, c, fl, n, m, K,
                                              N, arrival, geo, inf, st));
    if (W == 1)
      return int(launch<F32Body<1, 1, float>>(a, b0, b1, ws, c, fl, n, m, K,
                                              N, arrival, geo, inf, st));
    if (W == 2)
      return int(launch<F32Body<1, 2, float>>(a, b0, b1, ws, c, fl, n, m, K,
                                              N, arrival, geo, inf, st));
  }
  if (dtype == 1) {
    if (pair)
      return int(launch_bf16<2, 0>(out_dtype, a, b0, b1, ws, c, fl, n, m, K,
                                   N, arrival, geo, inf, st));
    if (W == 0)
      return int(launch_bf16<1, 0>(out_dtype, a, b0, b1, ws, c, fl, n, m, K,
                                   N, arrival, geo, inf, st));
    if (W == 1)
      return int(launch_bf16<1, 1>(out_dtype, a, b0, b1, ws, c, fl, n, m, K,
                                   N, arrival, geo, inf, st));
    if (W == 2)
      return int(launch_bf16<1, 2>(out_dtype, a, b0, b1, ws, c, fl, n, m, K,
                                   N, arrival, geo, inf, st));
  }
  return int(cudaErrorInvalidValue);
}

// ---- the wgmma body: TMA + wgmma, warp-specialised (dense, bf16) --------
//
// The main path's form: dense, native wire, bf16 in, bf16 or f32 out,
// plain or silu_pair, m a multiple of 64. The same ring producers, tile
// counter and arrival-ordered walk as ag_gemm_kernel; the tile body is
// Hopper's:
//   - 384 threads: warpgroup 0 the producer (one thread issues TMA, the
//     warpgroup gives its registers away: setmaxnreg 40), warpgroups 1
//     and 2 the consumers (setmaxnreg 232), each wgmma.mma_async on 64 of
//     the tile's 128 rows with f32 accumulators in registers (silu_pair:
//     one for gate, one for up);
//   - a ring of kStages stages in shared memory, BK = 64 (128 bytes of
//     bf16, the 128-byte swizzle), each stage's A as two 64 x 64 boxes
//     and B as BN / 64 boxes of 64 columns x 64 K rows a half, with full
//     (TMA bytes) and empty (one arrive a consumer warpgroup) mbarriers;
//   - A from two tensor maps: rows of step 0 from the own shard `a` (n*m,
//     K), delivered rows from the workspace (n*n*m, K) at chunk (me - s)
//     mod n; one box a 64-row step segment (m % 64 == 0). B (n, K, N) as
//     a 3-D map (N contiguous, MN-major for wgmma), so a K edge reads
//     zeros and never the next rank's rows; N and K edges by TMA's zero
//     fill, stores masked per row and column;
//   - the producer thread, not the consumers, waits for a step's arrival
//     counter before that step's loads, then orders the ring producers'
//     ordinary stores (made visible by its acquire) before its TMA reads
//     with fence.proxy.async.global;
//   - one block an SM, under the same cooperative launch_world;
//   - nothing that makes ptxas serialize the wgmma (hopper.cuh): the ring
//     producers' and the TMA thread's waits and the stage waits are the
//     quiet ones (PTX loops that trap without printf's call), a
//     consumer's release is a predicated arrive, the roles come from a
//     __shfl_sync-broadcast warpgroup index, and silu_mul divides with
//     __fdividef (silu_mul_wg).
// The tile is handed out by the counter and broadcast to the three
// warpgroups through a double-buffered shared slot, one block barrier a
// tile. Tiles go column by column, each column's row tiles in arrival
// order: at the main path's shapes the body is bound by the bytes each
// tile loads (its A rows and B columns, for every K step), and the row
// tiles that share a column's B then read it from L2 together, not
// from HBM one after another.
//
// The quantized wire on this body (W = 1 e4m3, 2 int8; dense, plain
// epilogue, bf16 in, per-row scales, m a multiple of 64, K and N at least
// 64): the ring forwards the (m, kw) image rows, and A is dequantized
// inside the pipeline:
//   - two byte maps over the own images (n*m, kw) and the workspace's
//     (n*n*m, kw), unswizzled: a stage's payload is a box of 64 bytes x
//     64 rows a segment (the K step's 64 codes of each row), and a tile's
//     row scales come once, as a box of 16 bytes x 64 rows a segment at
//     column K (the f32 scale and 12 bytes of padding: kw >= K + 128), on
//     a tile mbarrier of their own. The TMA thread keeps its arrival
//     waits and fence.proxy.async.global before every read of delivered
//     rows, scales included: no thread reads a remote row with a
//     generic load;
//   - warps 1-3 of the producer warpgroup are transform warps (setmaxnreg
//     72 there, 216 for the consumers): each reads its rows' scales once
//     a tile into registers, then for every stage turns the payload into
//     the two bf16 64 x 64 A boxes, 128-byte swizzled where the native
//     body's TMA would have put them (16 payload bytes a thread, two
//     16-byte swizzled stores, bank-conflict free), fences the generic
//     stores for the async proxy (fence.proxy.async.shared::cta) and
//     arrives once a warp on the stage's "converted" mbarrier; the
//     consumers wait for it after "full" and run the native body's wgmma;
//   - each element is float(q) (e4m3 two at a time by cvt.rn.f16x2.e4m3x2
//     through f16, exact; int8 by a byte permute into 2^23 + q + 128, then
//     one subtraction, exact) times the row's scale with __fmul_rn,
//     rounded to nearest bf16: wire.unpack's arithmetic, so A is bitwise
//     the codec's roundtrip;
//   - the one block barrier a tile (the tile slot) also orders the
//     transform warps' reads of one tile's scales before the next tile's
//     scale load, so the scale slot needs no "empty" barrier.
// What bounds it: as the native form, operations at the bf16 peak; A
// arrives at half the native bytes and costs a decode a byte in the SM.

constexpr int kWgThreads = 384;  // a producer warpgroup, two consumers
constexpr int kBK = 64;
constexpr int kBox = 64 * 64 * 2;  // bytes of a 64 x 64 bf16 TMA box
constexpr int kWgSmem = 200 * 1024;  // the stages fill at most this
// the wire's byte maps: a payload box of kWirePay bytes x 64 rows a
// stage segment, a scale box of kWireScale bytes x 64 rows a tile
// segment at column K (wire/codec.py's image: K codes, the f32 scale)
constexpr int kWirePay = kBK;
constexpr int kWireScale = 16;
constexpr int kPayBox = 64 * kWirePay;
constexpr int kScaleBox = 64 * kWireScale;
constexpr int kTransformThreads = 96;  // warps 1-3 of warpgroup 0
// the transform's 16-byte payload units a stage (128 rows x 4), and the
// most a transform thread takes
constexpr int kWireUnits = 128 * kWirePay / 16;
constexpr int kUnitsPer =
    (kWireUnits + kTransformThreads - 1) / kTransformThreads;

// BN: C columns a tile (silu_pair: of each of gate and up); H = 2 for
// silu_pair; W: A's wire format (0 native, 1 e4m3, 2 int8)
template <int BN, int H, int W>
struct WgCfg {
  static constexpr int kNB = BN / 64;  // B boxes a half
  // A (two boxes: TMA's, or the transform's on the wire), B, and on the
  // wire the payload boxes
  static constexpr int kStageBytes =
      (2 + H * kNB) * kBox + (W ? 2 * kPayBox : 0);
  // a tile's scales, then the wire's mbarriers (at most 16)
  static constexpr int kScaleBytes = W ? 2 * kScaleBox + 128 : 0;
  static constexpr int kStages =
      (kWgSmem - kScaleBytes) / kStageBytes < 6
          ? (kWgSmem - kScaleBytes) / kStageBytes
          : 6;
  static constexpr size_t kSmem =
      size_t(kStages) * kStageBytes + kScaleBytes + 1024;
  static_assert(BN % 64 == 0 && H * BN <= 256, "accumulators a thread");
  static_assert(W == 0 || H == 1, "the wire takes the plain epilogue");
};

__device__ __forceinline__ uint4 ld_shared16(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ float ld_shared_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void st_shared16(uint32_t addr, uint32_t a,
                                            uint32_t b, uint32_t c,
                                            uint32_t d) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(addr),
               "r"(a), "r"(b), "r"(c), "r"(d)
               : "memory");
}

// four codes of a 32-bit word (byte i: element i) decoded to f32, exact
template <int W>
__device__ __forceinline__ void decode4(uint32_t x, float (&v)[4]) {
  if (W == 1) {  // e4m3, two at a time through f16
    uint32_t h01, h23;
    asm("{\n"
        ".reg .b16 lo, hi;\n"
        "mov.b32 {lo, hi}, %2;\n"
        "cvt.rn.f16x2.e4m3x2 %0, lo;\n"
        "cvt.rn.f16x2.e4m3x2 %1, hi;\n"
        "}"
        : "=r"(h01), "=r"(h23)
        : "r"(x));
    const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&h01));
    const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&h23));
    v[0] = a.x;
    v[1] = a.y;
    v[2] = b.x;
    v[3] = b.y;
  } else {  // int8: the float 2^23 + (q + 128), less 2^23 + 128
    const uint32_t y = x ^ 0x80808080u;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      v[k] = __uint_as_float(__byte_perm(y, 0x4B000000u, 0x7440 + k)) -
             8388736.f;
  }
}

// 16 payload bytes of a row -> 16 bf16 in 8 words: float(q) * scale in
// f32 (__fmul_rn), rounded to nearest (wire.unpack's arithmetic)
template <int W>
__device__ __forceinline__ void decode16(uint4 q, float s, uint32_t (&o)[8]) {
  const uint32_t in[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float v[4];
    decode4<W>(in[i], v);
    o[2 * i] = pack_bf16(__fmul_rn(v[0], s), __fmul_rn(v[1], s));
    o[2 * i + 1] = pack_bf16(__fmul_rn(v[2], s), __fmul_rn(v[3], s));
  }
}

template <int BN, int H, typename O, int W>
__global__ void __launch_bounds__(kWgThreads, 1)
ag_gemm_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_ws,
                     const __grid_constant__ CUtensorMap map_b0,
                     const __grid_constant__ CUtensorMap map_b1,
                     const __grid_constant__ CUtensorMap map_sa,
                     const __grid_constant__ CUtensorMap map_sws,
                     const char* a, char* ws, O* c, int* flags, int m, int K,
                     int N, int row_bytes, int arrival, int straggle_rank,
                     long long straggle_ns) {
  typedef WgCfg<BN, H, W> Cfg;
  constexpr int S = Cfg::kStages, NB = Cfg::kNB;
  extern __shared__ uint8_t wg_smem[];
  __shared__ __align__(8) uint64_t full_bar[S], empty_bar[S];
  __shared__ int next_tile[2];
  const int n = gridDim.y, me = blockIdx.y;
  const int producers = min(kProducers, int(gridDim.x));
  const size_t chunk = size_t(m) * row_bytes;
  int* mine = flags + size_t(me) * n;
  const uint32_t base = (hopper::smem_addr(wg_smem) + 1023) & ~1023u;
  // the wire's row scales of the current tile, after the stages, then
  // its barriers: "converted" a stage, and the scales' (dynamic shared
  // memory, so the native form's layout is its own)
  const uint32_t scales = base + S * Cfg::kStageBytes;
  const uint32_t conv_bar = scales + 2 * kScaleBox;
  const uint32_t scale_bar = conv_bar + 8 * S;

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      hopper::mbar_init(hopper::smem_addr(&full_bar[i]), 1);
      hopper::mbar_init(hopper::smem_addr(&empty_bar[i]), 2);
      if (W != 0)
        hopper::mbar_init(conv_bar + 8 * i, kTransformThreads / 32);
    }
    if (W != 0) hopper::mbar_init(scale_bar, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();
  if (int(blockIdx.x) < producers)
    ring_forward<true>(a, ws, flags, chunk, producers, straggle_rank,
                       straggle_ns);

  // tiles column by column, each column's row tiles in arrival order:
  // the row tiles that share a column's B run at once, so B comes from
  // HBM about once and the others read it from L2
  const int M = n * m, nt = (N + BN - 1) / BN, rt = (M + 127) / 128;
  const int total = rt * nt, KT = (K + kBK - 1) / kBK;
  // the next tile: the counter, through a double-buffered shared slot
  auto next = [&](int it) {
    if (threadIdx.x == 0) next_tile[it & 1] = atomicAdd(mine, 1);
    __syncthreads();
    return next_tile[it & 1];
  };
  // the warpgroup and warp, warp-uniform to the compiler (a wgmma in a
  // path it cannot prove uniform is serialized: ptxas C7518)
  const int wg = __shfl_sync(0xffffffffu, int(threadIdx.x) / 128, 0);
  if (wg == 0) {  // the producer warpgroup
    hopper::regs_dec<W ? 72 : 40>();
    int stage = 0, ready = 0;
    uint32_t phase = 0;
    for (int it = 0;; ++it) {
      const int t = next(it);
      if (t >= total) break;
      const int R0 = t % rt * 128, j0 = t / rt * BN;
      const int segs = min(128, M - R0) / 64;  // 64-row step segments
      if (W != 0 &&
          __shfl_sync(0xffffffffu, int(threadIdx.x) / 32, 0) > 0) {
        // a transform warp: units u, u + 96, ... of each stage (16
        // payload bytes of row u / 4 at 16 (u % 4)), my rows' scales
        // read once
        const int u0 = threadIdx.x - 32;
        hopper::mbar_wait_quiet(scale_bar, it & 1);
        float sc[kUnitsPer];
#pragma unroll
        for (int i = 0; i < kUnitsPer; ++i) {
          const int u = u0 + kTransformThreads * i;
          sc[i] = u < 256 * segs
                      ? ld_shared_f32(scales + (u >> 2) * kWireScale)
                      : 0.f;
        }
        for (int kt = 0; kt < KT; ++kt) {
          hopper::mbar_wait_quiet(hopper::smem_addr(&full_bar[stage]),
                                  phase);
          const uint32_t st = base + stage * Cfg::kStageBytes;
          const uint32_t pay = st + (2 + NB) * kBox;
#pragma unroll
          for (int i = 0; i < kUnitsPer; ++i) {
            const int u = u0 + kTransformThreads * i;
            if (u >= 256 * segs) break;
            const int row = u >> 2, j = u & 3;
            uint32_t o[8];
            decode16<W>(ld_shared16(pay + row * kWirePay + 16 * j), sc[i],
                        o);
            // chunks 2j, 2j + 1 of the row in the 128-byte swizzle
            const uint32_t dst = st + (row >> 6) * kBox + (row & 63) * 128;
            st_shared16(dst + (((2 * j) ^ (row & 7)) << 4), o[0], o[1],
                        o[2], o[3]);
            st_shared16(dst + (((2 * j + 1) ^ (row & 7)) << 4), o[4], o[5],
                        o[6], o[7]);
          }
          hopper::fence_proxy_async_shared();
          __syncwarp();
          hopper::mbar_arrive_if(conv_bar + 8 * stage,
                                 threadIdx.x % 32 == 0);
          if (++stage == S) {
            stage = 0;
            phase ^= 1;
          }
        }
        continue;
      }
      if (threadIdx.x != 0) continue;
      // the steps this tile reads, each once a block: wait for the ring
      // producers' arrivals, then order their stores before TMA's reads
      const int last = (R0 + 64 * segs - 1) / m;
      if (last > ready) {
        for (int s = ready + 1; s <= last; ++s)
          hopper::wait_eq_if(mine + s, producers, true);
        ready = last;
        hopper::fence_proxy_async_global();
      }
      // a segment's rows: those of step s of the own shard or of the
      // workspace's chunk (me - s) mod n
      if (W != 0) {  // the tile's row scales, at column K
        hopper::mbar_expect_tx(scale_bar, segs * kScaleBox);
        for (int g = 0; g < segs; ++g) {
          const int R = R0 + 64 * g, s = R / m, lr = R - s * m;
          if (s == 0)
            hopper::tma_load_2d(scales + g * kScaleBox, &map_sa, scale_bar,
                                K, me * m + lr);
          else
            hopper::tma_load_2d(scales + g * kScaleBox, &map_sws, scale_bar,
                                K, ((me * n) + (me - s + n) % n) * m + lr);
        }
      }
      constexpr int kABox = W ? kPayBox : kBox;
      constexpr int kAOff = W ? (2 + NB) * kBox : 0;
      for (int kt = 0; kt < KT; ++kt) {
        const uint32_t fb = hopper::smem_addr(&full_bar[stage]);
        hopper::mbar_wait_quiet(hopper::smem_addr(&empty_bar[stage]),
                                phase ^ 1);
        hopper::mbar_expect_tx(fb, segs * kABox + H * NB * kBox);
        const uint32_t st = base + stage * Cfg::kStageBytes;
        for (int g = 0; g < segs; ++g) {
          const int R = R0 + 64 * g, s = R / m, lr = R - s * m;
          if (s == 0)
            hopper::tma_load_2d(st + kAOff + g * kABox, &map_a, fb, kt * kBK,
                                me * m + lr);
          else
            hopper::tma_load_2d(st + kAOff + g * kABox, &map_ws, fb,
                                kt * kBK,
                                ((me * n) + (me - s + n) % n) * m + lr);
        }
#pragma unroll
        for (int h = 0; h < H; ++h)
#pragma unroll
          for (int j = 0; j < NB; ++j)
            hopper::tma_load_3d(st + (2 + h * NB + j) * kBox,
                                h ? &map_b1 : &map_b0, fb, j0 + 64 * j,
                                kt * kBK, me);
        if (++stage == S) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {  // a consumer warpgroup: rows 64 w .. 64 w + 63 of the tile
    hopper::regs_inc<W ? 216 : 232>();
    const int w = wg - 1;
    const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
    const bool signals = threadIdx.x % 128 == 0;
    const Gathered<O> g{a, ws, c + size_t(me) * M * N, n, me, m, K, N,
                        arrival, N, row_bytes};
    int stage = 0;
    uint32_t phase = 0;
    // a stage goes back to the producer
    auto release = [&](int s) {
      hopper::mbar_arrive_if(hopper::smem_addr(&empty_bar[s]), signals);
    };
    for (int it = 0;; ++it) {
      // the tile, warp-uniform to the compiler (it bounds the wgmma loop)
      const int t = __shfl_sync(0xffffffffu, next(it), 0);
      if (t >= total) break;
      const int R0 = t % rt * 128, j0 = t / rt * BN;
      const int rows = min(128, M - R0), cols = min(BN, N - j0);
      float acc[H][BN / 2];
#pragma unroll
      for (int h = 0; h < H; ++h)
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[h][i] = 0.f;
#pragma unroll
      for (int h = 0; h < H; ++h) hopper::fence_regs(acc[h]);
      int prev = 0;
      for (int kt = 0; kt < KT; ++kt) {
        hopper::mbar_wait_quiet(hopper::smem_addr(&full_bar[stage]), phase);
        if (W != 0)  // and A, converted
          hopper::mbar_wait_quiet(conv_bar + 8 * stage, phase);
        const uint32_t st = base + stage * Cfg::kStageBytes;
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          const uint64_t da =
              hopper::desc_sw128(st + w * kBox + kk * 32, 16, 1024);
#pragma unroll
          for (int h = 0; h < H; ++h)
            hopper::wgmma<BN>(
                acc[h],
                da,
                hopper::desc_sw128(st + (2 + h * NB) * kBox + kk * 2048,
                                   kBox, 1024),
                1);
        }
        hopper::wgmma_commit();
        // the group of kt - 1 is done: its stage goes back
        hopper::wgmma_wait<1>();
        if (kt > 0) release(prev);
        prev = stage;
        if (++stage == S) {
          stage = 0;
          phase ^= 1;
        }
      }
      hopper::wgmma_wait<0>();
      release(prev);
#pragma unroll
      for (int h = 0; h < H; ++h) hopper::fence_regs(acc[h]);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = 64 * w + 16 * warp + lane / 4 + 8 * hr;
        if (row >= rows) continue;
        O* D = g.c_row(R0 + row) + j0;
#pragma unroll
        for (int i = 0; i < BN / 8; ++i) {
          const int col = 8 * i + 2 * (lane % 4);
          if (col >= cols) continue;
          float v0 = acc[0][4 * i + 2 * hr], v1 = acc[0][4 * i + 2 * hr + 1];
          if (H == 2) {
            v0 = silu_mul_wg(v0, acc[H - 1][4 * i + 2 * hr]);
            v1 = silu_mul_wg(v1, acc[H - 1][4 * i + 2 * hr + 1]);
          }
          put_pair(v0, v1, D + col);
        }
      }
    }
  }
}

// A bf16 tensor of `depth` matrices of `rows` rows of `cols` elements,
// rows ld elements apart, matrices `dstride` apart, as a map of `dims`
// dimensions (2: one matrix; 3: the kernel issues 3-D loads, whatever
// the depth) in 64 x 64 boxes (x 1), 128-byte swizzle, zero fill.
bool encode(CUtensorMap* map, const void* p, int dims_n, uint64_t cols,
            uint64_t rows, uint64_t depth, uint64_t ld, uint64_t dstride) {
  const uint64_t dims[3] = {cols, rows, depth};
  const uint64_t strides[2] = {ld * 2, dstride * 2};
  const uint32_t box[3] = {64, 64, 1};
  return hopper::encode_bf16(map, p, dims_n, dims, strides, box);
}

// the maps of a native call: a (n*m, K), ws (n*n*m, K), b0 and b1 (n, K,
// N); the scale maps (unread) repeat a's and ws's
bool encode_maps(CUtensorMap (&maps)[6], const void* a, const void* ws,
                 const void* b0, const void* b1, int n, int m, int K, int N) {
  if (!(encode(&maps[0], a, 2, K, uint64_t(n) * m, 1, K, 0) &&
        encode(&maps[1], ws, 2, K, uint64_t(n) * n * m, 1, K, 0) &&
        encode(&maps[2], b0, 3, N, K, n, N, uint64_t(K) * N) &&
        encode(&maps[3], b1, 3, N, K, n, N, uint64_t(K) * N)))
    return false;
  maps[4] = maps[0];
  maps[5] = maps[1];
  return true;
}

// The byte maps of a wire call over images of kw bytes a row (K codes,
// the row's f32 scale at byte K), rows kw apart: the payload of aw (n*m
// rows) and ws (n*n*m rows) as a (K, rows) byte tensor in boxes of
// kWirePay bytes x 64 rows, and their scale columns as a (kw, rows) byte
// tensor in boxes of kWireScale bytes x 64 rows read at column K;
// allgather_gemm._wire_maps is the same geometry. maps: payload aw, ws,
// b, b, scales aw, ws.
bool encode_wire_maps(CUtensorMap (&maps)[6], const void* aw, const void* ws,
                      const void* b, int n, int m, int K, int N, int kw) {
  if (K % kWirePay || K % 16 || K + kWireScale > kw || kw % 16 ||
      reinterpret_cast<uintptr_t>(aw) % 16 ||
      reinterpret_cast<uintptr_t>(ws) % 16)
    return false;
  const uint64_t rows[2] = {uint64_t(n) * m, uint64_t(n) * n * m};
  const uint64_t stride[1] = {uint64_t(kw)};
  const uint32_t pay[2] = {kWirePay, 64}, sc[2] = {kWireScale, 64};
  const void* img[2] = {aw, ws};
  for (int i = 0; i < 2; ++i) {
    const uint64_t dp[2] = {uint64_t(K), rows[i]};
    const uint64_t ds[2] = {uint64_t(kw), rows[i]};
    if (!hopper::encode_bytes(&maps[i], img[i], 2, dp, stride, pay) ||
        !hopper::encode_bytes(&maps[4 + i], img[i], 2, ds, stride, sc))
      return false;
  }
  return encode(&maps[2], b, 3, N, K, n, N, uint64_t(K) * N) &&
         encode(&maps[3], b, 3, N, K, n, N, uint64_t(K) * N);
}

template <int BN, int H, typename O, int W>
cudaError_t launch_wgmma(const CUtensorMap (&maps)[6], const void* a,
                         void* ws, void* c, int* flags, int n, int m, int K,
                         int N, int row_bytes, int arrival, int straggle_rank,
                         long long straggle_ns, int* info, cudaStream_t st) {
  const int tiles = (n * m + 127) / 128 * ((N + BN - 1) / BN);
  return shmem::launch_world(
      ag_gemm_wgmma_kernel<BN, H, O, W>, n,
      tiles > kProducers ? tiles : kProducers, kWgThreads,
      WgCfg<BN, H, W>::kSmem, st, info, maps[0], maps[1], maps[2], maps[3],
      maps[4], maps[5], static_cast<const char*>(a), static_cast<char*>(ws),
      static_cast<O*>(c), flags, m, K, N, row_bytes, arrival, straggle_rank,
      straggle_ns);
}

// the native body by tile width and epilogue (pair), or the wire's (W
// 1 or 2: the plain epilogue)
template <typename O>
cudaError_t launch_wgmma_bn(int bn, int pair, int W,
                            const CUtensorMap (&maps)[6], const void* a,
                            void* ws, void* c, int* flags, int n, int m,
                            int K, int N, int row_bytes, int arrival, int sr,
                            long long sns, int* info, cudaStream_t st) {
#define AGW_LAUNCH(BN, H, W)                                                \
  launch_wgmma<BN, H, O, W>(maps, a, ws, c, flags, n, m, K, N, row_bytes,   \
                            arrival, sr, sns, info, st)
  if (W == 0) {
    if (pair && bn == 64) return AGW_LAUNCH(64, 2, 0);
    if (pair && bn == 128) return AGW_LAUNCH(128, 2, 0);
    if (!pair && bn == 128) return AGW_LAUNCH(128, 1, 0);
    if (!pair && bn == 192) return AGW_LAUNCH(192, 1, 0);
    if (!pair && bn == 256) return AGW_LAUNCH(256, 1, 0);
  } else if (!pair) {
    if (W == 1 && bn == 128) return AGW_LAUNCH(128, 1, 1);
    if (W == 1 && bn == 192) return AGW_LAUNCH(192, 1, 1);
    if (W == 1 && bn == 256) return AGW_LAUNCH(256, 1, 1);
    if (W == 2 && bn == 128) return AGW_LAUNCH(128, 1, 2);
    if (W == 2 && bn == 192) return AGW_LAUNCH(192, 1, 2);
    if (W == 2 && bn == 256) return AGW_LAUNCH(256, 1, 2);
  }
#undef AGW_LAUNCH
  return cudaErrorInvalidValue;
}

// ---- the grouped wgmma kernel: expert-major over the live rows ----------
//
// The grouped form (bf16 in, bf16 or f32 out, plain or silu_pair, K and N
// at least 64, n <= 8): the fused MoE up-projection. Each rank's m rows
// are E blocks of cap rows, and of block e of rank c's pack only the
// first counts[c][e] rows are live (moe_utils.pack_by_expert: the rest
// are zero rows, which the function maps to zero C rows: silu(0) * 0 = 0,
// 0 * B = 0). counts is (n, E) int32 on the card, clamped to [0, cap], or
// null: every row live. The kernel:
//   - the ring (the first kProducers blocks, whole blocks, before their
//     items) forwards only each block's live rows: at step s chunk (me -
//     s) mod n, its live rows in expert order as one flat list (a prefix
//     over counts in shared memory), a warp a row, 16-byte words, a
//     row's loads in flight; the same per-step arrival counters and the
//     same deadlock argument as ring_forward. Dead workspace rows are
//     never written;
//   - expert-major work items: item (e, j) is expert e times column
//     slice j of B (BN columns of gate, and of up). Its A rows are the
//     live rows of block e of every chunk, packed into 64-row wgmma M
//     tiles of 8-row atoms: chunk c's live run fills ceil(counts / 8)
//     atoms, each one TMA box of 8 rows (the 128-byte swizzle repeats
//     every 8 rows, so an 8-row box lands in its slot of the tile as a
//     64-row box would put it there). Rows of an atom past the live run,
//     and atom slots left empty, hold whatever the box or an earlier
//     stage brought: a row of C depends on its row of A alone, and those
//     rows are never stored. So B[e]'s slice streams once for each 64
//     live rows of the expert (once a rank at the fused prefill's ~8),
//     not once a chunk, and an expert that no row reached is skipped;
//   - 256 threads, one block an SM, items b, b + blocks, ... of each
//     rank (every item streams the same B bytes): warp 0's first thread
//     issues the TMA loads into a ring of stages (full / empty
//     mbarriers); warpgroup 1 runs wgmma on 64 x BN tiles (H = 2: gate
//     and up, f32 accumulators, silu_mul on them before one rounding)
//     and stores each live row to its arrival- or rank-order row (the
//     Gathered::c_row rule); warps 1-3 zero-fill the dead rows of each of
//     the block's items' column slices with 16-byte stores, so C needs
//     no memset;
//   - B through a 4-D map over the strided [gate | up] stack (N, K, E, n;
//     ldb, b_es, b_rs), K and N edges by TMA's zero fill. It needs no
//     arrival, so the TMA thread issues the first stages' B at launch
//     and waits for the ring's steps only before their A rows;
//   - nothing that makes ptxas serialize the wgmma: hopper.cuh's quiet
//     waits, one thread's arrives predicated, and the counts that bound
//     the consumer's loops broadcast by __shfl_sync.
// What bounds it on an H100: bytes, each rank's B slices of the experts
// its rows reach, read once, and C with its zero rows, written once.

constexpr int kGThreads = 256;  // a producer warpgroup, one consumer
constexpr int kGMaxN = 8;       // ranks an item's chunk table holds
constexpr int kAtomRows = 8;    // rows of an A box: one swizzle atom
constexpr int kAtomBytes = kAtomRows * 128;

template <int BN, int H>
struct GroupedCfg {
  static constexpr int kNB = BN / 64;  // B boxes a half
  static constexpr int kStageBytes = (1 + H * kNB) * kBox;  // A: 8 atoms
  static constexpr int kStages =
      kWgSmem / kStageBytes < 8 ? kWgSmem / kStageBytes : 8;
  static constexpr size_t kSmem = size_t(kStages) * kStageBytes + 1024;
  static_assert(BN == 64 || BN == 128, "tile widths");
};

// The live rows of block e of every chunk c < n: cnt[c] = counts[c][e]
// clamped to [0, cap] (cap when counts is null); at[c] the 8-row atoms of
// the chunks before c. Bcast: read by a whole warp and broadcast from
// lane 0, so the compiler sees warp-uniform loop bounds.
template <bool Bcast>
__device__ __forceinline__ void item_rows(const int* counts, int n, int E,
                                          int cap, int e, int (&cnt)[kGMaxN],
                                          int (&at)[kGMaxN + 1]) {
  at[0] = 0;
#pragma unroll
  for (int c = 0; c < kGMaxN; ++c) {
    int v = 0;
    if (c < n)
      v = counts == nullptr ? cap
                            : min(max(__ldg(counts + c * E + e), 0), cap);
    if (Bcast) v = __shfl_sync(0xffffffffu, v, 0);
    cnt[c] = v;
    at[c + 1] = at[c] + (v + kAtomRows - 1) / kAtomRows;
  }
}

// atom q of an item (q < at[kGMaxN]): its chunk, its first row in the
// chunk's block, and that block's live rows
struct Atom {
  int c, row0, live;
};

__device__ __forceinline__ Atom atom_of(const int (&cnt)[kGMaxN],
                                        const int (&at)[kGMaxN + 1], int q) {
  Atom r{0, 0, 0};
#pragma unroll
  for (int c = 0; c < kGMaxN; ++c)
    if (q >= at[c] && q < at[c + 1])
      r = Atom{c, (q - at[c]) * kAtomRows, cnt[c]};
  return r;
}

// pre[0..E] (shared): pre[e] the live rows of the blocks before e of
// chunk ch, so the chunk's live rows are one flat list in expert order
__device__ __forceinline__ void live_prefix(const int* counts, int ch, int E,
                                            int cap, int* pre) {
  for (int e = threadIdx.x; e < E; e += blockDim.x)
    pre[e + 1] = counts == nullptr
                     ? cap
                     : min(max(__ldg(counts + size_t(ch) * E + e), 0), cap);
  __syncthreads();
  if (threadIdx.x < 32) {  // warp 0 scans, 32 blocks at a time
    const int lane = threadIdx.x;
    int carry = 0;
    for (int b = 0; b < E; b += 32) {
      int v = b + lane < E ? pre[b + lane + 1] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += y;
      }
      if (b + lane < E) pre[b + lane + 1] = carry + v;
      carry += __shfl_sync(0xffffffffu, v, 31);
    }
    if (lane == 0) pre[0] = 0;
  }
  __syncthreads();
}

// one row of `words` 16-byte words by a warp, 8 loads a lane in flight;
// src may be data another rank delivered (__ldcg)
__device__ __forceinline__ void copy_row(uint4* dst, const uint4* src,
                                         int words, int lane) {
  constexpr int U = 8;
  for (int w0 = lane; w0 < words; w0 += 32 * U) {
    uint4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (w0 + 32 * u < words) v[u] = __ldcg(src + w0 + 32 * u);
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (w0 + 32 * u < words) dst[w0 + 32 * u] = v[u];
  }
}

// The grouped ring, run by the first `producers` blocks of rank me (whole
// blocks; bf16 rows of K): ring_forward's protocol over the live rows
// only. Without counts every row is live, and the own shard is also
// published into the own partition (return_gathered); with counts it is
// not (the wrapper refuses return_gathered with counts). pre: E + 1 ints
// of shared memory.
__device__ __forceinline__ void ring_forward_live(
    const char* a, char* ws, int* flags, const int* counts, int m, int K,
    int cap, int E, int producers, int straggle_rank, long long straggle_ns,
    int* pre) {
  const int n = gridDim.y, me = blockIdx.y, right = (me + 1) % n;
  int* mine = flags + size_t(me) * n;
  shmem::straggler_delay(straggle_rank, me, straggle_ns);
  const size_t row_bytes = size_t(K) * 2, chunk = size_t(m) * row_bytes;
  const int words = K / 8;  // 16-byte words a row
  const int warps = blockDim.x / 32, lane = threadIdx.x % 32;
  const int gw = blockIdx.x * warps + threadIdx.x / 32;
  if (counts == nullptr) {
    const long long all = (long long)(chunk / 16);
    copy_words(reinterpret_cast<uint4*>(ws + (size_t(me) * n + me) * chunk),
               reinterpret_cast<const uint4*>(a + me * chunk),
               all * blockIdx.x / producers,
               all * (blockIdx.x + 1) / producers);
  }
  for (int s = 0; s < n - 1; ++s) {
    const int ch = (me - s + n) % n;  // the chunk this step forwards
    if (s > 0)  // chunk ch arrived from the left at step s - 1
      hopper::wait_eq_if(mine + s, producers, threadIdx.x == 0);
    // (its barriers also order that acquire before the reads below)
    live_prefix(counts, ch, E, cap, pre);
    const char* src =
        s == 0 ? a + me * chunk : ws + (size_t(me) * n + ch) * chunk;
    char* dst = ws + (size_t(right) * n + ch) * chunk;
    for (int r = gw; r < pre[E]; r += producers * warps) {
      int lo = 0, hi = E;  // the block e with pre[e] <= r < pre[e + 1]
      while (hi - lo > 1) {
        const int mid = (lo + hi) / 2;
        if (pre[mid] <= r)
          lo = mid;
        else
          hi = mid;
      }
      const size_t off = (size_t(lo) * cap + (r - pre[lo])) * row_bytes;
      copy_row(reinterpret_cast<uint4*>(dst + off),
               reinterpret_cast<const uint4*>(src + off), words, lane);
    }
    shmem::signal_add(flags + size_t(right) * n + 1 + s, 1);
  }
}

template <int BN, int H, typename O>
__global__ void __launch_bounds__(kGThreads, 1)
ag_gemm_grouped_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                             const __grid_constant__ CUtensorMap map_ws,
                             const __grid_constant__ CUtensorMap map_b0,
                             const __grid_constant__ CUtensorMap map_b1,
                             const char* a, char* ws, O* c, int* flags,
                             const int* counts, int m, int K, int N, int E,
                             int arrival, int straggle_rank,
                             long long straggle_ns) {
  typedef GroupedCfg<BN, H> Cfg;
  constexpr int S = Cfg::kStages, NB = Cfg::kNB;
  extern __shared__ uint8_t wg_smem[];
  __shared__ __align__(8) uint64_t full_bar[S], empty_bar[S];
  const int n = gridDim.y, me = blockIdx.y, cap = m / E;
  const int producers = min(kProducers, int(gridDim.x));
  const int NT = (N + BN - 1) / BN, items = E * NT;
  const int KT = (K + kBK - 1) / kBK;
  int* mine = flags + size_t(me) * n;
  const uint32_t base = (hopper::smem_addr(wg_smem) + 1023) & ~1023u;
  O* C = c + size_t(me) * n * m * N;

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      hopper::mbar_init(hopper::smem_addr(&full_bar[i]), 1);
      hopper::mbar_init(hopper::smem_addr(&empty_bar[i]), 1);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();
  if (int(blockIdx.x) < producers) {
    // the ring first; its prefix table sits where the stages will
    ring_forward_live(
        a, ws, flags, counts, m, K, cap, E, producers, straggle_rank,
        straggle_ns,
        reinterpret_cast<int*>(wg_smem + (base - hopper::smem_addr(wg_smem))));
    __syncthreads();
  }

  // the warp, warp-uniform to the compiler (a wgmma in a path it cannot
  // prove uniform is serialized: ptxas C7518)
  const int warp = __shfl_sync(0xffffffffu, int(threadIdx.x) / 32, 0);
  if (warp == 0) {
    if (threadIdx.x != 0) return;
    // the TMA thread: my items' stages
    int stage = 0, deferred = 0;
    uint32_t phase = 0;
    bool ready = false;  // every step of the ring has arrived
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const int e = it / NT, j0 = it % NT * BN;
      int cnt[kGMaxN], at[kGMaxN + 1];
      item_rows<false>(counts, n, E, cap, e, cnt, at);
      const int atoms = at[kGMaxN];
      // the A atoms of M tile mt at K step kt into stage memory st
      auto load_a = [&](uint32_t st, uint32_t fb, int mt, int kt) {
        for (int g = 0; g < 8 && 8 * mt + g < atoms; ++g) {
          const Atom t = atom_of(cnt, at, 8 * mt + g);
          const int row = e * cap + t.row0;
          if (t.c == me)
            hopper::tma_load_2d(st + g * kAtomBytes, &map_a, fb, kt * kBK,
                                me * m + row);
          else
            hopper::tma_load_2d(st + g * kAtomBytes, &map_ws, fb, kt * kBK,
                                (me * n + t.c) * m + row);
        }
      };
      for (int mt = 0; 8 * mt < atoms; ++mt) {
        const int used = min(8, atoms - 8 * mt);
        for (int kt = 0; kt < KT; ++kt) {
          const uint32_t fb = hopper::smem_addr(&full_bar[stage]);
          hopper::mbar_wait_quiet(hopper::smem_addr(&empty_bar[stage]),
                                  phase ^ 1);
          hopper::mbar_expect_tx(fb, used * kAtomBytes + H * NB * kBox);
          const uint32_t st = base + stage * Cfg::kStageBytes;
#pragma unroll
          for (int h = 0; h < H; ++h)
#pragma unroll
            for (int j = 0; j < NB; ++j)
              hopper::tma_load_4d(st + (1 + h * NB + j) * kBox,
                                  h ? &map_b1 : &map_b0, fb, j0 + 64 * j,
                                  kt * kBK, e, me);
          if (ready) {
            load_a(st, fb, mt, kt);
          } else if (++deferred == S || kt == KT - 1) {
            // B of the first `deferred` stages (stages 0.., K steps 0..
            // of this first tile) went out without waiting; their A rows
            // need every step of the ring: wait for the arrivals, then
            // order the ring producers' stores before TMA's reads
            for (int s = 1; s < n; ++s)
              hopper::wait_eq_if(mine + s, producers, true);
            hopper::fence_proxy_async_global();
            for (int d = 0; d < deferred; ++d)
              load_a(base + d * Cfg::kStageBytes,
                     hopper::smem_addr(&full_bar[d]), mt, d);
            ready = true;
          }
          if (++stage == S) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  if (warp < 4) {  // warps 1-3: my items' dead rows, zeroed
    if (counts == nullptr) return;
    const int t = threadIdx.x - 32;
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    constexpr int per = 16 / int(sizeof(O));  // outputs a 16-byte word
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const int e = it / NT, j0 = it % NT * BN;
      const int wpr = min(BN, N - j0) / per;  // 16-byte words a row
      int cnt[kGMaxN], at[kGMaxN + 1];
      item_rows<false>(counts, n, E, cap, e, cnt, at);
#pragma unroll
      for (int ch = 0; ch < kGMaxN; ++ch) {
        if (ch >= n) break;
        const int s = (me - ch + n) % n;
        O* D = C + (size_t(arrival ? s : ch) * m + size_t(e) * cap) * N + j0;
        for (int w = t; w < (cap - cnt[ch]) * wpr; w += 96)
          *reinterpret_cast<uint4*>(D + size_t(cnt[ch] + w / wpr) * N +
                                    w % wpr * per) = zero;
      }
    }
    return;
  }

  // the consumer warpgroup (warps 4-7): 64 x BN tiles of my items
  const int wq = warp - 4, lane = threadIdx.x % 32;
  const bool leader = threadIdx.x == 128;
  int stage = 0;
  uint32_t phase = 0;
  auto release = [&](int s) {
    hopper::mbar_arrive_if(hopper::smem_addr(&empty_bar[s]), leader);
  };
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int e = it / NT, j0 = it % NT * BN, cols = min(BN, N - j0);
    int cnt[kGMaxN], at[kGMaxN + 1];
    item_rows<true>(counts, n, E, cap, e, cnt, at);
    const int atoms = at[kGMaxN];
    for (int mt = 0; 8 * mt < atoms; ++mt) {
      float acc[H][BN / 2];
#pragma unroll
      for (int h = 0; h < H; ++h)
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[h][i] = 0.f;
#pragma unroll
      for (int h = 0; h < H; ++h) hopper::fence_regs(acc[h]);
      int prev = 0;
      for (int kt = 0; kt < KT; ++kt) {
        hopper::mbar_wait_quiet(hopper::smem_addr(&full_bar[stage]), phase);
        const uint32_t st = base + stage * Cfg::kStageBytes;
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          const uint64_t da = hopper::desc_sw128(st + kk * 32, 16, 1024);
#pragma unroll
          for (int h = 0; h < H; ++h)
            hopper::wgmma<BN>(
                acc[h], da,
                hopper::desc_sw128(st + (1 + h * NB) * kBox + kk * 2048,
                                   kBox, 1024),
                1);
        }
        hopper::wgmma_commit();
        // the group of kt - 1 is done: its stage goes back
        hopper::wgmma_wait<1>();
        if (kt > 0) release(prev);
        prev = stage;
        if (++stage == S) {
          stage = 0;
          phase ^= 1;
        }
      }
      hopper::wgmma_wait<0>();
      release(prev);
#pragma unroll
      for (int h = 0; h < H; ++h) hopper::fence_regs(acc[h]);
      // each live row to its C row (arrival or rank order)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = 16 * wq + lane / 4 + 8 * hr;  // of the 64-row tile
        const int q = 8 * mt + row / kAtomRows;
        const Atom t = atom_of(cnt, at, q);
        const int lr = t.row0 + row % kAtomRows;
        if (q >= atoms || lr >= t.live) continue;
        const int s = (me - t.c + n) % n;
        O* D = C + (size_t(arrival ? s : t.c) * m + size_t(e) * cap + lr) * N +
               j0;
#pragma unroll
        for (int i = 0; i < BN / 8; ++i) {
          const int col = 8 * i + 2 * (lane % 4);
          if (col >= cols) continue;
          float v0 = acc[0][4 * i + 2 * hr], v1 = acc[0][4 * i + 2 * hr + 1];
          if (H == 2) {
            v0 = silu_mul_wg(v0, acc[H - 1][4 * i + 2 * hr]);
            v1 = silu_mul_wg(v1, acc[H - 1][4 * i + 2 * hr + 1]);
          }
          put_pair(v0, v1, D + col);
        }
      }
    }
  }
}

// the four maps of a grouped call: a (n*m, K) and ws (n*n*m, K) in boxes
// of one 8-row atom; b0 and b1 (N, K, E, n) through B's strides. L2 lines
// of 128 bytes: a box row is 128 bytes, and at the [gate | up] stack's
// 768-byte rows a 256-byte promotion fetches the neighbouring item's
// bytes too (fused prefill 433-453 -> 409-415 µs, NVIDIA H100 80GB HBM3;
// PERF.md)
bool encode_grouped_maps(CUtensorMap (&maps)[4], const void* a,
                         const void* ws, const void* b0, const void* b1,
                         int n, int m, int K, int N, int E, int ldb,
                         long long b_es, long long b_rs) {
  const uint64_t da[2] = {uint64_t(K), uint64_t(n) * m};
  const uint64_t dw[2] = {uint64_t(K), uint64_t(n) * n * m};
  const uint64_t sa[1] = {uint64_t(K) * 2};
  const uint32_t abox[2] = {64, kAtomRows};
  const uint64_t db[4] = {uint64_t(N), uint64_t(K), uint64_t(E),
                          uint64_t(n)};
  const uint64_t sb[3] = {uint64_t(ldb) * 2, uint64_t(b_es) * 2,
                          uint64_t(b_rs) * 2};
  const uint32_t bbox[4] = {64, 64, 1, 1};
  constexpr CUtensorMapL2promotion kL2 = CU_TENSOR_MAP_L2_PROMOTION_L2_128B;
  return hopper::encode_bf16(&maps[0], a, 2, da, sa, abox, kL2) &&
         hopper::encode_bf16(&maps[1], ws, 2, dw, sa, abox, kL2) &&
         hopper::encode_bf16(&maps[2], b0, 4, db, sb, bbox, kL2) &&
         hopper::encode_bf16(&maps[3], b1, 4, db, sb, bbox, kL2);
}

template <int BN, int H, typename O>
cudaError_t launch_grouped(const void* a, const void* b0, const void* b1,
                           void* ws, void* c, int* flags, const int* counts,
                           int n, int m, int K, int N, int E, int ldb,
                           long long b_es, long long b_rs, int arrival,
                           int sr, long long sns, int* info,
                           cudaStream_t st) {
  typedef GroupedCfg<BN, H> Cfg;
  // the ring's prefix table borrows the stages' shared memory
  if (size_t(E + 1) * sizeof(int) > size_t(Cfg::kStages) * Cfg::kStageBytes)
    return cudaErrorInvalidValue;
  CUtensorMap maps[4];
  if (!encode_grouped_maps(maps, a, ws, b0, b1, n, m, K, N, E, ldb, b_es,
                           b_rs))
    return cudaErrorInvalidValue;
  const int items = E * ((N + BN - 1) / BN);
  return shmem::launch_world(
      ag_gemm_grouped_wgmma_kernel<BN, H, O>, n,
      items > kProducers ? items : kProducers, kGThreads, Cfg::kSmem, st,
      info, maps[0], maps[1], maps[2], maps[3], static_cast<const char*>(a),
      static_cast<char*>(ws), static_cast<O*>(c), flags, counts, m, K, N, E,
      arrival, sr, sns);
}

template <typename O>
cudaError_t launch_grouped_bn(int bn, int pair, const void* a,
                              const void* b0, const void* b1, void* ws,
                              void* c, int* flags, const int* counts, int n,
                              int m, int K, int N, int E, int ldb,
                              long long b_es, long long b_rs, int arrival,
                              int sr, long long sns, int* info,
                              cudaStream_t st) {
#define AGG_LAUNCH(BN, H)                                                  \
  launch_grouped<BN, H, O>(a, b0, b1, ws, c, flags, counts, n, m, K, N, E, \
                           ldb, b_es, b_rs, arrival, sr, sns, info, st)
  if (bn == 64) return pair ? AGG_LAUNCH(64, 2) : AGG_LAUNCH(64, 1);
  if (bn == 128) return pair ? AGG_LAUNCH(128, 2) : AGG_LAUNCH(128, 1);
#undef AGG_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

// Flags a rank needs: the tile counter and one arrival counter per ring
// step (n - 1 of them).
extern "C" int ag_gemm_flag_count(int n) { return n; }

// a (n, m, K); b0, b1 (n, K, N) (b1 = b0 unless pair: silu_pair's gate
// and up); ws (n, n*m, K); all of dtype; c (n, n*m, N) of out_dtype;
// flags (n, ag_gemm_flag_count) zeroed. K and N multiples of 16 bytes'
// worth of elements. dtype, out_dtype: 0 = float32, 1 = bfloat16 (f32
// in: f32 out). pair: silu_pair epilogue. arrival: C's row blocks in
// ring-arrival order. body: 0 the mma.sync body; 1 the wgmma body (bf16
// in, m a multiple of 64, K and N at least 64; bn: C columns a tile, of
// each half with pair: 128, 192 or 256, pair 64 or 128).
// straggle_rank / straggle_ns: that rank's ring producers stall on entry
// (-1 / 0: none). info: 3 ints (see launch_world). Returns a
// cudaError_t.
extern "C" int ag_gemm_launch(const void* a, const void* b0, const void* b1,
                              void* ws, void* c, void* flags, int n, int m,
                              int K, int N, int dtype, int out_dtype,
                              int pair, int arrival, int body, int bn,
                              int straggle_rank, long long straggle_ns,
                              void* info, void* stream) {
  const int per = dtype == 1 ? 8 : 4;
  if (n < 1 || m < 1 || K < 1 || N < 1 || K % per || N % per)
    return int(cudaErrorInvalidValue);
  if (body == 1) {
    if (dtype != 1 || m % 64 || K < 64 || N < 64)
      return int(cudaErrorInvalidValue);
    CUtensorMap maps[6];
    if (!encode_maps(maps, a, ws, b0, b1, n, m, K, N))
      return int(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    int* fl = static_cast<int*>(flags);
    int* inf = static_cast<int*>(info);
    if (out_dtype == 0)
      return int(launch_wgmma_bn<float>(bn, pair, 0, maps, a, ws, c, fl, n,
                                        m, K, N, K * 2, arrival,
                                        straggle_rank, straggle_ns, inf, st));
    if (out_dtype == 1)
      return int(launch_wgmma_bn<unsigned short>(
          bn, pair, 0, maps, a, ws, c, fl, n, m, K, N, K * 2, arrival,
          straggle_rank, straggle_ns, inf, st));
    return int(cudaErrorInvalidValue);
  }
  if (body != 0) return int(cudaErrorInvalidValue);
  const int esize = dtype == 1 ? 2 : 4;
  const Geometry dense{n * m, 1, N, K * esize, 0, (long long)K * N,
                       straggle_rank, straggle_ns};
  return launch_any(a, b0, b1, ws, c, flags, n, m, K, N, dtype, out_dtype, 0,
                    pair, arrival, dense, info, stream);
}

// The host cost of the wgmma body's tensor maps: encodes the four maps of
// a call (as ag_gemm_launch would) `reps` times; returns 0, or a
// cudaError_t when one does not encode.
extern "C" int ag_gemm_encode_maps(const void* a, const void* b0,
                                   const void* b1, const void* ws, int n,
                                   int m, int K, int N, int reps) {
  CUtensorMap maps[6];
  for (int i = 0; i < reps; ++i)
    if (!encode_maps(maps, a, ws, b0, b1, n, m, K, N))
      return int(cudaErrorInvalidValue);
  return 0;
}

// The quantized wire (dense form): aw (n, m, kw) int8 wire images of A
// (K payload bytes, e4m3 when fp8 else int8, the row's f32 scale at byte
// K; K a multiple of 128, kw a multiple of 16); ws (n, n*m, kw) int8; b
// (n, K, N) of dtype; c (n, n*m, N) of out_dtype; the rest as
// ag_gemm_launch. A is dequantized to dtype right before its product:
// body 0 in the mma.sync / FMA body's A load, body 1 (bf16 in, m a
// multiple of 64, K and N at least 64; bn 128, 192 or 256) by the wgmma
// body's transform warps.
extern "C" int ag_gemm_wire_launch(const void* aw, const void* b, void* ws,
                                   void* c, void* flags, int n, int m, int K,
                                   int N, int kw, int dtype, int out_dtype,
                                   int fp8, int arrival, int body, int bn,
                                   void* info, void* stream) {
  const int per = dtype == 1 ? 8 : 4;
  if (n < 1 || m < 1 || K < 1 || N < 1 || K % 128 || N % per || kw % 16 ||
      kw < K + 4)
    return int(cudaErrorInvalidValue);
  if (body == 1) {
    CUtensorMap maps[6];
    if (dtype != 1 || m % 64 || K < 64 || N < 64 ||
        !encode_wire_maps(maps, aw, ws, b, n, m, K, N, kw))
      return int(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    int* fl = static_cast<int*>(flags);
    int* inf = static_cast<int*>(info);
    const int W = fp8 ? 1 : 2;
    if (out_dtype == 0)
      return int(launch_wgmma_bn<float>(bn, 0, W, maps, aw, ws, c, fl, n, m,
                                        K, N, kw, arrival, -1, 0, inf, st));
    if (out_dtype == 1)
      return int(launch_wgmma_bn<unsigned short>(bn, 0, W, maps, aw, ws, c,
                                                 fl, n, m, K, N, kw, arrival,
                                                 -1, 0, inf, st));
    return int(cudaErrorInvalidValue);
  }
  if (body != 0) return int(cudaErrorInvalidValue);
  const Geometry dense{n * m, 1, N, kw, 0, (long long)K * N, -1, 0};
  return launch_any(aw, b, b, ws, c, flags, n, m, K, N, dtype, out_dtype,
                    fp8 ? 1 : 2, 0, arrival, dense, info, stream);
}

// The grouped form: a (n, m, K) with m = E * cap rows a rank (cap rows an
// expert block); b0, b1 of rank r and expert e at b + r * b_rs + e * b_es,
// K rows ldb elements apart (N <= ldb); c (n, n*m, N). ldb, b_es, b_rs
// and both B base addresses multiples of 16 bytes' worth of elements.
// body 0: the mma.sync / FMA body (every row live; counts must be null).
// body 1: ag_gemm_grouped_wgmma_kernel (bf16 in, n <= 8, K and N at least
// 64; bn: 64 or 128 columns a tile, of each half with pair), with counts
// null (every row live) or (n, E) int32 on the card: the live rows of each
// (chunk, block), clamped to [0, cap]; the rows past them are taken as
// zero and their C rows are zero.
extern "C" int ag_gemm_grouped_launch(
    const void* a, const void* b0, const void* b1, void* ws, void* c,
    void* flags, const void* counts, int n, int m, int K, int N, int dtype,
    int out_dtype, int pair, int arrival, int E, int ldb, long long b_es,
    long long b_rs, int body, int bn, int straggle_rank,
    long long straggle_ns, void* info, void* stream) {
  const int per = dtype == 1 ? 8 : 4;
  if (n < 1 || m < 1 || K < 1 || N < 1 || K % per || N % per || E < 1 ||
      m % E || ldb < N || ldb % per || b_es % per || b_rs % per)
    return int(cudaErrorInvalidValue);
  if (body == 1) {
    if (dtype != 1 || n > kGMaxN || K < 64 || N < 64)
      return int(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    int* fl = static_cast<int*>(flags);
    int* inf = static_cast<int*>(info);
    const int* cn = static_cast<const int*>(counts);
    if (out_dtype == 0)
      return int(launch_grouped_bn<float>(bn, pair, a, b0, b1, ws, c, fl, cn,
                                          n, m, K, N, E, ldb, b_es, b_rs,
                                          arrival, straggle_rank, straggle_ns,
                                          inf, st));
    if (out_dtype == 1)
      return int(launch_grouped_bn<unsigned short>(
          bn, pair, a, b0, b1, ws, c, fl, cn, n, m, K, N, E, ldb, b_es, b_rs,
          arrival, straggle_rank, straggle_ns, inf, st));
    return int(cudaErrorInvalidValue);
  }
  if (body != 0 || counts != nullptr) return int(cudaErrorInvalidValue);
  const int esize = dtype == 1 ? 2 : 4;
  const Geometry grouped{m / E, E, ldb, K * esize, b_es, b_rs,
                         straggle_rank, straggle_ns};
  return launch_any(a, b0, b1, ws, c, flags, n, m, K, N, dtype, out_dtype, 0,
                    pair, arrival, grouped, info, stream);
}

extern "C" const char* ag_gemm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
