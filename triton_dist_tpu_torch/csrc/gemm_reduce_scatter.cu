// GEMM + ReduceScatter over the virtual world of one card, sm_90a.
//
// Replaces the Pallas TPU kernels reached through `gemm_rs` in
// triton_dist_tpu/kernels/gemm_reduce_scatter.py: `_gemm_rs_kernel`
// (resident B) and `_gemm_rs_kernel_streamed` (streamed B) with their
// shared ring `_rs_ring`, and, at n = 1, `_local_mm_kernel` (the same
// kernel with one rank). Same function: a (n, M, K) and b (n, K, N)
// rank-stacked; rank c keeps out[c] = sum over r of
// (a[r] @ b[r])[c*m : (c+1)*m], m = M / n. With a_order "arrival", a[r]
// holds its row blocks in ag_gemm's ring-arrival order (block s = chunk
// (r - s) mod n, allgather_gemm.cu), and the producer reads chunk c from
// block (r - c) mod n: the JAX kernel's `_src_slot` remap, an index
// change and no copy.
//
// Design: producer GEMM -> tile counter -> consumer reduce, the form of
// the reference's GEMM+RS (SURVEY.md). Each rank computes its partial
// product tile by tile inside the kernel and puts each (BM x BN) tile of
// chunk c into slot `me` of rank c's partition of the heap
// (heap((n, m, N)) of every rank, i.e. (n, n, m, N)), rounded to the
// output dtype as the JAX kernel's partials are, then adds one to that
// tile's counter in rank c's flag pool. After its producer tiles, each
// block of rank c takes tiles of its own chunk, waits until a tile's
// counter reaches n, folds the n slots in rank order 0..n-1 in f32 and
// writes the tile in the output dtype once. The TPU kernel runs a
// two-slot credit ring because VMEM holds only two partial chunks at a
// time; device memory holds all n slots of a chunk, so the port needs
// no credits and no ring order, and every rank's partials are in flight
// at once. All n ranks run in one cooperative launch; producer tiles
// never wait, so the consumer waits cannot form a cycle.
//
// Tile bodies. The main path's form (native wire, bf16 in and out, m a
// multiple of 64, 1 <= n <= 8) runs gemm_rs_wgmma_kernel below: TMA,
// wgmma, warp specialisation and a persistent schedule whose folds
// overlap the last producer tiles; at n = 1 (force_kernel, the JAX
// `_local_mm_kernel`'s place) its epilogue stores each rounded tile
// straight to the output, with no slot, counter or fold; the wire's
// partials mode (below) at the same shapes stores each f32 tile the same
// way into its rank's partial. Every other call (a decode step's m = 1,
// f32, f32 out, the partials of f32 inputs or of ragged m) runs
// gemm_rs_kernel with one of two bodies. bf16: 128 x 128 output tiles,
// 8 warps of 64 x 32, mma.sync m16n8k16 with f32 accumulation, the A
// and B tiles staged in shared memory with cp.async in a three-stage
// ring, rows padded by 16 bytes so ldmatrix is free of bank conflicts
// (the fragment code of flash_prefill.cu, tile.cuh). f32: 64 x 64
// tiles on the CUDA cores with FMA, so the kernel can be held to a tight
// tolerance. Both leave every tile counter at zero (the owner resets it
// once its wait is met), so the wrapper keeps counters and slots across
// calls.
//
// What bounds it on an H100: operations, 2 * n * M * K * N at the
// model's shapes (the bf16 tensor-core peak), against n * (M*K + K*N)
// inputs read and n * m * N written. The wgmma body, like ag_gemm's
// (PERF.md), is held back by the bytes its tiles load into the SMs.
// `straggle_rank` stalls one rank's blocks on entry (the JAX
// straggler_rank / straggler_ns): its partials arrive late, and the
// owners' folds wait for them.
//
// The output dtype O may differ from the input's (bf16 in, f32 out: the
// JAX out_dtype, which on the native wire is also the accumulation
// dtype): the slots hold partials rounded to O, the fold is f32, the
// output O. The quantized wire (JAX `_rs_ring` with a wire format) is
// two launches, JAX's own fallback structure (`_wire_rs_xla(partial)`):
// this kernel in its partials mode (the wgmma body at the main form's
// shapes, else gemm_rs_kernel), every rank's f32 partial of every chunk
// written to a plain (n, M, N) buffer with no flags and no fold, then the
// wire ring of csrc/reduce_scatter.cu (`ring_rs_wire_kernel`) on those
// partials. The ring order with per-hop requantization is a different
// function from this kernel's all-slots rank-order fold, so the wire
// form cannot reuse the fold; fusing the two launches is later work (a
// per-row scale spans a row's N columns, so a hop needs a whole row band
// of the partial, not a tile).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "shmem.cuh"
#include "tile.cuh"

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(unsigned short x) {
  return __bfloat162float(__ushort_as_bfloat16(x));
}
__device__ __forceinline__ void from_f32(float v, float& o) { o = v; }
__device__ __forceinline__ void from_f32(float v, unsigned short& o) {
  o = __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
// two adjacent outputs (8-byte aligned for f32, 4 for bf16)
__device__ __forceinline__ void put_pair(float v0, float v1,
                                         unsigned short* p) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(v0, v1);
}
__device__ __forceinline__ void put_pair(float v0, float v1, float* p) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}

// ---- bf16 tile body: mma.sync on the tensor cores ------------------------

struct Bf16Body {
  typedef unsigned short S;  // bf16 bits
  static constexpr int BM = 128, BN = 128, BK = 32;
  static constexpr int kThreads = 256, kStages = 3;
  static constexpr int AST = BK + 8;  // smem row strides (+16 bytes)
  static constexpr int BST = BN + 8;
  static constexpr int kStage = BM * AST + BK * BST;  // bf16 per stage
  static constexpr size_t kSmem = sizeof(bf16) * kStage * kStages;

  // dst[rows x cols] (leading dim N, dtype O) = a[rows x K] @ b[K x
  // cols], the edges zero-filled on load and masked on store; K, N
  // multiples of 8
  template <typename O>
  static __device__ __forceinline__ void tile(const S* a, int rows,
                                              const S* b, int cols, int K,
                                              int N, O* dst, void* smem) {
    bf16* sm = static_cast<bf16*>(smem);
    const bf16* A = reinterpret_cast<const bf16*>(a);
    const bf16* B = reinterpret_cast<const bf16*>(b);
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
    const int KT = (K + BK - 1) / BK;

    auto load = [&](int kt, int stage) {
      bf16* as = sm + stage * kStage;
      bf16* bs = as + BM * AST;
      const int k0 = kt * BK;
#pragma unroll
      for (int q = 0; q < 2; ++q) {  // A: 128 rows x 4 chunks of 8
        const int idx = tid + q * kThreads, r = idx >> 2, kc = (idx & 3) * 8;
        const bool ok = r < rows && k0 + kc < K;
        cp_async16(as + r * AST + kc, ok ? A + size_t(r) * K + k0 + kc : A,
                   ok);
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {  // B: 32 rows x 16 chunks of 8
        const int idx = tid + q * kThreads, r = idx >> 4, nc = (idx & 15) * 8;
        const bool ok = k0 + r < K && nc < cols;
        cp_async16(bs + r * BST + nc, ok ? B + size_t(k0 + r) * N + nc : B,
                   ok);
      }
    };

    float acc[4][4][4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < KT) load(s, s);
      cp_async_commit();
    }
    for (int kt = 0; kt < KT; ++kt) {
      cp_async_wait<kStages - 2>();  // stage kt has landed
      __syncthreads();               // and every warp is done with kt - 1
      if (kt + kStages - 1 < KT) load(kt + kStages - 1, (kt + kStages - 1) % kStages);
      cp_async_commit();  // possibly empty: keeps the group count uniform
      const bf16* as = sm + (kt % kStages) * kStage;
      const bf16* bs = as + BM * AST;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t af[4][4], bfr[2][4];
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
          ldsm_x4(af[mi], as + (wm + mi * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * AST +
                              kk * 16 + 8 * (lane >> 4));
#pragma unroll
        for (int nj = 0; nj < 2; ++nj)
          ldsm_x4_trans(bfr[nj], bs + (kk * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * BST +
                                     wn + nj * 16 + 8 * (lane >> 4));
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            mma_bf16(acc[mi][ni], af[mi], bfr[ni >> 1][(ni & 1) * 2],
                     bfr[ni >> 1][(ni & 1) * 2 + 1]);
      }
    }
    cp_async_wait<0>();

#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = wn + ni * 8 + (lane & 3) * 2;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = wm + mi * 16 + (lane >> 2) + 8 * h;
          if (row < rows && col < cols)
            put_pair(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1],
                     dst + size_t(row) * N + col);
        }
      }
  }
};

// ---- f32 tile body: FMA on the CUDA cores --------------------------------

struct F32Body {
  typedef float S;
  static constexpr int BM = 64, BN = 64, BK = 16;
  static constexpr int kThreads = 256;
  static constexpr size_t kSmem = sizeof(float) * BK * (BM + BN);

  template <typename O>
  static __device__ __forceinline__ void tile(const S* a, int rows,
                                              const S* b, int cols, int K,
                                              int N, O* dst, void* smem) {
    float* as = static_cast<float*>(smem);  // [BK][BM], A transposed
    float* bs = as + BK * BM;               // [BK][BN]
    const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int idx = tid + q * kThreads;
        const int ar = idx >> 4, ak = idx & 15;  // A element (ar, k0 + ak)
        as[ak * BM + ar] =
            ar < rows && k0 + ak < K ? a[size_t(ar) * K + k0 + ak] : 0.f;
        const int bk = idx >> 6, bc = idx & 63;  // B element (k0 + bk, bc)
        bs[bk * BN + bc] =
            k0 + bk < K && bc < cols ? b[size_t(k0 + bk) * N + bc] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = as[k * BM + ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = bs[k * BN + tx * 4 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = ty * 4 + i, col = tx * 4 + j;
        if (row < rows && col < cols)
          from_f32(acc[i][j], dst[size_t(row) * N + col]);
      }
  }
};

// ---- the kernel: produce every tile, then fold my chunk -------------------

// PARTIALS: heap is a plain (n, M, N) f32 buffer, rank me's partial of
// chunk c at rows [c * m, (c + 1) * m) of [me]; no flags, no fold.
template <class Body, typename O, bool PARTIALS>
__global__ void __launch_bounds__(Body::kThreads, 2)
gemm_rs_kernel(const typename Body::S* a, const typename Body::S* b,
               O* heap, O* out, int* flags, int M, int K, int N,
               int arrival, int straggle_rank, long long straggle_ns) {
  typedef typename Body::S S;
  constexpr int BM = Body::BM, BN = Body::BN;
  constexpr int kPer = 16 / sizeof(O);  // elements of a 16-byte word
  extern __shared__ uint4 smem[];
  const int n = gridDim.y, me = blockIdx.y, m = M / n;
  const int tm = (m + BM - 1) / BM, tn = (N + BN - 1) / BN;
  const int per_chunk = tm * tn;
  const S* a_me = a + size_t(me) * M * K;
  const S* b_me = b + size_t(me) * K * N;
  shmem::straggler_delay(straggle_rank, me, straggle_ns);

  // producer: my partial of every tile of every chunk, into slot `me` of
  // the owner's partition, one counter add per tile
  for (int t = blockIdx.x; t < n * per_chunk; t += gridDim.x) {
    const int c = t / per_chunk, i = (t % per_chunk) / tn, j = t % tn;
    const int src = arrival ? (me - c + n) % n : c;  // chunk c's row block
    const size_t row0 = PARTIALS ? size_t(me) * M + size_t(c) * m
                                 : (size_t(c) * n + me) * m;
    Body::tile(a_me + (size_t(src) * m + size_t(i) * BM) * K, min(BM, m - i * BM),
               b_me + size_t(j) * BN, min(BN, N - j * BN), K, N,
               heap + (row0 + size_t(i) * BM) * N + size_t(j) * BN, smem);
    if (!PARTIALS)
      shmem::signal_add(flags + size_t(c) * per_chunk + t % per_chunk, 1);
  }
  if (PARTIALS) return;

  // consumer: fold the n slots of each tile of my chunk, rank order
  const O* slots = heap + size_t(me) * n * m * N;
  for (int t = blockIdx.x; t < per_chunk; t += gridDim.x) {
    shmem::signal_wait_until(flags + size_t(me) * per_chunk + t, shmem::kEq,
                             n, "gemm_rs", me, t);
    // every add of this call has landed: back to zero for the next call
    if (threadIdx.x == 0) flags[size_t(me) * per_chunk + t] = 0;
    const int i = t / tn, j = t % tn;
    const int rows = min(BM, m - i * BM), vpr = min(BN, N - j * BN) / kPer;
    for (int v = threadIdx.x; v < rows * vpr; v += blockDim.x) {
      const size_t off = size_t(i * BM + v / vpr) * N + j * BN + (v % vpr) * kPer;
      float acc[kPer];
      for (int r = 0; r < n; ++r) {
        // delivered by rank r: __ldcg after the acquire (shmem.cuh)
        const uint4 w = __ldcg(reinterpret_cast<const uint4*>(
            slots + size_t(r) * m * N + off));
        const O* e = reinterpret_cast<const O*>(&w);
#pragma unroll
        for (int q = 0; q < kPer; ++q)
          acc[q] = r == 0 ? to_f32(e[q]) : acc[q] + to_f32(e[q]);
      }
      uint4 o;
      O* oe = reinterpret_cast<O*>(&o);
#pragma unroll
      for (int q = 0; q < kPer; ++q) from_f32(acc[q], oe[q]);
      *reinterpret_cast<uint4*>(out + size_t(me) * m * N + off) = o;
    }
  }
}

template <class Body>
int tiles_per_chunk(int m, int N) {
  return ((m + Body::BM - 1) / Body::BM) * ((N + Body::BN - 1) / Body::BN);
}

template <class Body, typename O, bool PARTIALS>
cudaError_t launch(const void* a, const void* b, void* heap, void* out,
                   int* flags, int n, int M, int K, int N, int arrival,
                   int sr, long long sns, int* info, cudaStream_t st) {
  typedef typename Body::S S;
  return shmem::launch_world(
      gemm_rs_kernel<Body, O, PARTIALS>, n,
      n * tiles_per_chunk<Body>(M / n, N), Body::kThreads, Body::kSmem, st,
      info, static_cast<const S*>(a), static_cast<const S*>(b),
      static_cast<O*>(heap), static_cast<O*>(out), flags, M, K, N, arrival,
      sr, sns);
}

// ---- the wgmma body: TMA + wgmma, warp-specialised (bf16 in) -------------
//
// The main path's form (native wire, bf16 in and out, m = M / n a
// multiple of 64, 1 <= n <= 8, K and N at least 64): the same function,
// slots, roundings and rank-order f32 fold as gemm_rs_kernel, with
// Hopper's tile body and a persistent schedule:
//   - 384 threads: warpgroup 0 the producer (one thread issues TMA, the
//     warpgroup gives its registers away: setmaxnreg 40), warpgroups 1
//     and 2 the consumers (setmaxnreg 232), each wgmma.mma_async on 64 of
//     a 128 x BN tile's rows, f32 accumulators in registers; a ring of
//     kStages stages, BK = 64, full (TMA bytes) and empty (one arrive a
//     consumer warpgroup) mbarriers: ag_gemm_wgmma_kernel's body;
//   - A from a 2-D map over the rank-stacked (n * M, K): a box is one
//     64-row segment of an output chunk c (m % 64 == 0), read from row
//     block src = (me - c) mod n in arrival order, c in rank order (the
//     `_src_slot` remap); B MN-major from a 3-D map over (n, K, N); K and
//     N edges by TMA's zero fill, stores masked per column;
//   - the epilogue rounds a warpgroup's 64 rows to bf16 into slot `me` of
//     chunk c's owner, then (a warpgroup barrier, one thread's fence and
//     release add) counts them on the segment's counter; at n = 1 it
//     rounds them into the output itself, and a rank has no fold items;
//     in the partials mode (bf16 in, f32 out: the wire's partial GEMM)
//     it stores them in f32, a float2 a thread (a quad's 32-byte
//     sector), into its rank's partial, with no slot, counter or fold
//     item, at any 1 <= n <= 8;
//   - persistent blocks, one an SM: a rank's work items are its producer
//     tiles, column by column (each column's row tiles together, so they
//     read B from L2 and every owner's column completes early), then its
//     fold items, (column, 64-row segment) of its own chunk in the same
//     order; block b takes items b, b + blocks, ... So a block that has
//     no producer tile left folds while others still produce, and a fold
//     item waits only on producer tiles, which never wait: with every
//     block of every rank resident (one cooperative launch), the waits
//     cannot form a cycle. The consumers fold (the producer warpgroup
//     sits them out): one thread's acquire spin for the counter to reach
//     exactly n, a consumer barrier, the n slots read with __ldcg in rank
//     order, two 16-byte words a thread in flight, summed in f32 and
//     rounded once to bf16;
//   - nothing that makes ptxas serialize the wgmma (hopper.cuh,
//     mbar_wait_quiet): no call anywhere in the kernel, and no control
//     flow it cannot prove warp-uniform between them. The bounded waits
//     keep their loops in PTX and trap without a message, one thread's
//     arrives and signals are predicated PTX, and a block's fold items
//     come in a loop of their own after its producer tiles.
// The owner stores 0 to a counter once its wait is met (every add of the
// call has landed), so the counters, like the slots, persist across
// calls in the wrapper's pool (gemm_reduce_scatter._POOLS).

constexpr int kWgThreads = 384;  // a producer warpgroup, two consumers
constexpr int kBK = 64;
constexpr int kBox = 64 * 64 * 2;  // bytes of a 64 x 64 bf16 TMA box
constexpr int kWgSmem = 200 * 1024;  // the stages fill at most this
constexpr int kFoldWords = 2;  // a fold thread's 16-byte outputs in flight

template <int BN>
struct WgCfg {
  static constexpr int kNB = BN / 64;  // B boxes a stage
  static constexpr int kStageBytes = (2 + kNB) * kBox;
  static constexpr int kStages =
      kWgSmem / kStageBytes < 6 ? kWgSmem / kStageBytes : 6;
  static constexpr size_t kSmem = size_t(kStages) * kStageBytes + 1024;
  static_assert(BN % 64 == 0 && BN <= 256, "accumulators a thread");
};

// work of a rank: producer tiles (128 x BN) and fold items (64 x BN;
// none at n = 1, whose producer tiles are the output's, nor in the
// partials mode)
struct WgWork {
  int RT, NT, segs, P, F;  // row tiles, column tiles, segments a chunk
  __host__ __device__ WgWork(int n, int M, int N, int BN, bool partials)
      : RT((M + 127) / 128), NT((N + BN - 1) / BN), segs(M / n / 64),
        P(RT * NT), F(n > 1 && !partials ? M / n / 64 * NT : 0) {}
};

// O: the output's element (bf16 bits; f32 in the partials mode).
// PARTIALS: heap is a plain (n, M, N) f32 buffer (gemm_rs_kernel's),
// rank me's partial of chunk c at rows [c * m, (c + 1) * m) of [me], each
// tile stored straight there as the n = 1 form stores it into out; no
// slot, counter or fold item, and out and flags are not read
template <int BN, typename O, bool PARTIALS>
__global__ void __launch_bounds__(kWgThreads, 1)
gemm_rs_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_b, O* heap,
                     O* out, int* flags, int M, int K, int N, int arrival,
                     int straggle_rank, long long straggle_ns) {
  typedef WgCfg<BN> Cfg;
  constexpr int S = Cfg::kStages, NB = Cfg::kNB;
  extern __shared__ uint8_t wg_smem[];
  __shared__ __align__(8) uint64_t full_bar[S], empty_bar[S];
  const int n = gridDim.y, me = blockIdx.y, m = M / n;
  const WgWork wk(n, M, N, BN, PARTIALS);
  const int KT = (K + kBK - 1) / kBK;
  const uint32_t base = (hopper::smem_addr(wg_smem) + 1023) & ~1023u;

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      hopper::mbar_init(hopper::smem_addr(&full_bar[i]), 1);
      hopper::mbar_init(hopper::smem_addr(&empty_bar[i]), 2);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();
  shmem::straggler_delay(straggle_rank, me, straggle_ns);

  // the warpgroup, warp-uniform to the compiler (a wgmma in a path it
  // cannot prove uniform is serialized: ptxas C7518)
  const int wg = __shfl_sync(0xffffffffu, int(threadIdx.x) / 128, 0);
  if (wg == 0) {  // the producer warpgroup
    hopper::regs_dec<40>();
    if (threadIdx.x == 0) {  // the TMA loads of my producer tiles
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < wk.P; t += gridDim.x) {
        const int R0 = t % wk.RT * 128, j0 = t / wk.RT * BN;
        const int segs = min(128, M - R0) / 64;
        for (int kt = 0; kt < KT; ++kt) {
          const uint32_t fb = hopper::smem_addr(&full_bar[stage]);
          hopper::mbar_wait_quiet(hopper::smem_addr(&empty_bar[stage]),
                                  phase ^ 1);
          hopper::mbar_expect_tx(fb, (segs + NB) * kBox);
          const uint32_t st = base + stage * Cfg::kStageBytes;
          for (int g = 0; g < segs; ++g) {
            const int R = R0 + 64 * g, c = R / m;
            const int src = arrival ? (me - c + n) % n : c;
            hopper::tma_load_2d(st + g * kBox, &map_a, fb, kt * kBK,
                                me * M + src * m + R - c * m);
          }
#pragma unroll
          for (int j = 0; j < NB; ++j)
            hopper::tma_load_3d(st + (2 + j) * kBox, &map_b, fb, j0 + 64 * j,
                                kt * kBK, me);
          if (++stage == S) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // a consumer warpgroup: rows 64 w .. 64 w + 63 of a producer tile
  hopper::regs_inc<232>();
  const int w = wg - 1, ct = threadIdx.x - 128;
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  int stage = 0;
  uint32_t phase = 0;
  auto advance = [&]() {
    if (++stage == S) {
      stage = 0;
      phase ^= 1;
    }
  };
  const bool leader = threadIdx.x % 128 == 0;  // of my warpgroup
  auto release = [&](int s) {
    hopper::mbar_arrive_if(hopper::smem_addr(&empty_bar[s]), leader);
  };
  // my producer tiles: items b, b + blocks, ... below P
  int it = blockIdx.x;
  for (; it < wk.P; it += gridDim.x) {
    const int R0 = it % wk.RT * 128, j0 = it / wk.RT * BN;
    const int cols = min(BN, N - j0);
    const bool live = 64 * w < M - R0;  // this warpgroup has rows
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    hopper::fence_regs(acc);
    int prev = 0;
    for (int kt = 0; kt < KT; ++kt) {
      hopper::mbar_wait_quiet(hopper::smem_addr(&full_bar[stage]), phase);
      if (live) {
        const uint32_t st = base + stage * Cfg::kStageBytes;
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          hopper::wgmma<BN>(
              acc, hopper::desc_sw128(st + w * kBox + kk * 32, 16, 1024),
              hopper::desc_sw128(st + 2 * kBox + kk * 2048, kBox, 1024),
              1);
        hopper::wgmma_commit();
        // the group of kt - 1 is done: its stage goes back
        hopper::wgmma_wait<1>();
        if (kt > 0) release(prev);
      } else {
        release(stage);
      }
      prev = stage;
      advance();
    }
    if (!live) continue;
    hopper::wgmma_wait<0>();
    release(prev);
    hopper::fence_regs(acc);
    // my partial of the segment into slot `me` of chunk c's owner; at
    // n = 1 the rows are the output's, in the partials mode my rank's
    // rows of the partial (chunks in rank order)
    const int R = R0 + 64 * w, c = R / m, lr = R - c * m;
    O* D = PARTIALS ? heap + (size_t(me) * M + R) * N + j0
           : n == 1 ? out + size_t(R) * N + j0
                    : heap + ((size_t(c) * n + me) * m + lr) * N + j0;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = 16 * warp + lane / 4 + 8 * hr;
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        const int col = 8 * i + 2 * (lane % 4);
        if (col < cols)
          put_pair(acc[4 * i + 2 * hr], acc[4 * i + 2 * hr + 1],
                   D + size_t(row) * N + col);
      }
    }
    if (PARTIALS) continue;
    hopper::named_sync(1 + w, 128);
    hopper::signal_add_if(
        flags + size_t(c) * wk.F + j0 / BN * wk.segs + lr / 64, 1,
        leader && n > 1);
  }
  // then my fold items (bf16 slots; none in the partials mode): no
  // wgmma follows
  if (PARTIALS) return;
  for (; it < wk.P + wk.F; it += gridDim.x) {
    // fold item f of my chunk: (column tile, 64-row segment)
    const int f = it - wk.P, j0 = f / wk.segs * BN, r0 = f % wk.segs * 64;
    // every add of this call has landed: the counter goes back to 0
    hopper::wait_eq_reset_if(flags + size_t(me) * wk.F + f, n, ct == 0);
    hopper::named_sync(3, 256);
    const int vpr = min(BN, N - j0) / 8;  // 16-byte words a row
    const unsigned short* slots =
        reinterpret_cast<const unsigned short*>(heap) +
        (size_t(me) * n * m + r0) * N + j0;
    unsigned short* dst =
        reinterpret_cast<unsigned short*>(out) + (size_t(me) * m + r0) * N +
        j0;
    // kFoldWords words a thread in flight: every slot of each
    for (int v0 = ct; v0 < 64 * vpr; v0 += kFoldWords * 256) {
      uint4 wds[kFoldWords][8];
#pragma unroll
      for (int u = 0; u < kFoldWords; ++u) {
        const int v = v0 + u * 256;
        if (v >= 64 * vpr) break;
        const size_t off = size_t(v / vpr) * N + (v % vpr) * 8;
        // delivered by rank r: __ldcg after the acquire (shmem.cuh)
#pragma unroll
        for (int r = 0; r < 8; ++r)
          if (r < n)
            wds[u][r] = __ldcg(reinterpret_cast<const uint4*>(
                slots + size_t(r) * m * N + off));
      }
#pragma unroll
      for (int u = 0; u < kFoldWords; ++u) {
        const int v = v0 + u * 256;
        if (v >= 64 * vpr) break;
        const size_t off = size_t(v / vpr) * N + (v % vpr) * 8;
        float sum[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          if (r >= n) break;
          const unsigned short* e =
              reinterpret_cast<const unsigned short*>(&wds[u][r]);
#pragma unroll
          for (int q = 0; q < 8; ++q)
            sum[q] = r == 0 ? to_f32(e[q]) : sum[q] + to_f32(e[q]);
        }
        uint4 o;
        unsigned short* oe = reinterpret_cast<unsigned short*>(&o);
#pragma unroll
        for (int q = 0; q < 8; ++q) from_f32(sum[q], oe[q]);
        *reinterpret_cast<uint4*>(dst + off) = o;
      }
    }
  }
}

// the two maps of a call: a (n * M, K) 2-D, b (n, K, N) 3-D
bool encode_maps(CUtensorMap (&maps)[2], const void* a, const void* b,
                 int n, int M, int K, int N) {
  const uint64_t da[2] = {uint64_t(K), uint64_t(n) * M};
  const uint64_t sa[1] = {uint64_t(K) * 2};
  const uint64_t db[3] = {uint64_t(N), uint64_t(K), uint64_t(n)};
  const uint64_t sb[2] = {uint64_t(N) * 2, uint64_t(K) * N * 2};
  const uint32_t box[3] = {64, 64, 1};
  return hopper::encode_bf16(&maps[0], a, 2, da, sa, box) &&
         hopper::encode_bf16(&maps[1], b, 3, db, sb, box);
}

template <int BN, typename O, bool PARTIALS>
cudaError_t launch_wgmma(const void* a, const void* b, void* heap, void* out,
                         int* flags, int n, int M, int K, int N, int arrival,
                         int sr, long long sns, int* info, cudaStream_t st) {
  CUtensorMap maps[2];
  if (!encode_maps(maps, a, b, n, M, K, N)) return cudaErrorInvalidValue;
  const WgWork wk(n, M, N, BN, PARTIALS);
  return shmem::launch_world(
      gemm_rs_wgmma_kernel<BN, O, PARTIALS>, n, wk.P + wk.F, kWgThreads,
      WgCfg<BN>::kSmem, st, info, maps[0], maps[1], static_cast<O*>(heap),
      static_cast<O*>(out), flags, M, K, N, arrival, sr, sns);
}

// the native body (bf16 out) or the partials mode (f32 out) by tile width
template <typename O, bool PARTIALS>
cudaError_t launch_wgmma_bn(int bn, const void* a, const void* b, void* heap,
                            void* out, int* flags, int n, int M, int K,
                            int N, int arrival, int sr, long long sns,
                            int* info, cudaStream_t st) {
#define GRS_LAUNCH(BN)                                                      \
  launch_wgmma<BN, O, PARTIALS>(a, b, heap, out, flags, n, M, K, N, arrival, \
                                sr, sns, info, st)
  if (bn == 128) return GRS_LAUNCH(128);
  if (bn == 192) return GRS_LAUNCH(192);
  if (bn == 256) return GRS_LAUNCH(256);
#undef GRS_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

// Flags (tile counters) a rank needs: the output tiles of its chunk
// (the wgmma body, bn > 0: its fold items, 64-row segments x BN columns;
// at n = 1 it uses none).
extern "C" int gemm_rs_flag_count(int m, int N, int dtype, int bn) {
  if (bn > 0) return m / 64 * ((N + bn - 1) / bn);
  return dtype == 1 ? tiles_per_chunk<Bf16Body>(m, N)
                    : tiles_per_chunk<F32Body>(m, N);
}

// a (n, M, K), b (n, K, N) of dtype; heap (n, n, M/n, N) and out (n,
// M/n, N) of out_dtype (partials: heap (n, M, N) f32, out unused and no
// flags); flags (n, gemm_rs_flag_count) zero (each call leaves them at
// zero). M % n == 0; K and N multiples of 16 bytes' worth of elements.
// dtype, out_dtype: 0 = float32, 1 = bfloat16 (f32 inputs: f32 out).
// arrival: a's row blocks in ring-arrival order. body: 0 the mma.sync or
// FMA body; 1 the wgmma body (bf16 in, bf16 out or, in the partials mode,
// f32; 1 <= n <= 8, m a multiple of 64, K and N at least 64; bn: 128,
// 192 or 256 columns a tile; at n = 1 heap and flags are not read).
// straggle_rank / straggle_ns: that rank's blocks stall on entry (-1 /
// 0: none). info: 3 ints (see launch_world). Returns a cudaError_t.
extern "C" int gemm_rs_launch(const void* a, const void* b, void* heap,
                              void* out, void* flags, int n, int M, int K,
                              int N, int dtype, int out_dtype, int partials,
                              int arrival, int body, int bn, int sr,
                              long long sns, void* info, void* stream) {
  const int per = dtype == 1 ? 8 : 4;
  if (n < 1 || M < n || M % n || K < 1 || N < 1 || K % per || N % per ||
      (partials && out_dtype != 0))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* fl = static_cast<int*>(flags);
  int* inf = static_cast<int*>(info);
  if (body == 1) {
    if (dtype != 1 || out_dtype != (partials ? 0 : 1) || n > 8 ||
        (M / n) % 64 || K < 64 || N < 64)
      return int(cudaErrorInvalidValue);
    if (partials)
      return int(launch_wgmma_bn<float, true>(bn, a, b, heap, out, fl, n, M,
                                              K, N, arrival, sr, sns, inf,
                                              st));
    return int(launch_wgmma_bn<unsigned short, false>(
        bn, a, b, heap, out, fl, n, M, K, N, arrival, sr, sns, inf, st));
  }
  if (body != 0) return int(cudaErrorInvalidValue);
  if (dtype == 0 && out_dtype == 0)
    return int(partials ? launch<F32Body, float, true>(
                              a, b, heap, out, fl, n, M, K, N, arrival, sr,
                              sns, inf, st)
                        : launch<F32Body, float, false>(
                              a, b, heap, out, fl, n, M, K, N, arrival, sr,
                              sns, inf, st));
  if (dtype == 1 && out_dtype == 0)
    return int(partials ? launch<Bf16Body, float, true>(
                              a, b, heap, out, fl, n, M, K, N, arrival, sr,
                              sns, inf, st)
                        : launch<Bf16Body, float, false>(
                              a, b, heap, out, fl, n, M, K, N, arrival, sr,
                              sns, inf, st));
  if (dtype == 1 && out_dtype == 1)
    return int(launch<Bf16Body, unsigned short, false>(
        a, b, heap, out, fl, n, M, K, N, arrival, sr, sns, inf, st));
  return int(cudaErrorInvalidValue);
}

extern "C" const char* gemm_rs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
