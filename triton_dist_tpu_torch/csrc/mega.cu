// The decode megakernel: one decode step's task queue in one persistent
// cooperative launch, sm_90a.
//
// Replaces the Pallas TPU kernel that `compile_graph` builds in
// triton_dist_tpu/mega/kernel.py (:980, body :1192, launched at :1386),
// with its eight branches (:286-925). The queue, the workspace slots and
// the branch arithmetic are the JAX kernel's; how the tasks are spread
// over the card is not.
//
// On the TPU one core walks the queue in program order, so a task's
// inputs are ready when it starts. Here every task is cut into tiles and
// all resident blocks of a rank share them (the reference's scoreboard):
// every block walks the same queue in order and takes the tiles
// i = block, block + blocks, ... of each row. Before a tile, thread 0
// spins (bounded, shmem::spin_until) until the completion counter of each
// producer task holds that producer's tile count; after it, the block
// syncs and adds one to its own task's counter with release semantics.
// The counters are one zeroed int32 a (task, rank), from the virtual
// world's flag pool (runtime/symm_mem.py).
//
// Why it cannot deadlock: the launch is cooperative, so every block is
// resident, and every block walks the same topological order. A tile of
// row r waits only on tiles of rows before r (its producers) and, in the
// AllReduce, on the same tile of row r on the other ranks, which waits
// only on rows before r. By induction over r, every tile of the rows
// before r finishes, every block reaches its tiles of row r after them,
// and row r finishes too.
//
// Branches, with the JAX rounding points (f32 math, rounded to the
// activation dtype where the JAX branch rounds):
//   matmul        y = a @ W[layer] over the B rows, whole-K f32
//                 accumulation rounded once (kernel.py:401-405); tile =
//                 a column block of W and, for a narrow N, a range of K
//                 whose f32 partials the block's last tile adds in K
//                 order before the one rounding. Prologue "rms" (`_rms_f32`,
//                 :192, recomputed each tile from the (B, K) row) or
//                 "silu" (`_silu_f32`, :198), each rounded to the
//                 activation dtype before the product (:350-358).
//   rms_norm      :421, a tile a batch row.
//   silu_mul      :462, add :498 (in the activation dtype), column tiles.
//   allreduce_add at n > 1 each rank's tile puts its column slice into
//                 every rank's mailbox slot for this task, adds one to
//                 that rank's arrival flag of the tile, waits for its own
//                 n arrivals, and folds ranks 0..n-1 in f32 plus the
//                 residual, rounded once (:624-648); at n = 1 partial +
//                 residual in f32. One mailbox slot a task: a launch
//                 never reuses one, so the JAX parity buffers (:608-616)
//                 and their flow control are not needed.
//   attention     :671, a tile a (batch row, kv head): q/k rms-norm,
//                 rope at pos[b] (half split), GQA online softmax over
//                 the cached prefix read through the page table, seeded
//                 with the new token's k/v in f32 (they enter no cache);
//                 writes the attention output and the k_new/v_new rows.
//   barrier       :526, every block of every rank meets once.
//   noop          :925.
//
// What bounds it on an H100: bytes. A decode step reads every weight of
// the layer stack once (Qwen3-8B: 13.89 GB at world 1) plus the KV prefix;
// at B <= 16 the products are far below the ridge. The host cuts each
// matmul so its tiles fill the blocks in one wave (mega/core.py
// mm_tiling), and the matmul branch streams its tile's weight rows
// through a ring of kRingStages stages of kStageBytes in shared memory,
// filled by async copies on mbarriers (hopper.cuh) while the block's
// warps compute from the stages that have landed (the JAX branch's
// double-buffered weight DMA, kernel.py:286-405):
//   - a tile-major weight (mega/kernel.py tile_weight_major: (L, n, N/TN,
//     K, TN), the JAX layout) goes as one 1-D bulk copy a stage, each
//     stage a contiguous run of its tile;
//   - a row-major weight (L, n, K, N) as TMA boxes of (rows, cols)
//     through a 3-D tensor map, one box a stage where the tile is at most
//     256 columns (a bulk copy a weight row streamed 2-2.4x slower,
//     tools/profile_mega.py; PERF.md).
// The ring is one FIFO over the block's whole weight stream (Stream): a
// tile's stages are issued before its producer spin (weights are
// constant through a launch), the slots its last stages free take the
// block's next tile's first stages, and a row of another branch starts
// the next row's tile streaming, so a task boundary finds its stages in
// flight. Across tasks the queue's prefetch hint (mega/scheduler.py
// plan_prefetch, JAX scheduler.py:407) starts the next matmul's first
// stage one row early: at the issuer row each block that owns a tile of
// the consumer issues that tile's first stage into arena slot s (past
// every branch's scratch and the ring, so no branch overwrites a copy in
// flight), at the row's start, or after the row's own read of slot s
// where the row reads it too; the consumer's tile takes its first stage
// from the slot, a cold one loads it itself. Every mbarrier is set up at
// kernel start (a graph replay carries nothing over), its parity kept in
// a bitmask that every thread advances alike, and every copy issued is
// waited for before the launch ends (the plan's validator holds the
// arena to it). A slot that generic loads read is refilled only after a
// __syncthreads() and the issuer's fence.proxy.async.shared::cta.

// Memory order (shmem.cuh's rule): a tile's stores, __syncthreads(),
// thread 0 __threadfence() + release add; a reader's thread 0 acquire
// spin, __syncthreads(), then __ldcg for every workspace and mailbox read
// (another block wrote it, and slots are reused: L1 could hold a stale
// line).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "shmem.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRow = 30;        // queue row (mega/kernel.py ROW)
// the prefetch hint's queue columns: issue code (1 + index into pf_w, 0:
// none), the consumer's layer, the arena slot it fills, and the slot a
// matmul row reads its first stage from (slot + 1, 0: cold)
constexpr int kIssueCode = 26, kIssueLayer = 27, kIssueSlot = 28,
              kConsume = 29;
// shared memory (mega/core.py mirrors these): the branches' scratch, then
// 128-byte aligned the ring, the arena (depth stages), the mbarriers
constexpr int kScratchBytes = 66560;
constexpr int kStageBytes = 32768;
constexpr int kRingStages = 3;
constexpr int kMaxDepth = 2;     // arena slots that fit (mega/core.py MAX_PF_DEPTH)
constexpr int kSmemMax = 232448;  // a block's opt-in maximum on an H100
constexpr int kMaxStageRows = 256;  // a TMA box's most rows
constexpr int kMaxW = 8;        // weight tensors (kernels/mega.py)
constexpr int kChunk = 128;     // cached positions an attention pass
constexpr int kAccPer = 4;      // attention outputs a thread: g*D <= 1024
constexpr int kMaxPV = 32;      // P.V values a lane: g * D / 32 <= 32
constexpr int kPVRows = 4;      // V rows a warp loads before its FMAs

enum Op {
  kMatmul = 0,
  kRmsNorm,
  kSiluMul,
  kAdd,
  kAllReduceAdd,
  kAttention,
  kBarrier,
  kNoop
};

// argument indices: the order of _ARGS in kernels/mega.py
enum Arg {
  A_QUEUE = 0, A_NROWS, A_POS, A_TABLE, A_MAXP, A_WS, A_WS_RANK, A_WS_SLOT,
  A_WMAX, A_BATCH, A_NORMS, A_NORM_W, A_ROPE, A_KPOOL, A_VPOOL, A_HKV_TOT,
  A_NPAGES, A_PAGE, A_MBOX, A_MB_RANK, A_MB_TASK, A_MB_SRC, A_MB_W, A_FLAGS,
  A_FLAG_STRIDE, A_BARRIER_FLAG, A_PARTIAL, A_PARTIAL_STRIDE, A_NW,
  A_DEPTH, A_NSPEC, A_W0,
  A_WLAYER0 = A_W0 + kMaxW,
  A_WRANK0 = A_WLAYER0 + kMaxW,
  A_WTILED0 = A_WRANK0 + kMaxW,
  A_WK0 = A_WTILED0 + kMaxW,
  A_WN0 = A_WK0 + kMaxW,
  A_WTN0 = A_WN0 + kMaxW,
  A_WSPLIT0 = A_WTN0 + kMaxW,
  A_WPLANES0 = A_WSPLIT0 + kMaxW,
  A_PFW0 = A_WPLANES0 + kMaxW,
  A_COUNT = A_PFW0 + kMaxW
};

struct Params {
  CUtensorMap maps[kMaxW];  // row-major weight i as (planes, K, N) boxes
  const int* queue;
  int n_rows;
  const int* pos;
  const int* table;
  int maxp;
  void* ws;
  long long ws_rank, ws_slot;  // elements between ranks, between slots
  int wmax, batch;
  const float* norms;
  int norm_w;
  const float* rope;  // (positions, D) f32: [cos | sin]
  const void* kpool;
  const void* vpool;  // (L, hkv_tot, n_pages, page, D)
  int hkv_tot, n_pages, page;
  void* mbox;  // (n, tasks, n, B, mb_w)
  long long mb_rank, mb_task, mb_src;
  int mb_w;
  int* flags;
  int flag_stride, barrier_flag;
  float* partial;  // (n, partial_stride) f32 partial sums of split matmuls
  long long partial_stride;
  const void* w[kMaxW];
  long long w_layer[kMaxW], w_rank[kMaxW];
  // weight i: tile-major, K, N, and the one (TN, splits) of its matmuls
  // (0 where they differ: then it is never prefetched)
  int w_tiled[kMaxW], w_k[kMaxW], w_n[kMaxW], w_tn[kMaxW], w_split[kMaxW];
  int depth;   // arena slots
  int n_spec;  // prefetch codes 1..n_spec name weights pf_w[code - 1]
  int pf_w[kMaxW];
};

// S: the storage type, float or unsigned short (bf16 bits)
__device__ __forceinline__ float f32(float x) { return x; }
__device__ __forceinline__ float f32(unsigned short x) {
  return __bfloat162float(__ushort_as_bfloat16(x));
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(unsigned short* p, float v) {
  *p = __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
// v rounded to the storage type and back
__device__ __forceinline__ float rnd(float v, float) { return v; }
__device__ __forceinline__ float rnd(float v, unsigned short) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
// a workspace or mailbox element: another block wrote it, past L1
template <typename S>
__device__ __forceinline__ float ldws(const S* p) {
  return f32(__ldcg(p));
}
// VEC = 16 / sizeof(S) consecutive workspace elements (16-byte aligned)
template <typename S, int VEC>
__device__ __forceinline__ void ldws_vec(const S* p, float (&v)[VEC]) {
  const uint4 w = __ldcg(reinterpret_cast<const uint4*>(p));
  const S* e = reinterpret_cast<const S*>(&w);
#pragma unroll
  for (int j = 0; j < VEC; ++j) v[j] = f32(e[j]);
}
__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// sum of v over the block, returned to every thread (red: kWarps floats)
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();  // red may still be read from the last call
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += red[w];
  return s;
}

template <typename S>
__device__ __forceinline__ S* slot(const Params& p, int rank, int s) {
  return static_cast<S*>(p.ws) + rank * p.ws_rank + s * p.ws_slot;
}

// rows of `a` staged a pass: 64 KB of f32, so a tile of K <= 4096 rows
// at B <= 4 stages its `a` once, before its first weight stage
template <int BP>
__host__ __device__ constexpr int a_rows() {
  return 16384 / BP;
}

// a matmul's scratch: the staged rows of `a`, the rms factors, a reduction
template <int BP>
__host__ __device__ constexpr size_t scratch_bytes() {
  return (a_rows<BP>() * BP + BP + kWarps * BP) * sizeof(float);
}
static_assert(scratch_bytes<4>() <= kScratchBytes &&
                  scratch_bytes<16>() <= kScratchBytes,
              "a matmul's scratch runs into the ring");
// the attention's scratch at its widest (g * D <= 1024, D >= 32: q, k / v
// new, logits of kChunk positions, 3 g softmax terms, kWarps P.V
// partials): the ring's stages may be in flight during an attention row
static_assert((1024 + 2 * 256 + 32 * kChunk + 96 + kWarps * 1024) * 4 <=
                  kScratchBytes,
              "the attention's scratch runs into the ring");

// the launch's dynamic shared memory at `depth` arena slots
__host__ __device__ constexpr size_t smem_bytes(int depth) {
  return kScratchBytes + 128 + size_t(kRingStages + depth) * (kStageBytes + 8);
}
static_assert(smem_bytes(kMaxDepth) <= kSmemMax &&
                  smem_bytes(kMaxDepth + 1) > kSmemMax,
              "kMaxDepth: the arena slots a block's shared memory holds");

// weight rows of one stage of a tile tn columns wide: a multiple of 8
// (a pass of `a` and its 16-byte loads stay aligned), at most a TMA box's
// 256 (mega/core.py stage_rows; tiles are at most 512 columns)
__host__ __device__ inline int stage_rows(int tn, int isz) {
  const int r = kStageBytes / (tn * isz) / 8 * 8;
  return r < 8 ? 8 : (r > kMaxStageRows ? kMaxStageRows : r);
}

// columns of a TMA box: the tile's, or the widest multiple of 8 up to
// 256 that divides them
__host__ __device__ inline int box_cols(int tn) {
  if (tn <= 256) return tn;
  for (int b = 256; b > 8; b -= 8)
    if (tn % b == 0) return b;
  return 8;
}

// One matmul tile: column block `col` of W[layer] (TN columns) over its
// rows [kb, kb + KR), in n_st stages of SR rows. A stage lands as TN / TB
// boxes of (SR, TB), one after the other (TB = TN when tile-major).
template <typename S>
struct MmTile {
  const S* w;  // tile-major: the tile's (K, TN) block (row-major: unused)
  int wi, layer, tiled, TN, KR, kb, c0, SR, TB, n_st;
};

template <typename S>
__device__ __forceinline__ MmTile<S> mm_tile(const Params& p, int wi,
                                             int layer, int K, int TN,
                                             int split, int tile, int me) {
  MmTile<S> t;
  const int col = tile / split;
  t.wi = wi;
  t.layer = layer;
  t.tiled = p.w_tiled[wi];
  t.TN = TN;
  t.KR = K / split;
  t.kb = (tile % split) * t.KR;
  t.c0 = col * TN;
  t.SR = stage_rows(TN, sizeof(S));
  t.TB = t.tiled ? TN : box_cols(TN);
  t.n_st = (t.KR + t.SR - 1) / t.SR;
  // tile-major (L, n, N / TN, K, TN), mega/kernel.py w_tile_src
  const S* W = static_cast<const S*>(p.w[wi]) + layer * p.w_layer[wi] +
               me * p.w_rank[wi];
  t.w = W + size_t(col) * K * TN;
  return t;
}

// Stage j of tile t into shared memory at dst, completing mbarrier bar;
// called by every lane of warp 0 alike. Each issuer first orders the
// generic reads of dst before it (a __syncthreads() ordered every
// thread's) ahead of its async writes.
template <typename S>
__device__ __forceinline__ void issue_stage(const Params& p,
                                            const MmTile<S>& t, int j,
                                            int me, uint32_t dst,
                                            uint32_t bar) {
  const int lane = threadIdx.x % 32;
  const int r0 = j * t.SR, rows = min(t.SR, t.KR - r0);
  const uint32_t row_bytes = t.TN * sizeof(S);
  hopper::fence_proxy_async_shared();
  if (t.tiled) {  // one contiguous run of the tile
    if (lane == 0) {
      hopper::mbar_expect_tx(bar, rows * row_bytes);
      hopper::bulk_load(dst, t.w + size_t(t.kb + r0) * t.TN,
                        rows * row_bytes, bar);
    }
  } else if (lane == 0) {  // whole boxes: rows past KR land unused
    hopper::mbar_expect_tx(bar, t.SR * row_bytes);
    for (int b = 0; b < t.TN / t.TB; ++b)
      hopper::tma_load_3d(dst + b * t.SR * t.TB * sizeof(S), &p.maps[t.wi],
                          bar, t.c0 + b * t.TB, t.kb + r0,
                          t.layer * gridDim.y + me);
  }
}

// A block's weight stream: the stages of its matmul tiles in queue order
// (stage 0 of a fed tile from the arena instead) through the ring as a
// FIFO: the n-th stage issued goes to ring slot n % kRingStages and is
// the n-th read, at mbarrier parity (n / kRingStages) & 1. Every thread
// keeps the counters alike (the issue decisions are block-uniform, warp
// 0 issues). Stages of the block's next tile are issued ahead, into
// the slots its current tile no longer needs, and during the non-matmul
// row before it: (la_row, la_tile) is that tile, la_n its ring stages
// already issued.
struct Stream {
  uint32_t issued, consumed;
  int la_row, la_tile, la_n;
};

template <typename S>
__device__ __forceinline__ MmTile<S> row_tile(const Params& p, const int* q,
                                              int tile, int me) {
  return mm_tile<S>(p, q[12], q[1], q[9], q[8], q[15], tile, me);
}

// 1 when the arena holds stage 0 of matmul row q's tile (the row's first)
__device__ __forceinline__ int arena_stages(const int* q, int tile) {
  return q[kConsume] && tile == int(blockIdx.x);
}

// tile t's stages from `from` into the ring while it has room; returns
// the first stage not issued
template <typename S>
__device__ __forceinline__ int top_up(const Params& p, Stream& st,
                                      const MmTile<S>& t, int from, int me,
                                      uint32_t ring, uint32_t bars) {
  for (; from < t.n_st && st.issued - st.consumed < kRingStages; ++from) {
    const int s = st.issued % kRingStages;
    if (threadIdx.x < 32)
      issue_stage<S>(p, t, from, me, ring + s * kStageBytes, bars + 8 * s);
    ++st.issued;
  }
  return from;
}

// The block's next matmul tile after (row, tile), the row's next or the
// first of the next row where that row is a matmul, gets its stages
// issued ahead while the ring has room.
template <typename S>
__device__ void look_ahead(const Params& p, Stream& st, int row, int tile,
                           int me, uint32_t ring, uint32_t bars) {
  if (st.issued - st.consumed >= kRingStages) return;
  const int* q = p.queue + row * kRow;
  int nrow = row, ntile = tile + gridDim.x;
  if (q[0] != kMatmul || ntile >= q[7]) {
    nrow = row + 1;
    ntile = blockIdx.x;
    if (nrow >= p.n_rows || q[kRow] != kMatmul || ntile >= q[kRow + 7])
      return;
  }
  if (st.la_row != nrow || st.la_tile != ntile) {
    st.la_row = nrow;
    st.la_tile = ntile;
    st.la_n = 0;
  }
  const int* nq = p.queue + nrow * kRow;
  const int f = arena_stages(nq, ntile);
  st.la_n = top_up<S>(p, st, row_tile<S>(p, nq, ntile, me), f + st.la_n, me,
                      ring, bars) - f;
}

// the queue row's prefetch hint: this block's tile of the consumer (its
// first, blockIdx.x) has its stage 0 issued into arena slot q[kIssueSlot]
template <typename S>
__device__ void issue_hint(const Params& p, const int* q, int me,
                           uint32_t arena, uint32_t bars) {
  const int wi = p.pf_w[q[kIssueCode] - 1];
  const int split = p.w_split[wi];
  if (blockIdx.x >= p.w_n[wi] / p.w_tn[wi] * split) return;  // no tile here
  __syncthreads();  // the slot's last reads are done
  if (threadIdx.x < 32) {
    const MmTile<S> t = mm_tile<S>(p, wi, q[kIssueLayer], p.w_k[wi],
                                   p.w_tn[wi], split, blockIdx.x, me);
    const int s = q[kIssueSlot];
    issue_stage<S>(p, t, 0, me, arena + s * kStageBytes,
                   bars + 8 * (kRingStages + s));
  }
}

// acc[b][j] += a[b] * W[row][j] for one 16-byte vector of the row
template <typename S, int BP, int VEC>
__device__ __forceinline__ void fma_row(float (&acc)[BP][VEC],
                                        const uint4& wv, const float* a) {
  const S* we = reinterpret_cast<const S*>(&wv);
  float wf[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) wf[j] = f32(we[j]);
#pragma unroll
  for (int b = 0; b < BP; b += 4) {
    const float4 av = *reinterpret_cast<const float4*>(a + b);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      acc[b][j] = fmaf(av.x, wf[j], acc[b][j]);
      acc[b + 1][j] = fmaf(av.y, wf[j], acc[b + 1][j]);
      acc[b + 2][j] = fmaf(av.z, wf[j], acc[b + 2][j]);
      acc[b + 3][j] = fmaf(av.w, wf[j], acc[b + 3][j]);
    }
  }
}

// The last of a column block's `split` tiles to arrive adds their f32
// partial sums in K order and rounds once: each tile's partials are
// written, then its thread 0 fences and takes an arrival (acq_rel), so
// the last arriver sees every tile's partials (read past L1).
__device__ __forceinline__ int atom_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

template <typename S>
__device__ void split_combine(const Params& p, const int* q, int col,
                              int split, int B, int TN, int c0, int me,
                              S* y) {
  __shared__ int last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atom_add_acq_rel(
               p.flags + size_t(me) * p.flag_stride + q[13] + col, 1) ==
           split - 1;
  }
  __syncthreads();
  if (!last) return;
  const float* base = p.partial + me * p.partial_stride + q[16] +
                      size_t(col) * split * B * TN;
  for (int o = threadIdx.x; o < B * TN; o += kThreads) {
    float s = 0.f;
    for (int k = 0; k < split; ++k) s += __ldcg(base + k * B * TN + o);
    store(y + size_t(o / TN) * p.wmax + c0 + o % TN, s);
  }
}

// a_s[kk][b] = prologue(x)[b][k0 + kk] for kk < kc, rounded to S as the
// JAX branch rounds before its product (PRO: 0 none, 1 rms with the
// block's factors `scale`, 2 silu of the two halves), zero past the B
// rows. A thread takes chunks of VEC rows kk, one 16-byte load a batch
// row (and one of the up half), CU chunks of BG batch rows a round with
// every load issued before any is used: a Qwen3-8B tile's `a` at B 4 in
// one round (a load latency each round stalls the block while its ring
// stages sit landed); the VEC rows go to a_s as float4s of 4 batch rows.
template <typename S, int BP, int PRO>
__device__ __forceinline__ void stage_a(const S* x, int K, int k0, int kc,
                                        int B, int wmax, const float* scale,
                                        const float* nw, float* a_s) {
  constexpr int VEC = 16 / sizeof(S);
  constexpr int CU = BP <= 4 ? 2 : 1;
  constexpr int BG = BP <= 4 ? BP : 4;
  constexpr int NU = PRO == 2 ? 1 : 0;  // up-half loads a batch row
  const int nch = kc / VEC;
  for (int c0 = threadIdx.x; c0 < nch; c0 += CU * kThreads)
    for (int g = 0; g < BP; g += BG) {
      uint4 xv[CU][BG], uv[CU][BG * NU + 1];
      float4 wv[CU][VEC / 4];
#pragma unroll
      for (int u = 0; u < CU; ++u) {
        const int c = c0 + u * kThreads, k = k0 + c * VEC;
        const bool row = c < nch;
#pragma unroll
        for (int h = 0; h < VEC / 4; ++h)
          wv[u][h] = row && PRO == 1
                         ? *reinterpret_cast<const float4*>(nw + k + 4 * h)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int bb = 0; bb < BG; ++bb) {
          const bool live = row && g + bb < B;
          const S* xr = x + size_t(g + bb) * wmax + k;
          xv[u][bb] = live ? __ldcg(reinterpret_cast<const uint4*>(xr))
                           : make_uint4(0, 0, 0, 0);
          if (NU)
            uv[u][bb * NU] = live ? __ldcg(reinterpret_cast<const uint4*>(
                                        xr + K))
                                  : make_uint4(0, 0, 0, 0);
        }
      }
#pragma unroll
      for (int u = 0; u < CU; ++u) {
        const int c = c0 + u * kThreads;
        if (c >= nch) break;
        const float* we = reinterpret_cast<const float*>(wv[u]);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          float v[4];
#pragma unroll
          for (int bb = 0; bb < 4; ++bb) {
            v[bb] = 0.f;
            if (bb < BG) {
              v[bb] = f32(reinterpret_cast<const S*>(&xv[u][bb])[e]);
              if (PRO == 1)
                v[bb] = rnd(v[bb] * scale[g + bb] * we[e], S());
              else if (PRO == 2)
                v[bb] = rnd(v[bb] * sigmoid(v[bb]) *
                                f32(reinterpret_cast<const S*>(
                                    &uv[u][bb * NU])[e]),
                            S());
            }
          }
          *reinterpret_cast<float4*>(a_s + (c * VEC + e) * BP + g) =
              make_float4(v[0], v[1], v[2], v[3]);
        }
      }
    }
}

// One column tile [c0, c0 + TN) of y (B, N) = prologue(x) @ W (K, N)
// over the tile's rows of W, streamed through the ring (stage 0 from arena
// slot `fs` when >= 0). Thread (ks, cg) owns column group cg (VEC
// columns) and the tile rows g = ks (mod KS), each from the 16 bytes of
// its stage in shared memory; the KS partial sums of a column are added
// in ks order in shared memory and rounded once.
template <typename S, int BP>
__device__ void matmul_tile(const Params& p, int row, const MmTile<S>& t,
                            int tile, int fs, int from, int me, float* sm,
                            const unsigned char* ring_p,
                            const unsigned char* arena_p, uint32_t ring,
                            uint32_t bars, uint32_t& phase, Stream& st) {
  const int* q = p.queue + row * kRow;
  constexpr int VEC = 16 / sizeof(S);
  constexpr int KC = a_rows<BP>();
  const int src = q[2], dst = q[3], nrow = q[4];
  const int K = q[9], pro = q[11];
  const float eps = __int_as_float(q[14]);
  const int split = q[15], col = tile / split, ks0 = tile % split;
  const int TN = t.TN, KR = t.KR, SR = t.SR, TB = t.TB;
  const int B = p.batch, wmax = p.wmax;
  const S* x = slot<S>(p, me, src);
  S* y = slot<S>(p, me, dst);
  const int c0 = t.c0;
  const int CG = TN / VEC, KS = kThreads / CG;
  const int cg = threadIdx.x % CG, ks = threadIdx.x / CG;
  float* a_s = sm;              // [KC][BP]
  float* scale = sm + KC * BP;  // [BP]
  float* red = scale + BP;      // [kWarps][BP]
  const float* nw = p.norms + size_t(nrow) * p.norm_w;
  const int f = fs >= 0;              // stages taken from the arena
  const int spp = max(1, KC / SR);      // stages a pass of `a`
  // this thread's 16 bytes of a stage row: its box, then its column
  const int cofs = (cg * VEC) / TB * SR * TB + (cg * VEC) % TB;

  if (pro == 1) {  // rms factors of the B rows, over all of K
    float ss[BP];
#pragma unroll
    for (int b = 0; b < BP; ++b) ss[b] = 0.f;
    constexpr int PU = BP <= 4 ? 2 : 1;  // K vectors loaded at once
    for (int k0 = threadIdx.x * VEC; k0 < K; k0 += PU * kThreads * VEC) {
      uint4 xv[PU][BP];  // every load of the round before any use
#pragma unroll
      for (int u = 0; u < PU; ++u)
#pragma unroll
        for (int b = 0; b < BP; ++b) {
          const int k = k0 + u * kThreads * VEC;
          xv[u][b] = k < K && b < B ? __ldcg(reinterpret_cast<const uint4*>(
                                          x + size_t(b) * wmax + k))
                                    : make_uint4(0, 0, 0, 0);
        }
#pragma unroll
      for (int u = 0; u < PU; ++u)
#pragma unroll
        for (int b = 0; b < BP; ++b) {
          const S* e = reinterpret_cast<const S*>(&xv[u][b]);
#pragma unroll
          for (int j = 0; j < VEC; ++j) ss[b] = fmaf(f32(e[j]), f32(e[j]), ss[b]);
        }
    }
#pragma unroll
    for (int b = 0; b < BP; ++b) {
      const float s = warp_sum(ss[b]);
      if (threadIdx.x % 32 == 0) red[(threadIdx.x / 32) * BP + b] = s;
    }
    __syncthreads();
    if (threadIdx.x < BP) {
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += red[w * BP + threadIdx.x];
      scale[threadIdx.x] = rsqrtf(s / float(K) + eps);
    }
  }

  float acc[BP][VEC];
#pragma unroll
  for (int b = 0; b < BP; ++b)
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[b][j] = 0.f;

  int pass0 = 0;  // the tile row of a_s row 0
  for (int j = 0; j < t.n_st; ++j) {
    const int r0 = j * SR, rows = min(SR, KR - r0);
    if (j % spp == 0) {  // stage a pass of `a`: tile rows [r0, r0 + kc)
      const int kc = min(spp * SR, KR - r0), k0 = t.kb + r0;
      pass0 = r0;
      __syncthreads();  // the last pass's readers of a_s are done
      if (pro == 1) stage_a<S, BP, 1>(x, K, k0, kc, B, wmax, scale, nw, a_s);
      else if (pro == 2) stage_a<S, BP, 2>(x, K, k0, kc, B, wmax, scale, nw, a_s);
      else stage_a<S, BP, 0>(x, K, k0, kc, B, wmax, scale, nw, a_s);
      __syncthreads();
    }
    // the stage: arena slot fs, or the stream's next ring slot
    const unsigned char* buf;
    if (j < f) {
      const int bi = kRingStages + fs;
      hopper::mbar_wait_quiet(bars + 8 * bi, (phase >> bi) & 1u);
      phase ^= 1u << bi;
      buf = arena_p + fs * kStageBytes;
    } else {
      const int rs = st.consumed % kRingStages;
      hopper::mbar_wait_quiet(bars + 8 * rs, (st.consumed / kRingStages) & 1u);
      buf = ring_p + rs * kStageBytes;
    }
    if (ks < KS) {
      const S* wp = reinterpret_cast<const S*>(buf) + cofs;
      const float* ap = a_s + (r0 - pass0) * BP;
      int r = (ks - r0 % KS + KS) % KS;  // the first r with r0 + r = ks
      for (; r + 3 * KS < rows; r += 4 * KS) {
        uint4 v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          v[u] = *reinterpret_cast<const uint4*>(wp + (r + u * KS) * TB);
#pragma unroll
        for (int u = 0; u < 4; ++u)
          fma_row<S, BP, VEC>(acc, v[u], ap + (r + u * KS) * BP);
      }
      for (; r < rows; r += KS)
        fma_row<S, BP, VEC>(acc, *reinterpret_cast<const uint4*>(wp + r * TB),
                            ap + r * BP);
    }
    __syncthreads();  // every thread is done with the stage
    if (j >= f) {  // its ring slot takes the stream's next stage
      ++st.consumed;
      from = top_up<S>(p, st, t, from, me, ring, bars);
      if (from == t.n_st) look_ahead<S>(p, st, row, tile, me, ring, bars);
    }
  }

  // the KS partial sums of each column, in ks order, rounded once; four
  // rows at a time (4 * KS * TN <= 4 * kThreads * VEC floats). A split
  // matmul writes them in f32 to its partials [col][ks0][b][c] instead
  float* part = sm;
  float* mine = p.partial + me * p.partial_stride + q[16] +
                size_t(col * split + ks0) * B * TN;
#pragma unroll
  for (int b0 = 0; b0 < BP; b0 += 4) {
    if (b0 >= B) break;
    __syncthreads();
    if (ks < KS)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb)
#pragma unroll
        for (int j = 0; j < VEC; j += 4)
          *reinterpret_cast<float4*>(part + (bb * KS + ks) * TN + cg * VEC +
                                     j) =
              make_float4(acc[b0 + bb][j], acc[b0 + bb][j + 1],
                          acc[b0 + bb][j + 2], acc[b0 + bb][j + 3]);
    __syncthreads();
    const int nb = min(4, B - b0);
    for (int o = threadIdx.x; o < nb * TN; o += kThreads) {
      const int bb = o / TN, c = o - bb * TN;
      const float* pp = part + bb * KS * TN + c;
      float s = 0.f;
      for (int k = 0; k < KS; ++k) s += pp[k * TN];
      if (split == 1)
        store(y + size_t(b0 + bb) * wmax + c0 + c, s);
      else
        mine[(b0 + bb) * TN + c] = s;
    }
  }
  if (split > 1) split_combine<S>(p, q, col, split, B, TN, c0, me, y);
}

// rms_norm of batch row b over W columns
template <typename S>
__device__ void rms_norm_tile(const Params& p, const int* q, int b, int me,
                              float* sm) {
  const int nrow = q[1], W = q[9];
  const float eps = __int_as_float(q[14]);
  const S* x = slot<S>(p, me, q[2]) + size_t(b) * p.wmax;
  S* y = slot<S>(p, me, q[3]) + size_t(b) * p.wmax;
  const float* nw = p.norms + size_t(nrow) * p.norm_w;
  float ss = 0.f;
  for (int k = threadIdx.x; k < W; k += kThreads) {
    const float v = ldws(x + k);
    ss = fmaf(v, v, ss);
  }
  const float r = rsqrtf(block_sum(ss, sm) / float(W) + eps);
  for (int k = threadIdx.x; k < W; k += kThreads)
    store(y + k, ldws(x + k) * r * nw[k]);
}

// silu_mul (op kSiluMul) or add (kAdd) over columns [c0, c0 + TE)
template <typename S>
__device__ void elementwise_tile(const Params& p, const int* q, int tile,
                                 int me) {
  const int TE = q[8], W = q[9], c0 = tile * TE, B = p.batch;
  const size_t wm = p.wmax;
  for (int i = threadIdx.x; i < B * TE; i += kThreads) {
    const int b = i / TE, c = c0 + i % TE;
    if (q[0] == kSiluMul) {
      const S* x = slot<S>(p, me, q[1]) + b * wm;
      const float g = ldws(x + c), u = ldws(x + W + c);
      store(slot<S>(p, me, q[2]) + b * wm + c, g * sigmoid(g) * u);
    } else {
      store(slot<S>(p, me, q[3]) + b * wm + c,
            ldws(slot<S>(p, me, q[1]) + b * wm + c) +
                ldws(slot<S>(p, me, q[2]) + b * wm + c));
    }
  }
}

// dst = sum over ranks of partial + residual, columns [c0, c0 + TE)
template <typename S>
__device__ void allreduce_add_tile(const Params& p, const int* q, int tile,
                                   int me) {
  const int n = gridDim.y, TE = q[8], c0 = tile * TE, B = p.batch;
  const int mb = q[12], flag = q[13] + tile;
  const size_t wm = p.wmax;
  const S* part = slot<S>(p, me, q[1]);
  const S* res = slot<S>(p, me, q[2]);
  S* y = slot<S>(p, me, q[3]);
  S* box = static_cast<S*>(p.mbox);
  if (n > 1) {
    for (int peer = 0; peer < n; ++peer) {
      S* to = box + peer * p.mb_rank + mb * p.mb_task + me * p.mb_src;
      for (int i = threadIdx.x; i < B * TE; i += kThreads) {
        const int b = i / TE, c = c0 + i % TE;
        to[b * p.mb_w + c] = __ldcg(part + b * wm + c);
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      for (int peer = 0; peer < n; ++peer)
        shmem::atom_add_release(p.flags + size_t(peer) * p.flag_stride + flag,
                                1);
    }
    shmem::signal_wait_until(p.flags + size_t(me) * p.flag_stride + flag,
                             shmem::kEq, n, "mega", me, flag);
  }
  const S* mine = box + me * p.mb_rank + mb * p.mb_task;
  for (int i = threadIdx.x; i < B * TE; i += kThreads) {
    const int b = i / TE, c = c0 + i % TE;
    float acc;
    if (n > 1) {
      acc = ldws(mine + b * p.mb_w + c);
      for (int r = 1; r < n; ++r) acc += ldws(mine + r * p.mb_src + b * p.mb_w + c);
    } else {
      acc = ldws(part + b * wm + c);
    }
    store(y + b * wm + c, acc + ldws(res + b * wm + c));
  }
}

// decode attention of (batch row b, kv head h) = (tile / hkv_l, tile % hkv_l)
// over D = 32 * DL. The cached prefix is folded in passes of kChunk
// positions into an online softmax seeded with the new token: the logits
// with a thread a (position, head), 16-byte loads along a K row; the
// running max, the weights and the denominator with a warp a head; P.V
// with a warp a share of the positions and a lane DL elements of D,
// summed over the warps in order.
template <typename S, int DL>
__device__ void attention_tile(const Params& p, const int* q, int tile,
                               int me, float* sm) {
  constexpr int VEC = 16 / sizeof(S);
  constexpr int D = 32 * DL;
  const int layer = q[1];
  const int hq_l = q[8], hkv_l = q[9], qkn = q[11];
  const float eps = __int_as_float(q[14]);
  const int b = tile / hkv_l, h = tile % hkv_l;
  const int g = hq_l / hkv_l, half = D / 2, hqd = hq_l * D, kw = hkv_l * D;
  const int wid = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t wm = p.wmax;
  float* qs = sm;                // [g][D], then k_new [D], v_new [D]
  float* kn = qs + g * D;
  float* vn = kn + D;
  float* lg = vn + D;            // [g][kChunk]
  float* m_s = lg + g * kChunk;  // running max, denominator, rescale [g]
  float* den_s = m_s + g;
  float* al_s = den_s + g;
  float* part = al_s + g;        // [kWarps][g * D]

  const S* xr = slot<S>(p, me, q[2]) + b * wm;
  for (int i = threadIdx.x; i < (g + 2) * D; i += kThreads) {
    const int v = i / D, d = i % D;
    const int col = v < g ? (h * g + v) * D + d
                          : (v == g ? hqd : hqd + kw) + h * D + d;
    qs[i] = ldws(xr + col);
  }
  __syncthreads();
  if (qkn) {  // rms-norm each q head and k over D
    const float* wq = p.norms + size_t(q[12] + layer) * p.norm_w;
    const float* wk = p.norms + size_t(q[13] + layer) * p.norm_w;
    for (int v = wid; v <= g; v += kWarps) {
      float* x = qs + v * D;
      float ss = 0.f;
      for (int d = lane; d < D; d += 32) ss = fmaf(x[d], x[d], ss);
      const float r = rsqrtf(warp_sum(ss) / float(D) + eps);
      const float* w = v < g ? wq : wk;
      for (int d = lane; d < D; d += 32) x[d] = x[d] * r * w[d];
    }
    __syncthreads();
  }
  const int T = p.pos[b];  // cached positions 0..T-1; the new token at T
  const float* cs = p.rope + size_t(T) * D;
  for (int i = threadIdx.x; i < (g + 1) * half; i += kThreads) {
    float* x = qs + (i / half) * D;
    const int j = i % half;
    const float c = cs[j], s = cs[half + j], x1 = x[j], x2 = x[j + half];
    x[j] = x1 * c - x2 * s;
    x[j + half] = x2 * c + x1 * s;
  }
  __syncthreads();
  S* kno = slot<S>(p, me, q[4]) + b * wm + h * D;
  S* vno = slot<S>(p, me, q[5]) + b * wm + h * D;
  for (int d = threadIdx.x; d < D; d += kThreads) {
    store(kno + d, kn[d]);
    store(vno + d, vn[d]);
  }
  const float scale = 1.f / sqrtf(float(D));
  for (int i = threadIdx.x; i < g * D; i += kThreads) qs[i] *= scale;
  __syncthreads();
  // the online softmax starts from the new token: logit q.k_new, weight 1
  for (int i = wid; i < g; i += kWarps) {
    float s = 0.f;
    for (int d = lane; d < D; d += 32) s = fmaf(qs[i * D + d], kn[d], s);
    s = warp_sum(s);
    if (lane == 0) {
      m_s[i] = s;
      den_s[i] = 1.f;
    }
  }
  float acc[kAccPer];
#pragma unroll
  for (int j = 0; j < kAccPer; ++j) {
    const int o = threadIdx.x + j * kThreads;
    acc[j] = o < g * D ? vn[o % D] : 0.f;
  }
  __syncthreads();

  const size_t head = size_t(layer) * p.hkv_tot + me * hkv_l + h;
  const S* kbase = static_cast<const S*>(p.kpool) + head * p.n_pages * p.page * D;
  const S* vbase = static_cast<const S*>(p.vpool) + head * p.n_pages * p.page * D;
  const int* tbl = p.table + size_t(b) * p.maxp;
  for (int t0 = 0; t0 < T; t0 += kChunk) {
    const int tc = min(kChunk, T - t0);
    for (int i = threadIdx.x; i < g * tc; i += kThreads) {  // logits
      const int hd = i / tc, t = i - hd * tc, tp = t0 + t;
      const S* kr = kbase + (size_t(tbl[tp / p.page]) * p.page + tp % p.page) * D;
      const float* qh = qs + hd * D;
      float s = 0.f;
#pragma unroll
      for (int d0 = 0; d0 < D; d0 += VEC) {
        const uint4 w = __ldg(reinterpret_cast<const uint4*>(kr + d0));
        const S* e = reinterpret_cast<const S*>(&w);
#pragma unroll
        for (int j = 0; j < VEC; ++j) s = fmaf(qh[d0 + j], f32(e[j]), s);
      }
      lg[hd * kChunk + t] = s;
    }
    __syncthreads();
    for (int i = wid; i < g; i += kWarps) {  // max, weights, denominator
      float mx = m_s[i];
      for (int t = lane; t < tc; t += 32) mx = fmaxf(mx, lg[i * kChunk + t]);
      mx = warp_max(mx);
      float sum = 0.f;
      for (int t = lane; t < tc; t += 32) {
        const float e = expf(lg[i * kChunk + t] - mx);
        lg[i * kChunk + t] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float al = expf(m_s[i] - mx);
        al_s[i] = al;
        den_s[i] = den_s[i] * al + sum;
        m_s[i] = mx;
      }
    }
    __syncthreads();
    // P.V: warp wid takes positions wid, wid + kWarps, ...; lane owns
    // d in [lane * DL, lane * DL + DL) of every head (g * DL <= kAccPer *
    // kThreads / 32 values)
    float pacc[kMaxPV];
#pragma unroll
    for (int k = 0; k < kMaxPV; ++k) pacc[k] = 0.f;
    for (int t = wid; t < tc; t += kPVRows * kWarps) {
      float vf[kPVRows][DL];  // kPVRows positions' loads in flight
#pragma unroll
      for (int u = 0; u < kPVRows; ++u) {
        const int tp = t0 + min(t + u * kWarps, tc - 1);
        const S* vr = vbase +
                      (size_t(tbl[tp / p.page]) * p.page + tp % p.page) * D +
                      lane * DL;
#pragma unroll
        for (int j = 0; j < DL; ++j) vf[u][j] = f32(__ldg(vr + j));
      }
#pragma unroll
      for (int u = 0; u < kPVRows; ++u)
        if (t + u * kWarps < tc)
#pragma unroll
          for (int i = 0; i < kMaxPV / DL; ++i)
            if (i < g) {
              const float pw = lg[i * kChunk + t + u * kWarps];
#pragma unroll
              for (int j = 0; j < DL; ++j)
                pacc[i * DL + j] = fmaf(pw, vf[u][j], pacc[i * DL + j]);
            }
    }
#pragma unroll
    for (int i = 0; i < kMaxPV / DL; ++i)
      if (i < g)
#pragma unroll
        for (int j = 0; j < DL; ++j)
          part[wid * g * D + i * D + lane * DL + j] = pacc[i * DL + j];
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kAccPer; ++j) {  // acc = acc * alpha + P.V
      const int o = threadIdx.x + j * kThreads;
      if (o < g * D) {
        float s = 0.f;
        for (int w = 0; w < kWarps; ++w) s += part[w * g * D + o];
        acc[j] = acc[j] * al_s[o / D] + s;
      }
    }
    __syncthreads();
  }
  S* out = slot<S>(p, me, q[3]) + b * wm + h * g * D;
#pragma unroll
  for (int j = 0; j < kAccPer; ++j) {
    const int o = threadIdx.x + j * kThreads;
    if (o < g * D) store(out + o, acc[j] / den_s[o / D]);
  }
}

template <typename S, int BP>
__global__ void __launch_bounds__(kThreads, 1)
    mega_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* sm = reinterpret_cast<float*>(smem);  // the branches' scratch
  const int me = blockIdx.y;
  int* counters = p.flags + size_t(me) * p.flag_stride;
  const uint32_t s0 = hopper::smem_addr(smem);
  const uint32_t ring = (s0 + kScratchBytes + 127) & ~127u;
  const uint32_t arena = ring + kRingStages * kStageBytes;
  const uint32_t bars = arena + p.depth * kStageBytes;  // ring's, arena's
  const unsigned char* ring_p = smem + (ring - s0);
  const unsigned char* arena_p = smem + (arena - s0);
  if (threadIdx.x == 0) {
    for (int i = 0; i < kRingStages + p.depth; ++i)
      hopper::mbar_init(bars + 8 * i, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();
  uint32_t phase = 0;  // bit kRingStages + s: arena slot s's next parity
  Stream st = {0u, 0u, -1, -1, 0};
  for (int row = 0; row < p.n_rows; ++row) {
    const int* q = p.queue + row * kRow;
    const int op = q[0], nt = q[7];
    const int code = q[kIssueCode], cons = q[kConsume];
    // a row that reads the slot it fills issues after its own read
    const bool late = code && cons && q[kIssueSlot] == cons - 1;
    if (code && !late) issue_hint<S>(p, q, me, arena, bars);
    // the ring is idle through a row of another branch: the next row's
    // tile starts streaming
    if (op != kMatmul) look_ahead<S>(p, st, row, 0, me, ring, bars);
    for (int tile = blockIdx.x; tile < nt; tile += gridDim.x) {
      MmTile<S> t;
      int fs = -1, from = 0;  // the arena slot of stage 0; its next stage
      if (op == kMatmul) {
        t = row_tile<S>(p, q, tile, me);
        from = arena_stages(q, tile);
        fs = from ? cons - 1 : -1;
        if (st.la_row == row && st.la_tile == tile) from += st.la_n;
        st.la_row = -1;
        from = top_up<S>(p, st, t, from, me, ring, bars);
      }
      if (threadIdx.x == 0)
        for (int i = 0; i < q[17]; ++i) {
          const int pr = q[18 + i];
          shmem::spin_until(counters + pr, shmem::kEq, p.queue[pr * kRow + 7],
                            "mega", me, pr);
        }
      __syncthreads();
      switch (op) {
        case kMatmul:
          matmul_tile<S, BP>(p, row, t, tile, fs, from, me, sm, ring_p,
                             arena_p, ring, bars, phase, st);
          break;
        case kRmsNorm:
          rms_norm_tile<S>(p, q, tile, me, sm);
          break;
        case kSiluMul:
        case kAdd:
          elementwise_tile<S>(p, q, tile, me);
          break;
        case kAllReduceAdd:
          allreduce_add_tile<S>(p, q, tile, me);
          break;
        case kAttention:  // D = 32 * DL
          if (q[10] == 32) attention_tile<S, 1>(p, q, tile, me, sm);
          else if (q[10] == 64) attention_tile<S, 2>(p, q, tile, me, sm);
          else if (q[10] == 128) attention_tile<S, 4>(p, q, tile, me, sm);
          else attention_tile<S, 8>(p, q, tile, me, sm);
          break;
        case kBarrier:
          shmem::barrier_all(p.flags, p.flag_stride, p.barrier_flag, me,
                             gridDim.y, "mega");
          break;
        default:
          break;
      }
      shmem::signal_add(counters + row, 1);
    }
    if (code && late) issue_hint<S>(p, q, me, arena, bars);
  }
}

template <typename S, int BP>
cudaError_t launch(const Params& prm, int n, int bpr, int* info,
                   cudaStream_t st) {
  void (*kern)(Params) = mega_kernel<S, BP>;
  const size_t smem = smem_bytes(prm.depth);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                      smem);
  if (e != cudaSuccess) return e;
  info[0] = per_sm;
  info[1] = sms;
  info[2] = per_sm * sms / n;
  // the tiles were cut for bpr blocks a rank, and the barrier counts them
  if (info[2] < bpr) return cudaErrorCooperativeLaunchTooLarge;
  return shmem::launch_world(kern, n, bpr, kThreads, smem, st, info, prm);
}

// each row-major weight as a 3-D tensor map (planes L * n,
// K, N) of (stage rows, box cols, 1) boxes, zero fill past K
template <typename S>
bool encode_maps(Params& p, int nw, const long long* planes) {
  for (int i = 0; i < nw; ++i) {
    if (p.w_tiled[i]) continue;
    const int tn = p.w_tn[i];
    if (tn <= 0) return false;  // its matmuls tile it in more than one way
    const uint64_t isz = sizeof(S);
    const uint64_t dims[3] = {uint64_t(p.w_n[i]), uint64_t(p.w_k[i]),
                              uint64_t(planes[i])};
    const uint64_t strides[2] = {p.w_n[i] * isz,
                                 uint64_t(p.w_k[i]) * p.w_n[i] * isz};
    const uint32_t box[3] = {uint32_t(box_cols(tn)),
                             uint32_t(stage_rows(tn, int(isz))), 1};
    if (!hopper::encode_map(&p.maps[i],
                            isz == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                            CU_TENSOR_MAP_SWIZZLE_NONE, p.w[i], 3, dims,
                            strides, box, CU_TENSOR_MAP_L2_PROMOTION_L2_256B))
      return false;
  }
  return true;
}

}  // namespace

extern "C" int mega_arg_count() { return A_COUNT; }

// a: the A_COUNT int64 arguments (kernels/mega.py _ARGS); n ranks of bpr
// blocks; dtype 0 = float32, 1 = bfloat16; info: 3 ints (launch_world).
// Returns a cudaError_t (0 = launched).
extern "C" int mega_launch(const long long* a, int n, int bpr, int dtype,
                           void* info, void* stream) {
  Params p = {};
  p.queue = reinterpret_cast<const int*>(a[A_QUEUE]);
  p.n_rows = int(a[A_NROWS]);
  p.pos = reinterpret_cast<const int*>(a[A_POS]);
  p.table = reinterpret_cast<const int*>(a[A_TABLE]);
  p.maxp = int(a[A_MAXP]);
  p.ws = reinterpret_cast<void*>(a[A_WS]);
  p.ws_rank = a[A_WS_RANK];
  p.ws_slot = a[A_WS_SLOT];
  p.wmax = int(a[A_WMAX]);
  p.batch = int(a[A_BATCH]);
  p.norms = reinterpret_cast<const float*>(a[A_NORMS]);
  p.norm_w = int(a[A_NORM_W]);
  p.rope = reinterpret_cast<const float*>(a[A_ROPE]);
  p.kpool = reinterpret_cast<const void*>(a[A_KPOOL]);
  p.vpool = reinterpret_cast<const void*>(a[A_VPOOL]);
  p.hkv_tot = int(a[A_HKV_TOT]);
  p.n_pages = int(a[A_NPAGES]);
  p.page = int(a[A_PAGE]);
  p.mbox = reinterpret_cast<void*>(a[A_MBOX]);
  p.mb_rank = a[A_MB_RANK];
  p.mb_task = a[A_MB_TASK];
  p.mb_src = a[A_MB_SRC];
  p.mb_w = int(a[A_MB_W]);
  p.flags = reinterpret_cast<int*>(a[A_FLAGS]);
  p.flag_stride = int(a[A_FLAG_STRIDE]);
  p.barrier_flag = int(a[A_BARRIER_FLAG]);
  p.partial = reinterpret_cast<float*>(a[A_PARTIAL]);
  p.partial_stride = a[A_PARTIAL_STRIDE];
  const int nw = int(a[A_NW]);
  p.depth = int(a[A_DEPTH]);
  p.n_spec = int(a[A_NSPEC]);
  long long planes[kMaxW];
  for (int i = 0; i < kMaxW; ++i) {
    p.w[i] = i < nw ? reinterpret_cast<const void*>(a[A_W0 + i]) : nullptr;
    p.w_layer[i] = a[A_WLAYER0 + i];
    p.w_rank[i] = a[A_WRANK0 + i];
    p.w_tiled[i] = int(a[A_WTILED0 + i]);
    p.w_k[i] = int(a[A_WK0 + i]);
    p.w_n[i] = int(a[A_WN0 + i]);
    p.w_tn[i] = int(a[A_WTN0 + i]);
    p.w_split[i] = int(a[A_WSPLIT0 + i]);
    planes[i] = a[A_WPLANES0 + i];
    p.pf_w[i] = int(a[A_PFW0 + i]);
  }
  if (n < 1 || bpr < 1 || p.batch < 1 || p.batch > 16 || nw > kMaxW ||
      p.depth < 1 || p.depth > kMaxDepth ||
      p.n_spec < 0 || p.n_spec > kMaxW)
    return int(cudaErrorInvalidValue);
  for (int c = 0; c < p.n_spec; ++c) {  // a prefetched weight's one tiling
    const int i = p.pf_w[c];
    if (i < 0 || i >= nw || p.w_tn[i] <= 0 || p.w_split[i] <= 0)
      return int(cudaErrorInvalidValue);
  }
  if (!(dtype == 1 ? encode_maps<unsigned short>(p, nw, planes)
                   : encode_maps<float>(p, nw, planes)))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* inf = static_cast<int*>(info);
  const bool small = p.batch <= 4;
  if (dtype == 0)
    return int(small ? launch<float, 4>(p, n, bpr, inf, st)
                     : launch<float, 16>(p, n, bpr, inf, st));
  if (dtype == 1)
    return int(small ? launch<unsigned short, 4>(p, n, bpr, inf, st)
                     : launch<unsigned short, 16>(p, n, bpr, inf, st));
  return int(cudaErrorInvalidValue);
}

extern "C" const char* mega_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
