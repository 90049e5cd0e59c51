// The MoE all-to-all over the virtual world of one card, sm_90a: the
// single-shot exchange and its chunked form.
//
// Replaces the Pallas TPU kernels `_a2a_kernel` (reached through
// `all_to_all`, triton_dist_tpu/kernels/all_to_all.py:95) and
// `_a2a_chunked_kernel` (reached through `all_to_all_chunked`, :313).
// Same function, rank-stacked: x (n src, n dst, seg) holds at [r, i] the
// segment rank r sends to rank i, and rank r's result out[r] (n, seg)
// holds at [j] the segment rank j sent it: out[r, j] = x[j, r]. A splits
// row (seg_s int32, the segment's counts) travels beside every segment
// the same way. Data movement only, the bytes of whole static segments
// (the rows past a segment's count included), so the result is bitwise
// the plain version's whatever the dtype.
//
// a2a_kernel (row 12): block b of rank me copies its tiles of the n
// segments x[me, i] into slot me of each rank i's partition (own rank
// first, then the ring offsets), then publishes them all at once: one
// add to each destination's delivery flag of source me. Block 0 copies
// the n splits rows before that publication, so the same adds publish
// them: no flag, fence or wait of their own.
//
// a2a_chunked_kernel (row 13): the same bytes, each segment cut into q
// chunks of C / q rows, sent and published chunk by chunk. Chunk c from
// the source at ring offset i (me - i) lands on the destination's
// delivery flag [i, c]: the slot is indexed by the RING STEP, never by
// the absolute source rank, the invariant of the JAX kernel's docstring
// (:144-163) that its verifier's mutant pins. Sends and waits are
// chunk-major. `straggle_rank` stalls that rank's blocks for
// `straggle_ns` before their sends (shmem::straggler_delay), so the
// peers' waits really wait; the bytes are the same.
//
// Publication with one fence a chunk. A block's stores, the block
// barrier, then thread 0's fence.acq_rel.gpu and one relaxed add a
// destination: the barrier orders every thread's stores before thread
// 0's fence, and a fence followed by strong writes is a release pattern,
// cumulative over what the barrier ordered. A red.release.gpu is a fence
// of its own: n of them a chunk cost a fence each, serially in thread 0
// (~0.7 us an add on the 16-byte floor; tools/profile_a2a.py, PERF.md).
// So the single-shot kernel has one block barrier and one fence a block.
//
// Persistent flags, left at zero. The wrapper keeps the flag pool across
// calls (all_to_all._POOLS, zeroed once when made): n * q int32 words a
// rank, [source rank] for a2a_kernel (q = 1), [ring step i][chunk c]
// for a2a_chunked_kernel. A flag gets one add from every block of its
// source (gridDim.x of them) a launch, and exactly one block of its
// rank waits on it: flag k of the chunk-major order (chunk k / n, ring
// step k % n) belongs to block k % gridDim.x, which waits for exactly
// gridDim.x (==), polling with a 64 ns backoff cap, and then stores 0
// (relaxed: the next launch on the stream is ordered after this one).
// No add reaches it after that in this launch, so the next launch on the
// stream, which starts when this one has ended, finds every flag at
// zero. A flag has one waiter because a reset by one of several would
// starve the others; each waiting block keeps the chunk-major order
// among its own flags. Every wait is bounded and traps (shmem.cuh); a
// trap loses the context and the pools with it.
//
// No entry barrier. The JAX kernel's barrier_all keeps a DMA from
// landing in a peer chip that is still in its previous kernel. Here all
// n ranks run in one cooperative launch on one stream: the previous
// launch has ended on every rank before this one starts, its flags are
// back at zero, and every call writes an `out` it allocated itself, so
// nothing a peer still reads can be overwritten. (The ring AllGather
// dropped its neighbour barrier on the same argument.) One such barrier,
// a flag a block index, measured 0.6-0.8 us at the decode exchange
// (PERF.md, tools/profile_a2a.py).
//
// The data path. A rank's work is cut into tiles (`plan` below): each
// destination's chunk into `parts` tiles of at most `tile` words, the n
// * parts tiles of a chunk spread over the blocks (tile k to block k %
// gridDim.x, so a block's successive tiles go to different
// destinations). Register body (a2a_*_kernel<W, false>): thread t owns
// words t, t + 512, ... (U = 8) of a tile, issues all its loads, then
// its stores; 16-byte words where the chunk and both pointers allow it,
// else bytes (rows that are not a multiple of 16 bytes: the bf16 payload
// of width 3, a q that cuts a row). x is read with
// ld.global.nc.L1::no_allocate: nothing writes it during the launch. No
// barrier between tiles, so a thread's loads of its next tile issue
// right behind its stores of this one, and two resident blocks an SM
// overlap. Bulk body (<uint4, true>): one thread a block streams its
// tiles (16 KiB) through 4 shared-memory stages, cp.async.bulk global ->
// shared on an mbarrier, then shared -> global in a bulk group; before
// its publication it waits for every bulk group to complete and fences
// the async proxy. Both move the same bytes. The wrapper takes the bulk
// body from 1 MiB a rank's chunk (all_to_all._body_for): there it
// measured 3-8% faster at the dispatch in 2 or 4 chunks and within 1.5%
// otherwise; below, at the decode exchange, the register body is as
// fast, and up to 10% faster in the chunked kernel (tools/profile_a2a.py,
// PERF.md).
//
// What bounds it on an H100: bytes, and at a decode step latency. Every
// segment is read once and written once: the EP dispatch at
// Qwen3-30B-A3B widths, 4 ranks x 128 tokens x top-8 (C 1024 slots,
// 2176 bf16 columns), moves 71 MB each way, 42 us at 3.35 TB/s; the
// combine's f32 (4, 1024, 2048) a rank, 134 MB, 80 us. A decode step's
// exchange (C 8) is about 1 MB: one launch and one flag round trip.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "shmem.cuh"

namespace {

constexpr int kThreads = 512;  // register body
constexpr int kUnits = 8;      // words a thread has in flight a tile
constexpr int kBulkThreads = 128;  // bulk body: thread 0 streams

struct A2A {
  const void* x;
  void* out;
  const int* sp;  // splits (n, n, seg_s) int32
  int* osp;
  int* flags;  // (n, n * q)
  int seg_s, q, parts, straggle_rank;
  long long seg, chunk, tile, straggle_ns;  // seg, chunk, tile in words
};

// a destination's chunk of `chunk` words in the fewest tiles of at most
// the body's tile (the register body's threads x units, the bulk body's
// stage), equal but the last: {parts, tile}
struct Plan {
  int parts;
  long long tile;
};

Plan plan(long long chunk, bool bulk) {
  const long long cap =
      bulk ? hopper::kBulkStageBytes / 16 : (long long)kThreads * kUnits;
  const long long parts = (chunk + cap - 1) / cap;
  return {int(parts), (chunk + parts - 1) / parts};
}

// The fence-once publication (fence_acq_rel, red_add_relaxed,
// st_relaxed) is shmem.cuh's.
using shmem::fence_acq_rel;
using shmem::red_add_relaxed;
using shmem::st_relaxed;

// tile k of chunk c at rank me: its source, destination and words
template <typename W>
__device__ __forceinline__ long long tile_at(const A2A& a, int me, int n,
                                             int c, int k, const W** src,
                                             W** dst) {
  const int i = k / a.parts;
  const long long off = (long long)(k - i * a.parts) * a.tile;
  const int peer = (me + i) % n;
  const long long lo = c * a.chunk + off;
  *src = static_cast<const W*>(a.x) + (size_t(me) * n + peer) * a.seg + lo;
  *dst = static_cast<W*>(a.out) + (size_t(peer) * n + me) * a.seg + lo;
  return min(a.tile, a.chunk - off);
}

// the register body's copy of one tile (cnt <= kThreads * kUnits
// words): shmem.cuh's copy_pass, to one end
template <typename W>
__device__ __forceinline__ void copy_tile(W* dst, const W* src, int cnt) {
  shmem::copy_pass<kThreads, kUnits>(dst, static_cast<W*>(nullptr), src,
                                     cnt);
}

// The bulk body's chunk c: thread 0 streams this block's tiles through
// the stages (hopper.cuh bulk_stream), which ends with every store
// complete and the async proxy fenced, before the generic-proxy release
// that publishes them. `phase` keeps each stage's mbarrier parity across
// chunks.
__device__ __forceinline__ void bulk_chunk(const A2A& a, int me, int n, int c,
                                           uint32_t stages, uint32_t bars,
                                           uint32_t* phase) {
  const int G = gridDim.x, tiles = n * a.parts;
  const int mine = blockIdx.x < tiles ? (tiles - blockIdx.x + G - 1) / G : 0;
  hopper::bulk_stream(
      mine,
      [&](int j, const void** src, void** d0, void** d1) {
        const uint4* s;
        uint4* d;
        const long long cnt =
            tile_at(a, me, n, c, blockIdx.x + j * G, &s, &d);
        *src = s;
        *d0 = d;
        *d1 = nullptr;
        return uint32_t(cnt * 16);
      },
      stages, bars, phase);
}

// this block's stores of chunk c (and block 0's splits rows), ordered by
// the block barrier, published by thread 0's fence and relaxed adds: one
// to each destination's flag of this source (single-shot: [me];
// chunked: the ring step's [i, c])
template <bool kChunked>
__device__ __forceinline__ void publish(const A2A& a, int me, int n, int c) {
  __syncthreads();
  if (threadIdx.x == 0) {
    fence_acq_rel();
    for (int i = 0; i < n; ++i) {
      const int peer = (me + i) % n;
      red_add_relaxed(
          a.flags + size_t(peer) * n * a.q + (kChunked ? i * a.q + c : me),
          1);
    }
  }
}

template <typename W, bool kChunked, bool kBulk>
__device__ __forceinline__ void a2a_body(const A2A& a, const char* name) {
  const int n = gridDim.y, me = blockIdx.y, G = gridDim.x;
  const int nq = n * a.q;
  int* mine = a.flags + size_t(me) * nq;
  shmem::straggler_delay(a.straggle_rank, me, a.straggle_ns);
  if (blockIdx.x == 0)  // the splits rows, published with chunk 0
    for (int t = threadIdx.x; t < n * a.seg_s; t += blockDim.x) {
      const int i = t / a.seg_s, w = t - i * a.seg_s;
      const int peer = (me + i) % n;
      a.osp[(size_t(peer) * n + me) * a.seg_s + w] =
          __ldg(a.sp + (size_t(me) * n + peer) * a.seg_s + w);
    }
  uint32_t stages = 0, bars = 0, phase = 0;
  if constexpr (kBulk) {
    extern __shared__ __align__(128) unsigned char smem[];
    __shared__ __align__(8) uint64_t bar[hopper::kBulkStages];
    stages = hopper::smem_addr(smem);
    bars = hopper::smem_addr(bar);
    if (threadIdx.x == 0) {
      for (int s = 0; s < hopper::kBulkStages; ++s)
        hopper::mbar_init(bars + 8 * s, 1);
      hopper::mbar_init_fence();
    }
  }
  const int tiles = n * a.parts;  // tiles of a chunk
  for (int c = 0; c < a.q; ++c) {
    if constexpr (kBulk) {
      if (threadIdx.x == 0) bulk_chunk(a, me, n, c, stages, bars, &phase);
    } else {
      for (int k = blockIdx.x; k < tiles; k += G) {
        const W* src;
        W* dst;
        const int cnt = int(tile_at(a, me, n, c, k, &src, &dst));
        copy_tile(dst, src, cnt);
      }
    }
    publish<kChunked>(a, me, n, c);
  }
  // this block's share of the waits, chunk-major: flag k = (chunk k / n,
  // ring step k % n), each for exactly G arrivals, then reset
  if (threadIdx.x == 0)
    for (int k = blockIdx.x; k < nq; k += G) {
      const int c = k / n, i = k - c * n;
      const int slot = kChunked ? i * a.q + c : (me - i + n) % n;
      shmem::spin_until(mine + slot, shmem::kEq, G, name, me, slot,
                        shmem::kPollNs);
      st_relaxed(mine + slot, 0);
    }
}

// the register body at two blocks an SM (at most 64 registers a thread)
template <typename W, bool kBulk>
__global__ void __launch_bounds__(kBulk ? kBulkThreads : kThreads,
                                  kBulk ? 1 : 2)
a2a_kernel(A2A a) {
  a2a_body<W, false, kBulk>(a, "all_to_all");
}

template <typename W, bool kBulk>
__global__ void __launch_bounds__(kBulk ? kBulkThreads : kThreads,
                                  kBulk ? 1 : 2)
a2a_chunked_kernel(A2A a) {
  a2a_body<W, true, kBulk>(a, "all_to_all_chunked");
}

template <typename W, bool kBulk>
cudaError_t launch(bool chunked, const A2A& a, int n, int blocks, int* info,
                   cudaStream_t st) {
  const int threads = kBulk ? kBulkThreads : kThreads;
  const size_t smem =
      kBulk ? size_t(hopper::kBulkStages) * hopper::kBulkStageBytes : 0;
  return chunked ? shmem::launch_world(a2a_chunked_kernel<W, kBulk>, n,
                                       blocks, threads, smem, st, info, a)
                 : shmem::launch_world(a2a_kernel<W, kBulk>, n, blocks,
                                       threads, smem, st, info, a);
}

}  // namespace

// x (n, n, seg_words * word) bytes, out likewise; splits / out_splits (n,
// n, seg_s) int32; flags (n, n * q) int32 at zero, left at zero. word: 16
// (16-byte words; the chunk and both pointers 16-byte aligned) or 1
// (bytes; the register body only). chunked = 0: the single-shot kernel
// (q must be 1); chunked = 1: q chunks, straggle_rank < 0 for none.
// blocks: blocks a rank, 0 for a block a tile of a chunk (n * parts);
// either is capped by what the card holds, and info receives the grid
// (shmem.cuh launch_world). Returns a cudaError_t (0 = launched); n < 2
// returns before any CUDA call.
extern "C" int a2a_launch(const void* x, void* out, const void* splits,
                          void* out_splits, void* flags, int n,
                          long long seg_words, int seg_s, int q, int word,
                          int chunked, int bulk, int straggle_rank,
                          long long straggle_ns, int blocks, int* info,
                          void* stream) {
  if (n < 2 || q < 1 || seg_words < q || seg_words % q || seg_s < 1 ||
      (!chunked && q != 1) || blocks < 0)
    return int(cudaErrorInvalidValue);
  const bool vec = word == 16;
  if (!vec && (word != 1 || bulk)) return int(cudaErrorInvalidValue);
  if (vec && ((reinterpret_cast<uintptr_t>(x) |
               reinterpret_cast<uintptr_t>(out)) & 15))
    return int(cudaErrorMisalignedAddress);
  const long long chunk = seg_words / q;
  const Plan p = plan(chunk, bulk);
  A2A a{x,     out,         static_cast<const int*>(splits),
        static_cast<int*>(out_splits), static_cast<int*>(flags),
        seg_s, q,           p.parts,   straggle_rank,
        seg_words, chunk,   p.tile,    straggle_ns};
  if (blocks == 0) blocks = n * p.parts;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bulk) return int(launch<uint4, true>(chunked, a, n, blocks, info, st));
  return int(vec ? launch<uint4, false>(chunked, a, n, blocks, info, st)
                 : launch<unsigned char, false>(chunked, a, n, blocks, info,
                                                st));
}

extern "C" const char* a2a_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
