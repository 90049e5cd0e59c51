// Ring and full-mesh AllGather over the virtual world of one card,
// sm_90a.
//
// ring_ag_kernel replaces the Pallas TPU kernel `_ring_ag_kernel` reached
// through `ring_all_gather` in triton_dist_tpu/kernels/allgather.py. Same
// ring:
// each rank publishes its chunk into its own output slot, and at step s
// puts chunk (me - s) mod n into the same slot of its right neighbour's
// output. A rank forwards a chunk only after the step that brought it
// has signalled, and each step has its own flag: the JAX docstring's
// reason (an arrival of step s+k must not satisfy the wait of step s)
// holds for flags as for DMA semaphores.
//
// Input x (n, chunk) rank-stacked, output (n, n, chunk): out[r][c] is
// rank r's copy of rank c's chunk. Data movement only, so the result is
// bitwise the input. Chunks are cut into tiles of 16 KiB, each step of
// each tile with its own flag (flags (n, (n-2) * n_tiles): below), so a
// tile travels the ring as soon as it arrives. All n ranks run in one
// cooperative launch; block j of every rank walks the same tiles in the
// same order, and a wait at step s only ever depends on step s-1 of the
// same tile, so the waits form chains that end at step 0, which waits
// on nothing.
//
// The data path. A thread owns the same U words of a tile at every step
// (16-byte words when the chunk allows, else 4- or 2-byte ones; U x 256
// words a tile), so it issues all U loads of a step before its stores:
// its own chunk is loaded once and stored into its own slot and the
// right's; a delivered chunk is loaded after the arrival wait with
// __ldcg. A hop publishes with a release add after the block barrier
// and no __threadfence (cumulative release: reduce_scatter.cu's
// ring_signal); the waits, for exactly one arrival, poll with a 64 ns
// backoff cap.
//
// Flags that each rank leaves at zero. The wrapper keeps the flag pool
// across calls (allgather._POOLS, zeroed once when made). A flag of rank
// me, (step s, tile t) for s < n - 2, gets one add from the left
// neighbour a launch and one wait by me, for exactly that one arrival,
// and the thread that waited stores 0 to it: the next launch on the
// stream, which starts after this one ends, finds every flag at zero.
// The last step (n - 2) forwards nothing onwards, so its arrival is not
// signalled at all: the launch ends only when its stores have landed.
// So a rank holds (n - 2) x n_tiles flags. A trap leaves them set (the
// context is lost anyway), and a flag left set never reads 1 again: its
// wait traps.
//
// What bounds it on an H100: bytes, n chunks read and n * n written for
// the whole world. The ring reads each forwarded chunk once more, from
// the rank that received it; the n - 1 hops of a tile are serial (a flag
// round trip each).
//
// fm_ag_kernel replaces `_full_mesh_ag_kernel` (allgather.py:116, reached
// through `full_mesh_all_gather`): the JAX kernel's fcollect, one put a
// peer instead of n - 1 ring steps, the latency form for small shards.
// Block j of rank me owns the j-th 16-byte-aligned share of me's chunk.
// It reads its share of x once (ld.global.nc: nothing writes x during
// the launch) and stores it into slot me of every rank's output, its own
// included; then it publishes by the fence-once rule of shmem.cuh: one
// block barrier, thread 0's fence.acq_rel.gpu and a relaxed add of one
// to word (me, j) of every peer's pool. Then thread 0 waits until its
// own words (src, j) read exactly 1 for every peer src, polling with a
// 64 ns backoff cap, and clears each: block j of the destination is each
// word's one waiter.
//
// Persistent words. The pool (the wrapper's allgather._FM_POOLS, zeroed
// once when made) holds n x `words` int32 a rank, a word a (source,
// block); `words` is the largest grid a rank the wrapper launches. Each
// word gets one add and has one waiter, which resets it, so every launch
// finds the pool at zero and leaves it so, and a warm call makes no pool
// and no memset.
//
// No entry barrier. The JAX kernel barriers so that no put lands while a
// peer is still in an earlier kernel on these buffers. Here all n ranks
// run in one cooperative launch on one stream: the previous launch has
// ended on every rank, its words are back at zero, and every call writes
// an `out` it allocated itself, so nothing a peer still reads can be
// overwritten. `straggle_rank` stalls that rank's blocks for
// `straggle_ns` before their copies (shmem::straggler_delay), so the
// peers' waits really wait; the bytes are the same.
//
// The body: 256 threads, each with 8 16-byte loads in flight before its
// n stores (shmem::copy_nc_ends; bytes where the chunk or a pointer is
// not 16-byte aligned), so one body moves every chunk, ragged ones
// included. A bulk body (thread 0 streaming the share through 4
// shared-memory stages of 16 KiB, one cp.async.bulk load a tile and n
// bulk stores) was timed beside it at phase 4c's payloads and did not
// clearly win any of them (PERF.md, row 8b), so it went. Same output,
// same bytes moved as the ring minus the forwards' re-reads.

#include <cuda_runtime.h>
#include <stdint.h>

#include "shmem.cuh"

namespace {

constexpr int kThreads = 256;

constexpr int kTileBytes = 16384;  // a tile: kThreads threads x U words
constexpr unsigned kRingSleepNs = 64;

// a tile's U words of thread threadIdx.x, the first `cnt` of the tile
// in range: all loads first, then all stores
template <typename W, int U>
__device__ __forceinline__ void load_unit(W (&v)[U], const W* src,
                                          long long cnt, bool cg) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long i = threadIdx.x + (long long)u * kThreads;
    if (i < cnt) v[u] = cg ? __ldcg(src + i) : __ldg(src + i);
  }
}

template <typename W, int U>
__device__ __forceinline__ void store_unit(W* dst, const W (&v)[U],
                                           long long cnt) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long i = threadIdx.x + (long long)u * kThreads;
    if (i < cnt) dst[i] = v[u];
  }
}

// publish this block's stores on a peer's flag: the block barrier, then
// one thread's release add (cumulative over what the barrier ordered).
// An add, so a flag that a trapped launch left set never reads 1 again
// and its wait traps.
__device__ __forceinline__ void ring_signal(int* flag) {
  __syncthreads();
  if (threadIdx.x == 0) shmem::atom_add_release(flag, 1);
}

// wait for a flag's one arrival, then leave it at zero for the next
// launch (no peer adds to it again in this one)
__device__ __forceinline__ void ring_wait_reset(int* flag, int me, int index) {
  if (threadIdx.x == 0) {
    shmem::spin_until(flag, shmem::kEq, 1, "ring_all_gather", me, index,
                      kRingSleepNs);
    shmem::st_release(flag, 0);
  }
  __syncthreads();
}

template <typename W, int U>
__global__ void __launch_bounds__(kThreads)
ring_ag_kernel(const W* x, W* out, int* flags, long long words,
               int n_tiles) {
  constexpr long long kTile = (long long)kThreads * U;
  const int n = gridDim.y, me = blockIdx.y;
  const int right = (me + 1) % n;
  const int nf = (n - 2) * n_tiles;  // flags of a rank: [step][tile]
  int* mine = flags + size_t(me) * nf;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long lo = (long long)t * kTile;
    const long long cnt = min(kTile, words - lo);
    W v[U];
    // my chunk into my own slot and, step 0, into the right's
    load_unit(v, x + size_t(me) * words + lo, cnt, false);
    store_unit(out + (size_t(me) * n + me) * words + lo, v, cnt);
    store_unit(out + (size_t(right) * n + me) * words + lo, v, cnt);
    for (int s = 1; s < n - 1; ++s) {
      // step s - 1's stores to the right, then chunk c, which came from
      // the left at step s - 1: acquire its flag, then read it past L1
      // (__ldcg), the rule of shmem.cuh
      ring_signal(flags + size_t(right) * nf + (s - 1) * n_tiles + t);
      const int c = (me - s + n) % n;  // the chunk this step forwards
      ring_wait_reset(mine + (s - 1) * n_tiles + t, me, (s - 1) * n_tiles + t);
      load_unit(v, out + (size_t(me) * n + c) * words + lo, cnt, true);
      store_unit(out + (size_t(right) * n + c) * words + lo, v, cnt);
    }
    // the last step's stores (step n - 2) go unsignalled: nobody
    // forwards that chunk, and the launch's end covers them
  }
}

template <typename W>
cudaError_t launch(const void* x, void* out, int* flags, int n,
                   long long chunk_bytes, int* info, cudaStream_t st) {
  constexpr int U = kTileBytes / kThreads / int(sizeof(W));
  const long long words = chunk_bytes / sizeof(W);
  const int n_tiles = int((words + kThreads * U - 1) / (kThreads * U));
  return shmem::launch_world(ring_ag_kernel<W, U>, n, n_tiles, kThreads, 0,
                             st, info, static_cast<const W*>(x),
                             static_cast<W*>(out), flags, words, n_tiles);
}

constexpr int kFmUnits = 8;  // each thread's loads in flight

struct FM {
  const char* x;  // (n, chunk)
  char* out;      // (n, n, chunk)
  int* flags;     // (n, n, words): word (source, block) of each rank
  int words, straggle_rank;
  long long chunk, straggle_ns;
};

__global__ void __launch_bounds__(kThreads) fm_ag_kernel(FM a) {
  const int n = gridDim.y, me = blockIdx.y, j = blockIdx.x;
  shmem::straggler_delay(a.straggle_rank, me, a.straggle_ns);
  long long lo, hi;
  shmem::block_share(a.chunk, gridDim.x, j, &lo, &hi);
  const char* from = a.x + size_t(me) * a.chunk + lo;
  // end e: slot me of rank e's output
  auto end = [&](int e) {
    return a.out + (size_t(e) * n + me) * a.chunk + lo;
  };
  shmem::copy_nc_ends<kThreads, kFmUnits>(threadIdx.x, n, end, from, hi - lo);
  __syncthreads();
  if (threadIdx.x != 0) return;
  const size_t pool = size_t(n) * a.words;  // words a rank
  shmem::fence_acq_rel();
  for (int i = 1; i < n; ++i)
    shmem::red_add_relaxed(
        a.flags + size_t((me + i) % n) * pool + size_t(me) * a.words + j, 1);
  for (int i = 1; i < n; ++i) {
    const int src = (me - i + n) % n;
    const int index = src * a.words + j;
    int* word = a.flags + size_t(me) * pool + index;
    shmem::spin_until(word, shmem::kEq, 1, "full_mesh_all_gather", me, index,
                      shmem::kPollNs);
    shmem::st_relaxed(word, 0);
  }
}

}  // namespace

// x (n, chunk_bytes), out (n, n, chunk_bytes); flags (n, n * words) int32
// at zero, left at zero; blocks a rank, 1..words, capped by what the
// card holds (info receives the grid, shmem.cuh launch_world);
// straggle_rank < 0 for none. Any dtype and any byte count: whole
// 16-byte words where both ends allow, bytes else. Returns a cudaError_t
// (0 = launched).
extern "C" int fm_ag_launch(const void* x, void* out, void* flags, int words,
                            int n, long long chunk_bytes, int straggle_rank,
                            long long straggle_ns, int blocks, int* info,
                            void* stream) {
  if (n < 2 || chunk_bytes < 1 || blocks < 1 || blocks > words)
    return int(cudaErrorInvalidValue);
  const FM a{static_cast<const char*>(x), static_cast<char*>(out),
             static_cast<int*>(flags), words, straggle_rank, chunk_bytes,
             straggle_ns};
  return int(shmem::launch_world(fm_ag_kernel, n, blocks, kThreads, 0,
                                 static_cast<cudaStream_t>(stream), info, a));
}

// Tiles of a chunk; the launch needs (n - 2) * ag_tile_count flags a rank.
extern "C" int ag_tile_count(long long chunk_bytes) {
  return int((chunk_bytes + kTileBytes - 1) / kTileBytes);
}

// x (n, chunk_bytes), out (n, n, chunk_bytes); flags (n, (n - 2) *
// ag_tile_count) at zero, and left at zero by the launch. Any dtype: the
// kernel moves bytes (a chunk of an even number of bytes). Returns a
// cudaError_t (0 = launched).
extern "C" int ag_launch(const void* x, void* out, void* flags, int n,
                         long long chunk_bytes, void* info, void* stream) {
  if (n < 2 || chunk_bytes < 1 || chunk_bytes % 2)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* fl = static_cast<int*>(flags);
  int* inf = static_cast<int*>(info);
  if (chunk_bytes % 16 == 0)
    return int(launch<uint4>(x, out, fl, n, chunk_bytes, inf, st));
  if (chunk_bytes % 4 == 0)
    return int(launch<unsigned int>(x, out, fl, n, chunk_bytes, inf, st));
  return int(launch<unsigned short>(x, out, fl, n, chunk_bytes, inf, st));
}

extern "C" const char* ag_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
