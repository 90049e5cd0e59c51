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
// through `full_mesh_all_gather`): barrier_all, then the body of the JAX
// kernel, shmem::fcollect. Each block of rank me copies its 16-byte share
// of me's chunk into its own slot and into slot me of every peer, adding
// one to that peer's arrival flag of source me; then it waits until every
// peer's flag counts all of that peer's blocks. One put a peer instead of
// n - 1 ring steps: the latency form for small shards. Same output, same
// bytes moved as the ring minus the forwards' re-reads. Flags a rank:
// [0] the barrier, [1 + j] the arrivals from source j. `straggle_rank`
// stalls that rank's blocks for `straggle_ns` after the barrier
// (shmem::straggler_delay), so its peers' waits really wait.

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

__global__ void __launch_bounds__(kThreads)
fm_ag_kernel(const char* __restrict__ x, char* out, int* flags,
             long long chunk, int straggle_rank, long long straggle_ns) {
  const int n = gridDim.y, me = blockIdx.y;
  shmem::barrier_all(flags, 1 + n, 0, me, n, "full_mesh_all_gather");
  shmem::straggler_delay(straggle_rank, me, straggle_ns);
  shmem::fcollect(out, x + size_t(me) * chunk, chunk, flags, 1 + n, 1, me, n,
                  "full_mesh_all_gather");
}

}  // namespace

// Flag words a rank of the full-mesh launch: the barrier, one a source.
extern "C" int fm_ag_flag_words(int n) { return 1 + n; }

// x (n, chunk_bytes), out (n, n, chunk_bytes); flags (n,
// fm_ag_flag_words(n)) zeroed. Any dtype and any byte count: whole
// 16-byte words where both ends allow, bytes else. straggle_rank < 0
// for none; want_blocks caps the blocks a rank. Returns a cudaError_t
// (0 = launched).
extern "C" int fm_ag_launch(const void* x, void* out, void* flags, int n,
                            long long chunk_bytes, int straggle_rank,
                            long long straggle_ns, int want_blocks,
                            void* info, void* stream) {
  if (n < 2 || chunk_bytes < 1 || want_blocks < 1)
    return int(cudaErrorInvalidValue);
  return int(shmem::launch_world(
      fm_ag_kernel, n, want_blocks, kThreads, 0,
      static_cast<cudaStream_t>(stream), static_cast<int*>(info),
      static_cast<const char*>(x), static_cast<char*>(out),
      static_cast<int*>(flags), chunk_bytes, straggle_rank, straggle_ns));
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
