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
// bitwise the input; the kernel moves 16-byte words when the chunk
// allows, else 4- or 2-byte words. Chunks are cut into tiles, each step
// of each tile with its own flag (flags (n, (n-1) * n_tiles)), so a tile
// travels the ring as soon as it arrives. All n ranks run in one
// cooperative launch; block j of every rank walks the same tiles in the
// same order, and a wait at step s only ever depends on step s-1 of the
// same tile, so the waits form chains that end at step 0, which waits
// on nothing.
//
// What bounds it on an H100: bytes, n chunks read and n * n written for
// the whole world. The ring reads each forwarded chunk once more, from
// the rank that received it.
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

template <typename W>
__global__ void __launch_bounds__(kThreads)
ring_ag_kernel(const W* x, W* out, int* flags, long long words, int tile,
               int n_tiles) {
  const int n = gridDim.y, me = blockIdx.y;
  const int right = (me + 1) % n;
  const int nf = (n - 1) * n_tiles;  // flags of a rank: [step][tile]
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long lo = (long long)t * tile;
    const long long cnt = min((long long)tile, words - lo);
    // publish my chunk into my own slot
    shmem::putmem_block(out + (size_t(me) * n + me) * words + lo,
                        x + size_t(me) * words + lo, cnt);
    for (int s = 0; s < n - 1; ++s) {
      const int c = (me - s + n) % n;  // the chunk this step forwards
      // chunk c came from the left at step s - 1: acquire its flag, then
      // read it with __ldcg (putmem_block), the rule of shmem.cuh
      if (s > 0)
        shmem::signal_wait_until(flags + size_t(me) * nf + (s - 1) * n_tiles + t,
                                 shmem::kGe, 1, "ring_all_gather", me,
                                 (s - 1) * n_tiles + t);
      const W* src = s == 0 ? x + size_t(me) * words + lo
                            : out + (size_t(me) * n + c) * words + lo;
      shmem::putmem_block(out + (size_t(right) * n + c) * words + lo, src,
                          cnt);
      shmem::signal_set(flags + size_t(right) * nf + s * n_tiles + t, 1);
    }
    // the last arrival (chunk me + 1, step n - 2) needs no wait here:
    // the launch ends only when its writer has written it
  }
}

template <typename W>
cudaError_t launch(const void* x, void* out, int* flags, int n,
                   long long chunk_bytes, int tile_bytes, int* info,
                   cudaStream_t st) {
  const long long words = chunk_bytes / sizeof(W);
  const int tile = tile_bytes / int(sizeof(W));
  const int n_tiles = int((words + tile - 1) / tile);
  return shmem::launch_world(ring_ag_kernel<W>, n, n_tiles, kThreads, 0, st,
                             info, static_cast<const W*>(x),
                             static_cast<W*>(out), flags, words, tile,
                             n_tiles);
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

// Tiles of a chunk; the launch needs (n - 1) * ag_tile_count flags a rank.
extern "C" int ag_tile_count(long long chunk_bytes, int tile_bytes) {
  return int((chunk_bytes + tile_bytes - 1) / tile_bytes);
}

// x (n, chunk_bytes), out (n, n, chunk_bytes); flags (n, (n - 1) *
// ag_tile_count) zeroed. tile_bytes a multiple of 16. Any dtype: the
// kernel moves bytes. Returns a cudaError_t (0 = launched).
extern "C" int ag_launch(const void* x, void* out, void* flags, int n,
                         long long chunk_bytes, int tile_bytes, void* info,
                         void* stream) {
  if (n < 2 || chunk_bytes < 1 || tile_bytes < 16 || tile_bytes % 16 ||
      chunk_bytes % 2)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* fl = static_cast<int*>(flags);
  int* inf = static_cast<int*>(info);
  if (chunk_bytes % 16 == 0)
    return int(launch<uint4>(x, out, fl, n, chunk_bytes, tile_bytes, inf, st));
  if (chunk_bytes % 4 == 0)
    return int(launch<unsigned int>(x, out, fl, n, chunk_bytes, tile_bytes,
                                    inf, st));
  return int(launch<unsigned short>(x, out, fl, n, chunk_bytes, tile_bytes,
                                    inf, st));
}

extern "C" const char* ag_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
