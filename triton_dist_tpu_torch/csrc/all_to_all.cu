// The MoE all-to-all over the virtual world of one card, sm_90a: the
// single-shot exchange and its chunked form.
//
// Replaces the Pallas TPU kernels `_a2a_kernel` (reached through
// `all_to_all`, triton_dist_tpu/kernels/all_to_all.py:95) and
// `_a2a_chunked_kernel` (reached through `all_to_all_chunked`, :313).
// Same function, rank-stacked: x (n src, n dst, seg) holds at [r, i] the
// segment rank r sends to rank i, and rank r's result out[r] (n, seg)
// holds at [j] the segment rank j sent it: out[r, j] = x[j, r]. A splits
// row (seg_s bytes, the segment's counts) travels beside every segment
// the same way. Data movement only, the bytes of whole static segments
// (the rows past a segment's count included), so the result is bitwise
// the plain version's whatever the dtype.
//
// a2a_kernel (row 12): an entry barrier; block b of rank me copies its
// 16-byte-aligned share of segment x[me, i] into slot me of rank i's
// partition for every destination i (own rank first, then the ring
// offsets 1..n-1), adding one to rank i's delivery flag of source me
// (release); block 0 copies the splits row likewise on a flag of its
// own. Then every block acquires its own rank's flags: each source's
// segment flag counts every block of that source, its splits flag one.
//
// a2a_chunked_kernel (row 13): the same bytes, each segment cut into q
// chunks of C / q rows. Chunk c from the source at ring offset i (me - i)
// lands on the destination's delivery flag [i, c]: the slot is indexed
// by the RING STEP, never by the absolute source rank, the invariant of
// the JAX kernel's docstring (:144-163) that its verifier's mutant pins.
// Sends and waits are chunk-major: once iteration c of the waits is
// passed, chunk c has arrived from every source while chunks c+1.. may
// still be on their way, the order a consumer that fused compute into
// the wait would need. `straggle_rank` stalls that rank's blocks for
// `straggle_ns` before their sends (shmem::straggler_delay), so the
// peers' waits really wait; the bytes are the same.
//
// Flags a rank (int32, zeroed on the stream before every launch,
// a2a_flag_words): [0] the entry barrier, [1, 1 + n q) the segment
// delivery slots (q = 1 for a2a_kernel, indexed by source rank there),
// [1 + n q, 1 + n q + n) the splits slots. Every wait is bounded and
// traps (shmem.cuh). All n ranks run in one cooperative launch, so every
// block is resident and a wait only ever waits on a running block; a
// block does all its puts before its first wait.
//
// What bounds it on an H100: bytes. Every segment is read once and
// written once: the EP dispatch at Qwen3-30B-A3B widths, 4 ranks x 128
// tokens x top-8 (C 1024 slots, 2176 bf16 columns), moves 71 MB each
// way, 42 us at 3.35 TB/s; the combine's f32 (4, 1024, 2048) a rank,
// 134 MB, 80 us. A decode step's exchange (C 8) is a few hundred KB:
// latency-bound, one launch and the barrier.

#include <cuda_runtime.h>
#include <stdint.h>

#include "shmem.cuh"

namespace {

constexpr int kThreads = 512;

// block 0 copies the splits row of (me -> peer) into slot me of peer's
// out_splits and adds one to `flag`
__device__ __forceinline__ void put_splits(const char* sp, char* osp, int me,
                                           int peer, int n, long long seg_s,
                                           int* flag) {
  if (blockIdx.x != 0) return;
  shmem::put_slot(osp + (size_t(peer) * n + me) * seg_s,
                  sp + (size_t(me) * n + peer) * seg_s, seg_s, flag, 1, true);
}

__global__ void __launch_bounds__(kThreads)
a2a_kernel(const char* __restrict__ x, char* out, const char* sp, char* osp,
           int* flags, int n, long long seg, long long seg_s) {
  const int me = blockIdx.y;
  const int words = 1 + 2 * n;
  int* mine = flags + size_t(me) * words;
  shmem::barrier_all(flags, words, 0, me, n, "all_to_all");
  long long lo, hi;
  shmem::block_share(seg, gridDim.x, blockIdx.x, &lo, &hi);
  for (int i = 0; i < n; ++i) {
    const int peer = (me + i) % n;
    int* theirs = flags + size_t(peer) * words;
    shmem::put_slot(out + (size_t(peer) * n + me) * seg + lo,
                    x + (size_t(me) * n + peer) * seg + lo, hi - lo,
                    theirs + 1 + me, 1, true);
    put_splits(sp, osp, me, peer, n, seg_s, theirs + 1 + n + me);
  }
  for (int j = 0; j < n; ++j)
    shmem::signal_wait_until(mine + 1 + j, shmem::kGe, int(gridDim.x),
                             "all_to_all", me, 1 + j);
  if (blockIdx.x == 0)
    for (int j = 0; j < n; ++j)
      shmem::signal_wait_until(mine + 1 + n + j, shmem::kGe, 1, "all_to_all",
                               me, 1 + n + j);
}

__global__ void __launch_bounds__(kThreads)
a2a_chunked_kernel(const char* __restrict__ x, char* out, const char* sp,
                   char* osp, int* flags, int n, long long seg,
                   long long seg_s, int q, int straggle_rank,
                   long long straggle_ns) {
  const int me = blockIdx.y;
  const int words = 1 + n * q + n;
  int* mine = flags + size_t(me) * words;
  shmem::barrier_all(flags, words, 0, me, n, "all_to_all_chunked");
  shmem::straggler_delay(straggle_rank, me, straggle_ns);
  const long long chunk = seg / q;
  long long lo, hi;
  shmem::block_share(chunk, gridDim.x, blockIdx.x, &lo, &hi);
  for (int c = 0; c < q; ++c)
    for (int i = 0; i < n; ++i) {  // ring step i: peer me + i, slot [i, c]
      const int peer = (me + i) % n;
      shmem::put_slot(out + (size_t(peer) * n + me) * seg + c * chunk + lo,
                      x + (size_t(me) * n + peer) * seg + c * chunk + lo,
                      hi - lo, flags + size_t(peer) * words + 1 + i * q + c, 1,
                      true);
    }
  for (int i = 0; i < n; ++i) {
    const int peer = (me + i) % n;
    put_splits(sp, osp, me, peer, n, seg_s,
               flags + size_t(peer) * words + 1 + n * q + i);
  }
  // chunk-major: chunk c from every source (ring step i = source me - i)
  for (int c = 0; c < q; ++c)
    for (int i = 0; i < n; ++i)
      shmem::signal_wait_until(mine + 1 + i * q + c, shmem::kGe,
                               int(gridDim.x), "all_to_all_chunked", me,
                               1 + i * q + c);
  if (blockIdx.x == 0)
    for (int i = 0; i < n; ++i)
      shmem::signal_wait_until(mine + 1 + n * q + i, shmem::kGe, 1,
                               "all_to_all_chunked", me, 1 + n * q + i);
}

}  // namespace

// int32 flag words a rank: barrier, n * q delivery slots, n splits slots
extern "C" int a2a_flag_words(int n, int q) { return 1 + n * q + n; }

// x (n, n, seg) bytes, out likewise; splits / out_splits (n, n, seg_s)
// bytes; flags (n, a2a_flag_words(n, q)) zeroed. chunked = 0: the
// single-shot kernel (q must be 1); chunked = 1: q chunks, seg % q == 0,
// straggle_rank < 0 for none. want_blocks caps the blocks a rank; info
// receives the grid (shmem.cuh launch_world). Returns a cudaError_t
// (0 = launched).
extern "C" int a2a_launch(const void* x, void* out, const void* splits,
                          void* out_splits, void* flags, int n, long long seg,
                          long long seg_s, int q, int chunked,
                          int straggle_rank, long long straggle_ns,
                          int want_blocks, int* info, void* stream) {
  if (n < 2 || seg < 1 || seg_s < 1 || q < 1 || seg % q ||
      (!chunked && q != 1) || want_blocks < 1)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const char* xs = static_cast<const char*>(x);
  const char* sp = static_cast<const char*>(splits);
  char* o = static_cast<char*>(out);
  char* os = static_cast<char*>(out_splits);
  int* fl = static_cast<int*>(flags);
  if (!chunked)
    return int(shmem::launch_world(a2a_kernel, n, want_blocks, kThreads, 0,
                                   st, info, xs, o, sp, os, fl, n, seg,
                                   seg_s));
  return int(shmem::launch_world(a2a_chunked_kernel, n, want_blocks, kThreads,
                                 0, st, info, xs, o, sp, os, fl, n, seg, seg_s,
                                 q, straggle_rank, straggle_ns));
}

extern "C" const char* a2a_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
