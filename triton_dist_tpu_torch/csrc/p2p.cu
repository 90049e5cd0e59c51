// Point-to-point transfers over the virtual world of one card, sm_90a:
// the pipeline-parallel transport.
//
// p2p_kernel replaces the Pallas TPU kernel `_p2p_kernel` (reached through
// `p2p_send`, triton_dist_tpu/kernels/p2p.py:96; `p2p_read` is the same
// launch in reverse). Rank-stacked x (n, bytes): rank src's x lands in
// rank dst's output, every other rank passes its own x through. After a
// barrier_all (src and dst may be any ranks), every rank except dst
// copies x[me] into out[me]; src also puts x[src] into out[dst] and adds
// one to dst's delivery flag; dst waits until that flag counts every
// block of src. Dst never writes its own output: on the TPU that local
// copy would race the incoming put (p2p.py:55-58), and so would two
// blocks' stores here. When src == dst, every rank copies.
//
// ring_shift_kernel replaces `ring_shift`'s inner `kernel` (p2p.py:130,
// launched :139): every rank puts x[me] into out[(me + shift) mod n],
// the PP stage handoff, and waits for the one arrival into its own
// output. The destination is ((me + shift) % n + n) % n: C's % keeps the
// sign of a negative shift. The prologue is the JAX one: neighbor_barrier
// when |shift| == 1, else barrier_all. A shift of 0 mod n copies to self.
//
// Flags a rank (int32, zeroed on the stream before every launch): [0] the
// barrier, [1] the delivery count. `straggle_rank` stalls that rank's
// blocks for `straggle_ns` after the barrier (shmem::straggler_delay), so
// the receivers really wait; the bytes are the same. Data movement only:
// the result is bitwise the plain version's whatever the dtype. Each
// block copies a 16-byte-aligned share of the rank's bytes.
//
// What bounds them on an H100: bytes. p2p reads and writes n buffers,
// ring_shift n; the PP handoff of a (512, 4096) bf16 microbatch a stage
// at world 4 moves 16.8 MB each way, 10 us at 3.35 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>

#include "shmem.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWords = 2;  // flags a rank: barrier, delivery

__global__ void __launch_bounds__(kThreads)
p2p_kernel(const char* __restrict__ x, char* out, int* flags, long long bytes,
           int src, int dst, int straggle_rank, long long straggle_ns) {
  const int n = gridDim.y, me = blockIdx.y;
  shmem::barrier_all(flags, kWords, 0, me, n, "p2p_send");
  shmem::straggler_delay(straggle_rank, me, straggle_ns);
  long long lo, hi;
  shmem::block_share(bytes, gridDim.x, blockIdx.x, &lo, &hi);
  const char* mine = x + size_t(me) * bytes;
  if (src == dst || me != dst)
    shmem::copy_block(out + size_t(me) * bytes + lo, mine + lo, hi - lo);
  if (src == dst) return;
  if (me == src)
    shmem::put_slot(out + size_t(dst) * bytes + lo, mine + lo, hi - lo,
                    flags + size_t(dst) * kWords + 1, 1, true);
  if (me == dst)
    shmem::signal_wait_until(flags + size_t(me) * kWords + 1, shmem::kGe,
                             int(gridDim.x), "p2p_send", me, 1);
}

__global__ void __launch_bounds__(kThreads)
ring_shift_kernel(const char* __restrict__ x, char* out, int* flags,
                  long long bytes, int shift, int straggle_rank,
                  long long straggle_ns) {
  const int n = gridDim.y, me = blockIdx.y;
  if (shift == 1 || shift == -1)
    shmem::neighbor_barrier(flags, kWords, 0, me, n, "ring_shift");
  else
    shmem::barrier_all(flags, kWords, 0, me, n, "ring_shift");
  shmem::straggler_delay(straggle_rank, me, straggle_ns);
  const int to = ((me + shift) % n + n) % n;
  long long lo, hi;
  shmem::block_share(bytes, gridDim.x, blockIdx.x, &lo, &hi);
  shmem::put_slot(out + size_t(to) * bytes + lo, x + size_t(me) * bytes + lo,
                  hi - lo, flags + size_t(to) * kWords + 1, 1, true);
  shmem::signal_wait_until(flags + size_t(me) * kWords + 1, shmem::kGe,
                           int(gridDim.x), "ring_shift", me, 1);
}

}  // namespace

// int32 flag words a rank of either launch
extern "C" int p2p_flag_words() { return kWords; }

// x, out (n, bytes); flags (n, p2p_flag_words()) zeroed; 0 <= src, dst <
// n; straggle_rank < 0 for none; want_blocks caps the blocks a rank.
// Returns a cudaError_t (0 = launched).
extern "C" int p2p_launch(const void* x, void* out, void* flags, int n,
                          long long bytes, int src, int dst,
                          int straggle_rank, long long straggle_ns,
                          int want_blocks, void* info, void* stream) {
  if (n < 2 || bytes < 1 || src < 0 || src >= n || dst < 0 || dst >= n ||
      want_blocks < 1)
    return int(cudaErrorInvalidValue);
  return int(shmem::launch_world(
      p2p_kernel, n, want_blocks, kThreads, 0,
      static_cast<cudaStream_t>(stream), static_cast<int*>(info),
      static_cast<const char*>(x), static_cast<char*>(out),
      static_cast<int*>(flags), bytes, src, dst, straggle_rank, straggle_ns));
}

// x, out (n, bytes); flags (n, p2p_flag_words()) zeroed; any shift.
extern "C" int ring_shift_launch(const void* x, void* out, void* flags, int n,
                                 long long bytes, int shift,
                                 int straggle_rank, long long straggle_ns,
                                 int want_blocks, void* info, void* stream) {
  if (n < 2 || bytes < 1 || want_blocks < 1) return int(cudaErrorInvalidValue);
  return int(shmem::launch_world(
      ring_shift_kernel, n, want_blocks, kThreads, 0,
      static_cast<cudaStream_t>(stream), static_cast<int*>(info),
      static_cast<const char*>(x), static_cast<char*>(out),
      static_cast<int*>(flags), bytes, shift, straggle_rank, straggle_ns));
}

extern "C" const char* p2p_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
