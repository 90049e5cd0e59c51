// Low-latency AllGather over the virtual world of one card, sm_90a.
//
// Replaces the Pallas TPU kernel `_ll_ag_kernel` reached through
// `ll_all_gather` in triton_dist_tpu/kernels/low_latency_allgather.py
// (native wire). Same function, rank-stacked: x (n, bytes) holds rank
// r's payload at [r]; rank r's result is the (n, bytes) gather of every
// rank's payload in rank order, written to a fresh output out[r].
//
// The protocol is the JAX kernel's barrier-free steady state, carried by
// a persistent context (runtime/symm_mem.py VirtualWorld.context) that
// the caller threads through calls:
//   data  (n ranks, 2 parities, n slots, bytes): call k uses parity k % 2,
//         and slot s of rank r's partition holds rank s's payload;
//   flags (n ranks, 2 n + 1) int32: word parity * n + s of rank r is the
//         delivery flag of slot (parity, s), the last word the entry
//         barrier's counter.
// Call k: for each of its peers (me + j) mod n (the own rank at j = 0),
// a block of rank me reads x[me] once and stores it both into slot
// (k % 2, me) of the peer's partition and straight into the peer's
// result out[peer, me]. Then it publishes all its puts at once (the
// fence-once rule of shmem.cuh): one block barrier, thread 0's one
// fence.acq_rel.gpu and a relaxed store of k + 1 to each of those slots'
// flags. Then thread 0 waits, by value, until the flag of each slot it
// owns, (k % 2, (me - j) mod n), reads k + 1, polling with a 64 ns
// backoff cap. No flag is ever reset: a flag that reads k + 1 can only
// have been set by call k. Only the first call on a fresh context
// barriers (the peers must be inside the kernel before the first puts
// land; afterwards the flags order everything). The call count k comes
// from the host, or from an int32 word in device memory that every block
// reads at entry (the SP decode step's count, which the step advances on
// the card, so a captured step replays as call 0, 1, 2, ...: JAX's traced
// call_count); a negative word traps.
//
// The data moves once: the sender writes out itself (a fresh output
// that the wrapper allocates each call, partitioned by rank, as the
// all-to-all's), so no copy of a slot into out sits behind the flag, and
// the wait only orders completion. The slots still receive what the
// plain version writes there, so a context holds the same bytes whichever
// version ran. Call k + 2 rewriting a
// slot of call k cannot race a reader: nothing reads the slots in the
// launch, and consecutive launches on a stream are ordered.
//
// The grid: a block a peer, n blocks a rank. On an H100 one block a
// rank was 2.7x slower at the SP decode payload, 2.1-2.3x at phase 4w's
// and at 16 bytes, where its puts' loads wait one after another, and two
// blocks 1.35-1.55x (PERF.md). Block j takes the peers j, j + gridDim.x,
// ...: its puts first, then its waits, so a block holding several peers
// (launch_world caps the grid where the card holds fewer blocks) cannot
// deadlock. The launch is cooperative (shmem.cuh
// launch_world), so every spin can only wait on a block that is
// running, and every spin is bounded and traps.
//
// What bounds it: latency, not bytes. A flash-decode exchange moves
// n (n - 1) payloads of 67,584 bytes at world 4: 0.8 MB, 0.24 us of
// HBM time. On an H100 the same launch on 16 bytes a rank takes 2.5 us
// (the cooperative launch of 16 blocks and one flag round trip), and a
// block's two stores of 67,584 bytes another 2.6: one SM's store rate
// (tools/profile_p2p_ll.py, PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#include "shmem.cuh"

namespace {

// kUnits 16-byte loads in flight a thread. On an H100 the SP decode
// payload took 5.1-5.3 us at 512 x 8 and 256 x 16 alike, 5.4 at 512 x
// 16 (128 registers, spilling) and 6.1 at 1024 x 8 (spilling), whose
// 16-byte floor also rose from 2.5 to 2.9 us (tools/profile_p2p_ll.py,
// rebuilt at each shape)
constexpr int kThreads = 512;
constexpr int kUnits = 8;

__global__ void __launch_bounds__(kThreads)
ll_ag_kernel(const char* __restrict__ x, char* data, int* flags, char* out,
             int n, long long bytes, int parity, int value, int first,
             const int* __restrict__ count) {
  const int me = blockIdx.y;
  const int words = 2 * n + 1;  // flag words a rank
  if (count != nullptr) {  // the call count in device memory
    const int k = *count;
    if (k < 0) {
      if (threadIdx.x == 0 && blockIdx.x == 0 && me == 0)
        printf("ll_all_gather: call count %d in device memory is < 0\n", k);
      __trap();
    }
    parity = k & 1;
    value = k + 1;
    first = k == 0;
  }
  if (first)
    shmem::barrier_all(flags, words, 2 * n, me, n, "ll_all_gather");
  const char* mine = x + size_t(me) * bytes;
  for (int j = blockIdx.x; j < n; j += gridDim.x) {
    const int peer = (me + j) % n;
    shmem::copy_nc<kThreads, kUnits>(
        data + ((size_t(peer) * 2 + parity) * n + me) * bytes,
        out + (size_t(peer) * n + me) * bytes, mine, bytes);
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  shmem::fence_acq_rel();
  for (int j = blockIdx.x; j < n; j += gridDim.x)
    shmem::st_relaxed(
        flags + size_t((me + j) % n) * words + parity * n + me, value);
  for (int j = blockIdx.x; j < n; j += gridDim.x) {
    const int src = (me - j + n) % n;
    shmem::spin_until(flags + size_t(me) * words + parity * n + src,
                      shmem::kEq, value, "ll_all_gather", me,
                      parity * n + src, shmem::kPollNs);
  }
}

}  // namespace

// One call on the context (data, flags): parity = call_count % 2,
// value = call_count + 1, first = 1 on a fresh context; with count
// non-null the kernel takes them from the int32 word *count instead
// (call_count and first unused). info receives the grid (shmem.cuh
// launch_world). Returns a cudaError_t (0 = launched).
extern "C" int ll_ag_launch(const void* x, void* data, void* flags,
                            void* out, int n, long long bytes,
                            int call_count, int first, const void* count,
                            int* info, void* stream) {
  if (n < 1 || bytes < 1 || call_count < 0) return int(cudaErrorInvalidValue);
  return int(shmem::launch_world(
      ll_ag_kernel, n, n, kThreads, 0, static_cast<cudaStream_t>(stream),
      info, static_cast<const char*>(x), static_cast<char*>(data),
      static_cast<int*>(flags), static_cast<char*>(out), n, bytes,
      call_count % 2, call_count + 1, first, static_cast<const int*>(count)));
}

extern "C" const char* ll_ag_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
