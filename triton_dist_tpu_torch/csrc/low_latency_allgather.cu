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
// Call k: block j of rank me puts x[me] into slot (k % 2, me) of peer
// (me + j) mod n (the own slot at j = 0) and sets that slot's flag to
// k + 1 with release; then it waits, by value, until the flag of its own
// slot (k % 2, (me - j) mod n) reads k + 1, and copies that slot into
// out[me]. No flag is ever reset: a flag that reads k + 1 can only have
// been set by call k. The result is copied out, not aliased: call k + 2
// rewrites the same parity's slots. Only the first call on a fresh
// context barriers (the peers must be inside the kernel before the
// first puts land; afterwards the flags order everything).
//
// Why call k + 2 cannot overwrite a slot that call k is still reading:
// the JAX argument (a peer's call k + 2 waits on our call k + 1 put,
// which follows our call k reads in program order) holds, and on one
// card consecutive launches on a stream are ordered besides.
//
// What bounds it: latency, not bytes. A flash-decode exchange moves
// n (n - 1) payloads of 67,584 bytes at world 4: 0.8 MB, 0.24 us of
// HBM time. Each block does one put and one wait; all n ranks run in one
// cooperative launch (shmem.cuh launch_world), so every spin can only
// wait on a block that is running, and every spin is bounded and traps.

#include <cuda_runtime.h>
#include <stdint.h>

#include "shmem.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
ll_ag_kernel(const char* __restrict__ x, char* data, int* flags, char* out,
             int n, long long bytes, int parity, int value, int first) {
  const int me = blockIdx.y;
  const int words = 2 * n + 1;  // flag words a rank
  if (first)
    shmem::barrier_all(flags, words, 2 * n, me, n, "ll_all_gather");
  auto slot = [&](int rank, int s) {
    return data + ((size_t(rank) * 2 + parity) * n + s) * bytes;
  };
  // the puts first, then the waits: a put never waits, so a block
  // holding several peers (a grid smaller than n) cannot deadlock
  for (int j = blockIdx.x; j < n; j += gridDim.x) {
    const int peer = (me + j) % n;
    shmem::put_slot(slot(peer, me), x + size_t(me) * bytes, bytes,
                    flags + size_t(peer) * words + parity * n + me, value,
                    false);
  }
  for (int j = blockIdx.x; j < n; j += gridDim.x) {
    const int src = (me - j + n) % n;
    shmem::signal_wait_until(flags + size_t(me) * words + parity * n + src,
                             shmem::kEq, value, "ll_all_gather", me,
                             parity * n + src);
    shmem::copy_block(out + (size_t(me) * n + src) * bytes, slot(me, src),
                      bytes);
  }
}

}  // namespace

// One call on the context (data, flags): parity = call_count % 2,
// value = call_count + 1, first = 1 on a fresh context. info receives
// the grid (shmem.cuh launch_world). Returns a cudaError_t (0 = launched).
extern "C" int ll_ag_launch(const void* x, void* data, void* flags,
                            void* out, int n, long long bytes,
                            int call_count, int first, int* info,
                            void* stream) {
  if (n < 1 || bytes < 1 || call_count < 0) return int(cudaErrorInvalidValue);
  return int(shmem::launch_world(
      ll_ag_kernel, n, n, kThreads, 0, static_cast<cudaStream_t>(stream),
      info, static_cast<const char*>(x), static_cast<char*>(data),
      static_cast<int*>(flags), static_cast<char*>(out), n, bytes,
      call_count % 2, call_count + 1, first));
}

extern "C" const char* ll_ag_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
