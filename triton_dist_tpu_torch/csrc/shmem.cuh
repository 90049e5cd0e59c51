// Device-side shmem over the virtual world of one card — the port's
// counterpart of triton_dist_tpu/lang/shmem.py (putmem_nbi, signal,
// signal_wait_until, barrier_all, neighbor_barrier, fcollect_slots,
// fcollect, straggler_delay) and
// of kernels/low_latency_allgather.py's segment_collect_start.
//
// The virtual world (runtime/symm_mem.py): n ranks live on one GPU. The
// symmetric heap is one allocation with a leading rank dimension, so
// rank r's partition of a heap tensor is heap + r * (partition size),
// and a put is a store into the peer's partition. A signal is an int32
// flag in a per-rank flag pool (flags + r * stride), written with
// release semantics and read with an acquire spin. One launch runs all
// n ranks' programs (the rank is blockIdx.y); launch_world below makes
// it a cooperative launch, so every block is resident and a spin can
// only wait on blocks that are running.
//
// Memory order, the one rule every kernel here follows: a writer does
// all its stores, then __syncthreads(), then one thread __threadfence()
// and the release store / release add of the flag; a reader does one
// acquire load of the flag (one thread), then __syncthreads(), then
// reads the data with ld.global.cg (__ldcg, past L1, which is not
// coherent across SMs). The ring ReduceScatter's hops leave out the
// __threadfence: the release add is cumulative over the barrier
// (reduce_scatter.cu ring_signal). The all-to-all publishes n flags at
// once with one fence.acq_rel.gpu and relaxed adds (all_to_all.cu).
//
// Every spin is bounded: past kWaitBoundNs the waiting thread prints
// (kernel, rank, flag index, value) and executes __trap(). The launch
// then fails with a sticky CUDA error that the next synchronisation
// raises, so a protocol fault ends the run instead of hanging it.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include <mutex>

namespace shmem {

// far above any correct wait (the longest is one GEMM tile's worth of
// work per peer, microseconds), short enough for a run's time limit
constexpr unsigned long long kWaitBoundNs = 5000000000ull;  // 5 s

enum Cmp { kEq = 0, kGe = 1 };

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// atom.add.release.gpu without a result (its `red` form)
__device__ __forceinline__ void atom_add_release(int* p, int v) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// signal_set / signal_add: publish this block's stores, then set / add
// the flag. Memory-order rule of the header: stores, __syncthreads(),
// one thread __threadfence() + release.
__device__ __forceinline__ void signal_set(int* flag, int v) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    st_release(flag, v);
  }
}

__device__ __forceinline__ void signal_add(int* flag, int v) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atom_add_release(flag, v);
  }
}

// One thread's bounded acquire spin until `*flag cmp v`, backing off
// with __nanosleep from 32 ns, doubling up to max_sleep_ns: past
// kWaitBoundNs it prints (kernel, rank, flag index, value) and traps.
__device__ __forceinline__ void spin_until(const int* flag, Cmp cmp, int v,
                                           const char* kernel, int rank,
                                           int index,
                                           unsigned max_sleep_ns = 1024) {
  const unsigned long long t0 = globaltimer();
  unsigned ns = 32;
  for (;;) {
    const int x = ld_acquire(flag);
    if (cmp == kEq ? x == v : x >= v) break;
    if (globaltimer() - t0 > kWaitBoundNs) {
      printf("shmem wait timed out: kernel %s, rank %d, flag %d, value %d, "
             "waiting for %s %d\n",
             kernel, rank, index, x, cmp == kEq ? "==" : ">=", v);
      __trap();
    }
    __nanosleep(ns);
    if (ns < max_sleep_ns) ns *= 2;
  }
}

// Thread 0 spins (spin_until); then the block syncs, and its reads of the
// guarded data (with __ldcg) follow. With kEq it is the wait on a
// persistent flag by value that the low-latency AllGather's parity
// protocol uses: a context flag that call k sets to k + 1 (st.release,
// signal_set) and that is never reset between calls.
__device__ __forceinline__ void signal_wait_until(
    const int* flag, Cmp cmp, int v, const char* kernel, int rank, int index,
    unsigned max_sleep_ns = 1024) {
  if (threadIdx.x == 0)
    spin_until(flag, cmp, v, kernel, rank, index, max_sleep_ns);
  __syncthreads();
}

// Every block of every rank meets here: each block adds one to flag
// `slot` of every peer's pool (pools `stride` ints apart), then waits
// until its own counter holds one arrival from each block of each peer.
__device__ __forceinline__ void barrier_all(int* flags, int stride, int slot,
                                            int rank, int n,
                                            const char* kernel) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    for (int p = 0; p < n; ++p)
      if (p != rank) atom_add_release(flags + size_t(p) * stride + slot, 1);
  }
  signal_wait_until(flags + size_t(rank) * stride + slot, kGe,
                    (n - 1) * int(gridDim.x), kernel, rank, slot);
}

// neighbor_barrier (lang/shmem.py:385): each block adds one to flag
// `slot` of its left and of its right neighbour, then waits until its
// own counter holds two arrivals from each block of the neighbours. At
// n = 2 both signals go to the one peer, which still counts two from
// each of its blocks, as the JAX barrier's wait for 2 does.
__device__ __forceinline__ void neighbor_barrier(int* flags, int stride,
                                                 int slot, int rank, int n,
                                                 const char* kernel) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atom_add_release(flags + size_t((rank - 1 + n) % n) * stride + slot, 1);
    atom_add_release(flags + size_t((rank + 1) % n) * stride + slot, 1);
  }
  signal_wait_until(flags + size_t(rank) * stride + slot, kGe,
                    2 * int(gridDim.x), kernel, rank, slot);
}

// Block-wide copy of `bytes` bytes, 16 at a time when both ends are
// 16-byte aligned, four loads in flight a thread. src is read with
// __ldcg (it may be data another rank delivered).
__device__ __forceinline__ void copy_block(void* dst, const void* src,
                                           long long bytes) {
  char* d = static_cast<char*>(dst);
  const char* s = static_cast<const char*>(src);
  long long head = 0;
  if (((reinterpret_cast<uintptr_t>(d) | reinterpret_cast<uintptr_t>(s)) &
       15) == 0) {
    const long long words = bytes / 16;
    uint4* dw = reinterpret_cast<uint4*>(d);
    const uint4* sw = reinterpret_cast<const uint4*>(s);
    constexpr int U = 4;
    const long long step = blockDim.x;
    long long i = threadIdx.x;
    for (; i + (U - 1) * step < words; i += U * step) {
      uint4 v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) v[u] = __ldcg(sw + i + u * step);
#pragma unroll
      for (int u = 0; u < U; ++u) dw[i + u * step] = v[u];
    }
    for (; i < words; i += step) dw[i] = __ldcg(sw + i);
    head = words * 16;
  }
  for (long long i = head + threadIdx.x; i < bytes; i += blockDim.x)
    d[i] = __ldcg(s + i);
}

// The share [lo, hi) of `bytes` that block `block` of `blocks` moves:
// equal 16-byte-aligned parts (the last ones short or empty).
__device__ __forceinline__ void block_share(long long bytes, int blocks,
                                            int block, long long* lo,
                                            long long* hi) {
  const long long share = ((bytes + blocks - 1) / blocks + 15) / 16 * 16;
  *lo = min(bytes, share * block);
  *hi = min(bytes, *lo + share);
}

// The put of fcollect_slots (lang/shmem.py:622) for one destination:
// this block copies `bytes` of src into dst (slot `me` of a peer's
// partition, or this block's share of it), then publishes them on the
// slot's flag: set to `value` (a persistent flag waited on by value) or,
// with add, adds `value` (several blocks share one slot; the reader
// waits for their count). A full-mesh collect is one such put per peer
// (the caller spreads the peers over its blocks); the reader waits on
// the flag of each slot it reads.
__device__ __forceinline__ void put_slot(void* dst, const void* src,
                                         long long bytes, int* flag,
                                         int value, bool add) {
  copy_block(dst, src, bytes);
  if (add)
    signal_add(flag, value);
  else
    signal_set(flag, value);
}

// fcollect (lang/shmem.py:661): the flat full-mesh collect. Rank me's
// `bytes` of src go to slot me of every rank's partition of out (rank
// p's partition holds n slots: out + (p * n + j) * bytes is its slot j).
// This block copies its 16-byte-aligned share into its own slot, then
// into the slot of each peer (me + i) mod n, adding one to the peer's
// arrival flag of source me (flags + p * stride + first + me); then it
// waits until each of its own flags from the n - 1 peers counts every
// block of that peer. A caller barriers the team before (the JAX
// precondition) and reads its n slots after.
__device__ __forceinline__ void fcollect(char* out, const char* src,
                                         long long bytes, int* flags,
                                         int stride, int first, int me, int n,
                                         const char* kernel) {
  long long lo, hi;
  block_share(bytes, gridDim.x, blockIdx.x, &lo, &hi);
  copy_block(out + (size_t(me) * n + me) * bytes + lo, src + lo, hi - lo);
  for (int i = 1; i < n; ++i) {
    const int peer = (me + i) % n;
    put_slot(out + (size_t(peer) * n + me) * bytes + lo, src + lo, hi - lo,
             flags + size_t(peer) * stride + first + me, 1, true);
  }
  for (int i = 1; i < n; ++i) {
    const int j = (me + i) % n;
    signal_wait_until(flags + size_t(me) * stride + first + j, kGe,
                      int(gridDim.x), kernel, me, first + j);
  }
}

// segment_collect_start (kernels/low_latency_allgather.py:376): the
// full-mesh push of a rank's segments with a delivery flag per
// (tensor, offset, row), so a consumer can gate on exactly one segment
// while later ones are in flight. For each row b < rows, offset i =
// 1..n-1 and tensor t < tensors, this block (`block` of the `blocks`
// pushing blocks of rank me) copies its 16-byte-aligned share of the
// `bytes` of src_of(t, b) into dst_of(t, i, peer, b), the slot of offset
// i in peer (me + i) mod n's partition, and adds one to flag_of(t, i,
// peer, b). The segment has arrived when that flag counts `blocks`.
// Rows go first, offset 1 first within a row: the order in which SP
// prefill's consumers read them.
template <typename SrcOf, typename DstOf, typename FlagOf>
__device__ __forceinline__ void segment_collect_start(
    int me, int n, int rows, int tensors, long long bytes, int block,
    int blocks, SrcOf src_of, DstOf dst_of, FlagOf flag_of) {
  long long lo, hi;
  block_share(bytes, blocks, block, &lo, &hi);
  for (int b = 0; b < rows; ++b)
    for (int i = 1; i < n; ++i) {
      const int peer = (me + i) % n;
      for (int t = 0; t < tensors; ++t)
        put_slot(static_cast<char*>(dst_of(t, i, peer, b)) + lo,
                 static_cast<const char*>(src_of(t, b)) + lo, hi - lo,
                 flag_of(t, i, peer, b), 1, true);
    }
}

// straggler_delay (lang/shmem.py:431): the blocks of rank `rank` stall
// `nanos` ns on the global timer before going on; other ranks and
// rank < 0 or nanos <= 0 pass through. A race provocation: a protocol
// that is right only when ranks run in step shows it under this delay.
__device__ __forceinline__ void straggler_delay(int rank, int me,
                                                long long nanos) {
  if (rank != me || nanos <= 0) return;
  if (threadIdx.x == 0) {
    const unsigned long long t0 = globaltimer();
    while (globaltimer() - t0 < static_cast<unsigned long long>(nanos))
      __nanosleep(1000);
  }
  __syncthreads();
}

// Launch `kernel` on grid (blocks per rank, n) so that every block is
// resident at once: cudaLaunchCooperativeKernel, with the blocks per
// rank capped at want_per_rank and at what the card holds
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs, split over n
// ranks; grid_of keeps them). info[0..2] receives (blocks per SM, SMs,
// blocks per rank) so the caller can raise with the numbers;
// cudaErrorCooperativeLaunchTooLarge when not one block per rank fits.
// Returns cudaGetLastError() after the launch, so a refused launch is
// reported here and not at the next sync.
template <typename T>
struct same {  // keeps the arguments out of template deduction
  typedef T type;
};

// The SMs of the current device and a kernel's resident blocks an SM at
// (threads, smem), with its dynamic shared memory allowed: queried once
// a (kernel, device, threads, smem) and kept (a loaded kernel does not
// change), so a launch makes no attribute or occupancy query after the
// first of its configuration.
struct GridEntry {
  const void* fn;
  int dev, threads;
  size_t smem;
  int per_sm, sms;
};

inline cudaError_t grid_of(const void* fn, int threads, size_t smem,
                           int* per_sm, int* sms) {
  constexpr int kEntries = 64;  // configurations a library keeps
  static std::mutex mu;
  static GridEntry cache[kEntries];
  static int used = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  {
    std::lock_guard<std::mutex> lock(mu);
    for (int i = 0; i < used; ++i) {
      const GridEntry& g = cache[i];
      if (g.fn == fn && g.dev == dev && g.threads == threads &&
          g.smem == smem) {
        *per_sm = g.per_sm;
        *sms = g.sms;
        return cudaSuccess;
      }
    }
  }
  e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, fn, threads,
                                                      smem);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  if (used < kEntries) cache[used++] = GridEntry{fn, dev, threads, smem,
                                                 *per_sm, *sms};
  return cudaSuccess;
}

template <typename... Args>
cudaError_t launch_world(void (*kernel)(Args...), int n, int want_per_rank,
                         int threads, size_t smem, cudaStream_t stream,
                         int* info, typename same<Args>::type... args) {
  int sms = 0, per_sm = 0;
  cudaError_t e = grid_of(reinterpret_cast<const void*>(kernel), threads,
                          smem, &per_sm, &sms);
  if (e != cudaSuccess) return e;
  int per_rank = per_sm * sms / n;
  if (want_per_rank < per_rank) per_rank = want_per_rank;
  info[0] = per_sm;
  info[1] = sms;
  info[2] = per_rank;
  if (per_rank < 1) return cudaErrorCooperativeLaunchTooLarge;
  void* argv[] = {static_cast<void*>(&args)...};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                  dim3(per_rank, n), dim3(threads), argv, smem,
                                  stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace shmem
