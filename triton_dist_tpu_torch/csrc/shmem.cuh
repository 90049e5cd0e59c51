// Device-side shmem over the virtual world of one card — the port's
// counterpart of triton_dist_tpu/lang/shmem.py (putmem_nbi, signal,
// signal_wait_until, barrier_all).
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
// coherent across SMs).
//
// Every spin is bounded: past kWaitBoundNs the waiting thread prints
// (kernel, rank, flag index, value) and executes __trap(). The launch
// then fails with a sticky CUDA error that the next synchronisation
// raises, so a protocol fault ends the run instead of hanging it.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

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

// Block-wide put of `count` words from src to dst (a peer partition, or
// any heap slot). src is read with __ldcg: it may be data another rank
// delivered (a ring forward), which L1 could hold stale. The caller
// signals after it.
template <typename W>
__device__ __forceinline__ void putmem_block(W* dst, const W* src,
                                             long long count) {
  for (long long i = threadIdx.x; i < count; i += blockDim.x)
    dst[i] = __ldcg(src + i);
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
// with __nanosleep: past kWaitBoundNs it prints (kernel, rank, flag
// index, value) and traps.
__device__ __forceinline__ void spin_until(const int* flag, Cmp cmp, int v,
                                           const char* kernel, int rank,
                                           int index) {
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
    if (ns < 1024) ns *= 2;
  }
}

// Thread 0 spins (spin_until); then the block syncs, and its reads of the
// guarded data (with __ldcg) follow.
__device__ __forceinline__ void signal_wait_until(const int* flag, Cmp cmp,
                                                  int v, const char* kernel,
                                                  int rank, int index) {
  if (threadIdx.x == 0) spin_until(flag, cmp, v, kernel, rank, index);
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

// Launch `kernel` on grid (blocks per rank, n) so that every block is
// resident at once: cudaLaunchCooperativeKernel, with the blocks per
// rank capped at want_per_rank and at what the card holds
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs, split over n
// ranks). info[0..2] receives (blocks per SM, SMs, blocks per rank) so
// the caller can raise with the numbers; cudaErrorCooperativeLaunchTooLarge
// when not one block per rank fits. Returns cudaGetLastError() after the
// launch, so a refused launch is reported here and not at the next sync.
template <typename T>
struct same {  // keeps the arguments out of template deduction
  typedef T type;
};

template <typename... Args>
cudaError_t launch_world(void (*kernel)(Args...), int n, int want_per_rank,
                         int threads, size_t smem, cudaStream_t stream,
                         int* info, typename same<Args>::type... args) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
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
