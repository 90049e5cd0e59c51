// One-shot AllReduce over the virtual world of one card, sm_90a.
//
// Replaces the Pallas TPU kernel `_one_shot_ar_kernel` reached through
// `one_shot_all_reduce` in triton_dist_tpu/kernels/allreduce.py. Same
// protocol: after an entry barrier, every rank puts its whole tensor
// into slot `me` of every peer's workspace and signals the peer; each
// rank waits for its n-1 arrivals and sums the n slots locally.
//
// Input x (n, E) rank-stacked (E = M * N elements a rank), workspace
// ws = heap((n, E)) of every rank, i.e. (n, n, E) with ws[p][r] rank r's
// contribution in rank p's partition, output (n, E). The tensor is cut
// into tiles of `tile` elements, each with its own arrival counter, so a
// tile is summed as soon as its n-1 copies have landed. All n ranks run
// in one cooperative launch (grid (blocks per rank, n)); block b of
// every rank takes tiles b, b + blocks, ..., puts all of them, then
// folds them, so no wait can depend on a block that is itself waiting.
//
// Fold order: the JAX body's, `acc = acc + ws[r]` over ranks 0..n-1 in
// that order with the accumulator in x.dtype: each add is done in f32 and
// rounded to x.dtype, whatever `me` is. So every rank's copy has the same
// bits (the replicated residual streams cannot drift apart), and the
// result is the JAX kernel's, bitwise, in f32 and in bf16.
//
// Persistent flags, left at zero. The wrapper keeps the workspace and
// the flag pool across calls (zeroed once when made). A rank's pool is
// [tile arrivals (tiles), entry barriers (one per block index)], `stride`
// ints apart. The entry barrier is per block index: block b of every rank
// adds one to barrier flag b of each peer and waits for n-1. Block b's
// puts land only in tiles that block b of the peer folds, so block b of a
// peer that has passed this barrier has finished the previous call's
// folds of those tiles, and its slots are free. Each wait (thread 0,
// by value, == n-1) then takes back what it waited for with an atomic
// subtract, not a store of 0, so an arrival of a later call could never
// be lost; after the last fold every flag of the pool reads zero, and
// the next launch on the stream finds them so. A flag left set (a
// trapped launch) makes the next wait trap: the wait is for exactly n-1.
//
// Publication: a block's stores, the block barrier, then thread 0's
// red.release.gpu adds, with no __threadfence. The barrier orders every
// thread's stores before thread 0's release, and a release is cumulative
// over what the barrier ordered before it, so the reader's acquire sees
// them (the ring ReduceScatter's `ring_signal`, reduce_scatter.cu). Waits
// back off to at most kSleepNs, keeping the 5 s bound and trap of
// shmem::spin_until.
//
// The data path. Thread i owns units i, i + threads, ... (U of them) of
// 16 bytes of each of its block's tiles, the same at every rank. It
// loads its units of x once (U loads in flight), stores them into slot
// `me` of each peer, and keeps them in registers for its own term of
// the fold. Right after a tile's acquire it issues its loads of the
// peers' delivered words, up to 8 words in flight, and folds them in
// rank order in registers. A block with several tiles keeps only the
// last one's units: it folds that tile first and reloads the others'.
// Where E is not a multiple of 16 bytes' worth of elements, the same
// kernel moves each unit one element at a time, with the same roundings
// and the same bits.
//
// What bounds it on an H100: bytes and latency. The least traffic for
// the function is n inputs read and n outputs written. The push protocol
// moves more (x read, n-1 copies written and read, out written: ~4.5 E
// words a rank at n = 4); at a decode step's 32 KiB a rank, the two
// synchronisation round trips (entry barrier, arrival) set the time.
// The copies exist so the port keeps the reference's put protocol; on
// one card a rank could read its peers' inputs directly.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "shmem.cuh"

namespace {

constexpr int kMaxThreads = 128;
// blocks an SM kept resident (the wrapper's _AR_PER_SM)
constexpr int kPerSM = 4;
// the waits are a round trip apart: poll often
constexpr unsigned kSleepNs = 64;

template <class S>
struct Elem;
template <>
struct Elem<float> {
  static __device__ __forceinline__ float get(float v) { return v; }
  static __device__ __forceinline__ float put(float v) { return v; }
};
template <>
struct Elem<unsigned short> {  // bf16 bits
  static __device__ __forceinline__ float get(unsigned short v) {
    return __uint_as_float(uint32_t(v) << 16);
  }
  static __device__ __forceinline__ unsigned short put(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};

// 16 bytes of storage type S
template <class S>
union Unit {
  static constexpr int kPer = 16 / sizeof(S);
  S e[kPer];
  uint4 w;
};

// The unit at p into r: one 16-byte word when vec, else element by
// element, those at or past `left` as zero. CG: past L1 (data another
// rank delivered); else the read-only path.
template <bool CG, class S>
__device__ __forceinline__ void load_unit(Unit<S>& r, const S* p, bool vec,
                                          long long left) {
  if (vec) {
    const uint4* q = reinterpret_cast<const uint4*>(p);
    r.w = CG ? __ldcg(q) : __ldg(q);
  } else {
#pragma unroll
    for (int e = 0; e < Unit<S>::kPer; ++e)
      r.e[e] = e < left ? (CG ? __ldcg(p + e) : __ldg(p + e)) : S(0);
  }
}

template <class S>
__device__ __forceinline__ void store_unit(S* p, const Unit<S>& r, bool vec,
                                           long long left) {
  if (vec) {
    *reinterpret_cast<uint4*>(p) = r.w;
  } else {
#pragma unroll
    for (int e = 0; e < Unit<S>::kPer; ++e)
      if (e < left) p[e] = r.e[e];
  }
}

// Thread 0 waits until *flag == v, then takes v back (relaxed: the
// acquire already ordered the reads that follow); the block then syncs.
__device__ __forceinline__ void take(int* flag, int v, int rank, int index) {
  if (threadIdx.x == 0) {
    shmem::spin_until(flag, shmem::kEq, v, "one_shot_all_reduce", rank,
                      index, kSleepNs);
    atomicSub(flag, v);
  }
  __syncthreads();
}

// U: units of 16 bytes a thread a tile (tile = blockDim.x * U units).
template <class S, int U>
__global__ void __launch_bounds__(kMaxThreads, kPerSM)
one_shot_ar_kernel(const S* x, S* ws, S* out, int* flags, long long E,
                   int tile, int n_tiles, int stride, int vec) {
  typedef Elem<S> X;
  constexpr int kPer = Unit<S>::kPer;
  // peers' words in flight at once in the fold: at most 8 words
  constexpr int P = U >= 8 ? 1 : 8 / U;
  const int n = gridDim.y, me = blockIdx.y, G = gridDim.x;
  const int b = blockIdx.x;
  const S* xm = x + size_t(me) * E;
  int* mine = flags + size_t(me) * stride;

  // first element of this thread's unit j in tile t, and what is left
  auto at = [&](int t, int j) {
    return static_cast<long long>(t) * tile +
           (static_cast<long long>(threadIdx.x) + j * blockDim.x) * kPer;
  };

  // the entry barrier of block index b
  __syncthreads();
  if (threadIdx.x == 0)
    for (int i = 1; i < n; ++i)
      shmem::atom_add_release(flags + size_t((me + i) % n) * stride +
                                  n_tiles + b, 1);
  take(mine + n_tiles + b, n - 1, me, n_tiles + b);

  // put every tile of the block into slot `me` of every peer
  Unit<S> own[U];
  int last = -1;
  for (int t = b; t < n_tiles; t += G) {
#pragma unroll
    for (int j = 0; j < U; ++j)
      if (at(t, j) < E) load_unit<false>(own[j], xm + at(t, j), vec,
                                         E - at(t, j));
    for (int i = 1; i < n; ++i) {
      S* slot = ws + (size_t((me + i) % n) * n + me) * E;
#pragma unroll
      for (int j = 0; j < U; ++j)
        if (at(t, j) < E) store_unit(slot + at(t, j), own[j], vec,
                                     E - at(t, j));
    }
    __syncthreads();
    if (threadIdx.x == 0)
      for (int i = 1; i < n; ++i)
        shmem::atom_add_release(flags + size_t((me + i) % n) * stride + t, 1);
    last = t;
  }

  // fold each tile once its n-1 copies have landed: the last one put
  // first, its units still in registers, then the others, reloaded
  S* om = out + size_t(me) * E;
  for (int t = last; t >= b; t -= G) {
    if (t != last) {
#pragma unroll
      for (int j = 0; j < U; ++j)
        if (at(t, j) < E) load_unit<false>(own[j], xm + at(t, j), vec,
                                           E - at(t, j));
    }
    take(mine + t, n - 1, me, t);
    Unit<S> acc[U];
    for (int r0 = 0; r0 < n; r0 += P) {
      Unit<S> v[P][U];
#pragma unroll
      for (int q = 0; q < P; ++q) {
        const int r = r0 + q;
        if (r >= n || r == me) continue;
        const S* slot = ws + (size_t(me) * n + r) * E;
#pragma unroll
        for (int j = 0; j < U; ++j)
          if (at(t, j) < E) load_unit<true>(v[q][j], slot + at(t, j), vec,
                                            E - at(t, j));
      }
#pragma unroll
      for (int q = 0; q < P; ++q) {
        const int r = r0 + q;
        if (r >= n) continue;
#pragma unroll
        for (int j = 0; j < U; ++j) {
          const Unit<S>& s = r == me ? own[j] : v[q][j];
#pragma unroll
          for (int e = 0; e < kPer; ++e)
            acc[j].e[e] = r == 0 ? s.e[e]
                                 : X::put(X::get(acc[j].e[e]) + X::get(s.e[e]));
        }
      }
    }
#pragma unroll
    for (int j = 0; j < U; ++j)
      if (at(t, j) < E) store_unit(om + at(t, j), acc[j], vec, E - at(t, j));
  }
}

template <class S, int U>
cudaError_t launch_u(const void* x, void* ws, void* out, int* flags, int n,
                     long long E, int tile, int blocks, int stride,
                     int* info, cudaStream_t st) {
  const int n_tiles = int((E + tile - 1) / tile);
  const int threads = int(tile * sizeof(S) / 16 / U);
  const int vec = (E * sizeof(S)) % 16 == 0;
  return shmem::launch_world(one_shot_ar_kernel<S, U>, n, blocks, threads, 0,
                             st, info, static_cast<const S*>(x),
                             static_cast<S*>(ws), static_cast<S*>(out), flags,
                             E, tile, n_tiles, stride, vec);
}

template <class S>
cudaError_t launch(const void* x, void* ws, void* out, int* flags, int n,
                   long long E, int tile, int blocks, int stride, int* info,
                   cudaStream_t st) {
  const long long units = tile * (long long)sizeof(S) / 16;
  const long long threads = units < kMaxThreads ? units : kMaxThreads;
  switch (units / threads) {
    case 1:
      return launch_u<S, 1>(x, ws, out, flags, n, E, tile, blocks, stride,
                            info, st);
    case 2:
      return launch_u<S, 2>(x, ws, out, flags, n, E, tile, blocks, stride,
                            info, st);
    case 4:
      return launch_u<S, 4>(x, ws, out, flags, n, E, tile, blocks, stride,
                            info, st);
    case 8:
      return launch_u<S, 8>(x, ws, out, flags, n, E, tile, blocks, stride,
                            info, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// x (n, E), ws (n, n, E), out (n, E); flags (n, stride) of a persistent
// pool left at zero, stride >= tiles + blocks (the wrapper's _ar_plan:
// tile elements a tile, a power of two of 16-byte units, at most 8
// units a thread of 128; blocks per rank). dtype: 0 = float32, 1 =
// bfloat16. info: 3 ints (see launch_world). Returns a cudaError_t (0 =
// launched).
extern "C" int ar_launch(const void* x, void* ws, void* out, void* flags,
                         int n, long long E, int tile, int blocks, int stride,
                         int dtype, void* info, void* stream) {
  const int size = dtype == 0 ? 4 : 2;
  const long long units = tile * (long long)size / 16;
  if (n < 1 || E < 1 || tile < 1 || tile * (long long)size % 16 ||
      units & (units - 1) || units > 8 * kMaxThreads || blocks < 1 ||
      stride < (E + tile - 1) / tile + blocks)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* fl = static_cast<int*>(flags);
  int* inf = static_cast<int*>(info);
  if (dtype == 0)
    return int(launch<float>(x, ws, out, fl, n, E, tile, blocks, stride, inf,
                             st));
  if (dtype == 1)
    return int(launch<unsigned short>(x, ws, out, fl, n, E, tile, blocks,
                                      stride, inf, st));
  return int(cudaErrorInvalidValue);
}

extern "C" const char* ar_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
