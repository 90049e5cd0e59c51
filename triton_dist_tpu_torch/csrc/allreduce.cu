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
// in one cooperative launch (grid (blocks per rank, n)); each block puts
// all its tiles before it waits on any, so no wait can depend on a
// block that is itself waiting.
//
// Fold order: the JAX body's, `acc = acc + ws[r]` over ranks 0..n-1 in
// that order with the accumulator in x.dtype: each add is done in f32 and
// rounded to x.dtype, whatever `me` is. So every rank's copy has the same
// bits (the replicated residual streams cannot drift apart), and the
// result is the JAX kernel's, bitwise, in f32 and in bf16.
//
// What bounds it on an H100: bytes. Each rank reads its tensor, writes
// n-1 copies, reads n-1 and writes its sum; the least traffic for the
// function is n inputs read and n outputs written. The copies exist so
// the port keeps the reference's put protocol; on one card a rank could
// read its peers' inputs directly (a later PR's choice).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "shmem.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(unsigned short x) {
  return __bfloat162float(__ushort_as_bfloat16(x));
}
__device__ __forceinline__ void from_f32(float v, float& o) { o = v; }
__device__ __forceinline__ void from_f32(float v, unsigned short& o) {
  o = __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
// v rounded to the storage type S and widened back
template <typename S>
__device__ __forceinline__ float rounded(float v) {
  S s;
  from_f32(v, s);
  return to_f32(s);
}

// S: the element's storage type (float, or unsigned short for bf16);
// W: the word one thread moves at a time (uint4 = 16 bytes when every
// tile edge is 16-byte aligned, else S itself). E and tile count S's.
template <typename S, typename W>
__global__ void __launch_bounds__(kThreads)
one_shot_ar_kernel(const S* x, S* ws, S* out, int* flags, long long E,
                   int tile, int n_tiles) {
  constexpr int kPer = sizeof(W) / sizeof(S);  // elements per word
  const int n = gridDim.y, me = blockIdx.y;
  const int nf = 1 + n_tiles;  // flag pool of a rank: [barrier, tiles...]
  const long long ew = E / kPer;
  const W* xw = reinterpret_cast<const W*>(x);
  W* wsw = reinterpret_cast<W*>(ws);

  // entry barrier, as the TPU kernel's shmem.barrier_all (a persistent
  // multi-card workspace needs it; here the launch already brings every
  // rank in, and the barrier keeps the reference protocol)
  shmem::barrier_all(flags, nf, 0, me, n, "one_shot_all_reduce");

  // put my tiles into slot `me` of every peer, signalling each
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long lo = (long long)t * tile / kPer;
    const long long cnt = min((long long)tile / kPer, ew - lo);
    for (int i = 1; i < n; ++i) {
      const int p = (me + i) % n;
      shmem::putmem_block(wsw + (size_t(p) * n + me) * ew + lo,
                          xw + size_t(me) * ew + lo, cnt);
      shmem::signal_add(flags + size_t(p) * nf + 1 + t, 1);
    }
  }

  // wait for each tile's n-1 arrivals, sum slots 0..n-1 in order
  W* ow = reinterpret_cast<W*>(out) + size_t(me) * ew;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    shmem::signal_wait_until(flags + size_t(me) * nf + 1 + t, shmem::kGe,
                             n - 1, "one_shot_all_reduce", me, 1 + t);
    const long long lo = (long long)t * tile / kPer;
    const long long hi = min(lo + tile / kPer, ew);
    for (long long w = lo + threadIdx.x; w < hi; w += blockDim.x) {
      float acc[kPer];
      for (int r = 0; r < n; ++r) {
        // own slot from x; peers' slots delivered by them: __ldcg after
        // the acquire (rule of shmem.cuh)
        W v = r == me ? xw[size_t(me) * ew + w]
                      : __ldcg(wsw + (size_t(me) * n + r) * ew + w);
        const S* e = reinterpret_cast<const S*>(&v);
#pragma unroll
        for (int j = 0; j < kPer; ++j)
          acc[j] = r == 0 ? to_f32(e[j]) : rounded<S>(acc[j] + to_f32(e[j]));
      }
      W o;
      S* oe = reinterpret_cast<S*>(&o);
#pragma unroll
      for (int j = 0; j < kPer; ++j) from_f32(acc[j], oe[j]);
      ow[w] = o;
    }
  }
}

template <typename S>
cudaError_t launch(const void* x, void* ws, void* out, int* flags, int n,
                   long long E, int tile, int* info, cudaStream_t st) {
  const int n_tiles = int((E + tile - 1) / tile);
  const bool vec = (E * sizeof(S)) % 16 == 0 && (tile * sizeof(S)) % 16 == 0;
  if (vec)
    return shmem::launch_world(one_shot_ar_kernel<S, uint4>, n, n_tiles,
                               kThreads, 0, st, info,
                               static_cast<const S*>(x), static_cast<S*>(ws),
                               static_cast<S*>(out), flags, E, tile, n_tiles);
  return shmem::launch_world(one_shot_ar_kernel<S, S>, n, n_tiles, kThreads,
                             0, st, info, static_cast<const S*>(x),
                             static_cast<S*>(ws), static_cast<S*>(out), flags,
                             E, tile, n_tiles);
}

}  // namespace

// Flags the launch needs per rank for E elements cut into `tile`s.
extern "C" int ar_flag_count(long long E, int tile) {
  return 1 + int((E + tile - 1) / tile);
}

// x (n, E), ws (n, n, E), out (n, E); flags (n, ar_flag_count) zeroed.
// dtype: 0 = float32, 1 = bfloat16. info: 3 ints (see launch_world).
// Returns a cudaError_t (0 = launched).
extern "C" int ar_launch(const void* x, void* ws, void* out, void* flags,
                         int n, long long E, int tile, int dtype, void* info,
                         void* stream) {
  if (n < 1 || E < 1 || tile < 8 || tile % 8) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* fl = static_cast<int*>(flags);
  int* inf = static_cast<int*>(info);
  if (dtype == 0) return int(launch<float>(x, ws, out, fl, n, E, tile, inf, st));
  if (dtype == 1)
    return int(launch<unsigned short>(x, ws, out, fl, n, E, tile, inf, st));
  return int(cudaErrorInvalidValue);
}

extern "C" const char* ar_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
