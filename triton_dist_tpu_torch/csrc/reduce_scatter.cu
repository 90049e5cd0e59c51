// Credit-flow ring ReduceScatter over the virtual world of one card,
// sm_90a.
//
// Replaces the Pallas TPU kernel `_ring_rs_kernel` reached through
// `ring_reduce_scatter` in triton_dist_tpu/kernels/reduce_scatter.py
// (native wire). Input x (n, n * E) rank-stacked: rank r's contribution
// to chunk c is x[r][c * E, (c + 1) * E). Output (n, E): rank me ends
// with the full sum of chunk me.
//
// The protocol is the TPU kernel's, not its blocking. Every rank holds
// two accumulator slots (acc, heap (n, 2, E) in the accumulation dtype)
// and a credit counter:
//   - first it grants its left neighbour one credit (its slot 1, the
//     target of the left's step 0, is free) and loads its contribution
//     to chunk (me - 1) mod n into slot 0;
//   - at step s = 0 .. n-2 it takes one credit (the right neighbour's
//     slot (s + 1) % 2 is free), puts slot s % 2 into that slot and
//     signals the right's arrival counter of that slot; the send done,
//     slot s % 2 is free again, and unless this was the last step it
//     grants the left a credit; it waits for the left's step-s arrival
//     in its slot (s + 1) % 2 and adds its own contribution to chunk
//     (me - s - 2) mod n into that slot;
//   - after step n - 2 the slot holds chunk me, stored to the output.
// Two slots are reused across all steps, so without the credit a fast
// left neighbour could land step s + 2 in a slot step s still occupies;
// the credit caps the puts in flight into a rank at two, one per slot,
// and an arrival counter per slot counts them exactly (step s's wait is
// for s / 2 + 1 arrivals). With n = 1 no step runs and no credit is
// granted: the output is the input, through the accumulation dtype.
//
// The dtype contract. Accumulation runs in the accumulation dtype A
// (the input dtype unless the caller asks for another): chunk c is
// folded as ((x[c+1] + x[c+2]) + ...) + x[c] over the ranks, each input
// converted to A, each add rounded to A (bf16: the f32 sum of two bf16
// values, which is exact, rounded to nearest even: the correctly
// rounded bf16 add). The output is the last sum converted to the input
// dtype. The plain version (kernels/reduce_scatter.py) folds in the same
// order with the same roundings, so the two agree bitwise.
//
// Launch design, as csrc/allgather.cu: the chunk's E elements are cut
// into tiles, and each tile runs its own ring with its own credit and
// arrival counters (flags (n, 3 * tiles)), so every block of a rank, and
// block j of each rank with the same tiles in the same order, moves its
// column slice around the ring independently. All n ranks run in one
// cooperative launch (shmem.cuh launch_world), every block resident;
// every wait is a bounded acquire spin that traps; flags are fresh per
// call (zeroed by the wrapper).
//
// What bounds it on an H100: bytes. Each rank reads its n chunks once
// and writes one; the ring moves n - 1 chunk-sized puts a rank, read
// from a slot and written into the peer's. At the MoE shapes (a chunk of
// 128 x 2048 bf16, 512 KB) that is microseconds of HBM time, so the n - 1
// serial flag handshakes a tile dominate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "shmem.cuh"

namespace {

constexpr int kThreads = 256;

// storage type, and the exact conversions to and from f32
struct F32 {
  typedef float S;
  static __device__ __forceinline__ float get(S v) { return v; }
  static __device__ __forceinline__ S put(float v) { return v; }
};

struct BF16 {
  typedef unsigned short S;  // bf16 bits
  static __device__ __forceinline__ float get(S v) {
    return __uint_as_float(uint32_t(v) << 16);
  }
  static __device__ __forceinline__ S put(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};

template <class X, class A>
__global__ void __launch_bounds__(kThreads)
ring_rs_kernel(const typename X::S* x, typename A::S* acc,
               typename X::S* out, int* flags, long long E, int tile,
               int n_tiles) {
  typedef typename X::S XS;
  typedef typename A::S AS;
  const int n = gridDim.y, me = blockIdx.y;
  const int left = (me + n - 1) % n, right = (me + 1) % n;
  const int nf = 3 * n_tiles;  // flags of a rank: [tile][credit, slot 0, slot 1]
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long lo = (long long)t * tile;
    const long long cnt = min((long long)tile, E - lo);
    int* mine = flags + size_t(me) * nf + 3 * t;
    int* left_credit = flags + size_t(left) * nf + 3 * t;
    int* right_arrival = flags + size_t(right) * nf + 3 * t + 1;
    const XS* xm = x + size_t(me) * n * E + lo;  // chunk c at xm + c * E
    AS* slot[2] = {acc + size_t(me) * 2 * E + lo,
                   acc + (size_t(me) * 2 + 1) * E + lo};
    AS* peer[2] = {acc + size_t(right) * 2 * E + lo,
                   acc + (size_t(right) * 2 + 1) * E + lo};
    XS* o = out + size_t(me) * E + lo;
    const XS* first = xm + size_t((me + n - 1) % n) * E;

    if (n == 1) {  // no ring step, no credit
      for (long long i = threadIdx.x; i < cnt; i += kThreads)
        o[i] = X::put(A::get(A::put(X::get(first[i]))));
      continue;
    }
    // my slot 1 is free for the left's step 0
    shmem::signal_add(left_credit, 1);
    for (long long i = threadIdx.x; i < cnt; i += kThreads)
      slot[0][i] = A::put(X::get(first[i]));
    for (int s = 0; s < n - 1; ++s) {
      const int cur = s & 1, nxt = cur ^ 1;
      // one credit: the right's slot nxt is free (the wait's
      // __syncthreads also orders this block's stores into slot cur
      // before the put reads them)
      shmem::signal_wait_until(mine, shmem::kGe, s + 1, "ring_reduce_scatter",
                               me, 3 * t);
      shmem::putmem_block(peer[nxt], slot[cur], cnt);
      shmem::signal_add(right_arrival + nxt, 1);
      // the send is done: slot cur takes the left's step s + 1
      if (s + 1 <= n - 2) shmem::signal_add(left_credit, 1);
      shmem::signal_wait_until(mine + 1 + nxt, shmem::kEq, s / 2 + 1,
                               "ring_reduce_scatter", me, 3 * t + 1 + nxt);
      const XS* own = xm + size_t(((me - s - 2) % n + n) % n) * E;
      if (s == n - 2) {
        for (long long i = threadIdx.x; i < cnt; i += kThreads)
          o[i] = X::put(A::get(A::put(A::get(__ldcg(slot[nxt] + i)) +
                                      A::get(A::put(X::get(own[i]))))));
      } else {
        for (long long i = threadIdx.x; i < cnt; i += kThreads)
          slot[nxt][i] = A::put(A::get(__ldcg(slot[nxt] + i)) +
                                A::get(A::put(X::get(own[i]))));
      }
    }
  }
}

template <class X, class A>
cudaError_t launch(const void* x, void* acc, void* out, int* flags, int n,
                   long long E, int tile, int* info, cudaStream_t st) {
  const int n_tiles = int((E + tile - 1) / tile);
  return shmem::launch_world(
      ring_rs_kernel<X, A>, n, n_tiles, kThreads, 0, st, info,
      static_cast<const typename X::S*>(x), static_cast<typename A::S*>(acc),
      static_cast<typename X::S*>(out), flags, E, tile, n_tiles);
}

template <class X>
cudaError_t launch_acc(int acc_dtype, const void* x, void* acc, void* out,
                       int* flags, int n, long long E, int tile, int* info,
                       cudaStream_t st) {
  if (acc_dtype == 0)
    return launch<X, F32>(x, acc, out, flags, n, E, tile, info, st);
  if (acc_dtype == 1)
    return launch<X, BF16>(x, acc, out, flags, n, E, tile, info, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// Tiles of a chunk of E elements; the launch needs 3 flags a tile a rank.
extern "C" int rs_tile_count(long long E, int tile) {
  return int((E + tile - 1) / tile);
}

// x (n, n * E), acc (n, 2, E) in the accumulation dtype, out (n, E);
// flags (n, 3 * rs_tile_count) zeroed. dtypes: 0 = float32, 1 =
// bfloat16. info: 3 ints (see launch_world). Returns a cudaError_t.
extern "C" int rs_launch(const void* x, void* acc, void* out, void* flags,
                         int n, long long E, int tile, int dtype,
                         int acc_dtype, void* info, void* stream) {
  if (n < 1 || E < 1 || tile < 1) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* fl = static_cast<int*>(flags);
  int* inf = static_cast<int*>(info);
  if (dtype == 0)
    return int(launch_acc<F32>(acc_dtype, x, acc, out, fl, n, E, tile, inf, st));
  if (dtype == 1)
    return int(launch_acc<BF16>(acc_dtype, x, acc, out, fl, n, E, tile, inf,
                                st));
  return int(cudaErrorInvalidValue);
}

extern "C" const char* rs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
