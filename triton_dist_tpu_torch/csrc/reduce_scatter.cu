// Credit-flow ring ReduceScatter over the virtual world of one card,
// sm_90a.
//
// Two kernels: `ring_rs_kernel` (native wire, below) and
// `ring_rs_wire_kernel` (the quantized wire, after it).
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
#include <cuda_fp16.h>
#include <cuda_fp8.h>
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


// ---- the quantized wire: ring_rs_wire_kernel -----------------------------
//
// Replaces the Pallas TPU kernel `_ring_rs_wire_kernel` reached through
// `_ring_rs_quantized` in triton_dist_tpu/kernels/reduce_scatter.py. The
// protocol is ring_rs_kernel's, unchanged: two slots a rank, a credit
// toward the left, an arrival counter per slot, fresh flags each launch.
// What the slots carry changes: the block-scaled wire image of a row
// (wire/codec.py encode_rows), kw int8 columns, instead of the row.
//   - first: rank me loads its contribution to chunk (me - 1) mod n in
//     f32 and encodes it into slot 0 (the send edge);
//   - at step s it takes a credit, puts slot s % 2 into the right's slot
//     (s + 1) % 2, signals its arrival, grants the left a credit (not
//     after the last step), waits for the left's step-s arrival, and for
//     each row decodes the delivered image and adds its own contribution
//     to chunk (me - s - 2) mod n in f32 (the consume edge); it
//     re-encodes the sum into the slot, or, at the final arrival (s =
//     n - 2), stores it in the output dtype without a re-encode.
// That is the fold of wire/numerics.py simulate_ring_rs and of the plain
// version (kernels/reduce_scatter.py ring_reduce_scatter_wire_plain).
//
// Tiled by rows, not columns: a row's scale needs the amax of the whole
// row (block = None) or of a whole scale block, so each tile is a set of
// whole rows of the chunk and runs its own ring (its own credit and
// arrival counters, flags (n, 3 * tiles)); block j of every rank takes
// the same tiles in the same order. A block works on one row at a time,
// its f32 values staged in shared memory: the amax (one block-wide
// reduction a row, or one warp a scale block), then the encode.
//
// The codec, bit for bit: s = max(amax / FMAX, 1e-12f) with IEEE
// division (448 for fp8, 127 for int8), then q = x / s divided, not
// multiplied by a reciprocal; fp8 by __nv_cvt_float_to_fp8 (nearest
// even, saturating: the codec never exceeds 448 (1 + 2^-23)), int8 by
// rintf (half to even, as torch.round and jnp.round) clamped to +-127.
// The scales' bytes follow the payload little-endian, then the checksum
// (the int32 sum of the signed payload and scale bytes), then zeros to
// kw. Decode is float(q) * s; the consume edge's add is __fadd_rn of
// __fmul_rn, which the compiler cannot contract into an FMA (the JAX
// and torch folds round the product first). No fast math (_build.py).
//
// What bounds it on an H100: bytes. Each rank reads its n chunks (n * m
// * K input elements) and writes m * K outputs; each of the n - 1 hops
// puts m * kw bytes a rank into a peer slot (read once, written once).
// At (512, 4096) bf16, n = 4: 16.8 MB in, 4.2 MB out, 12.9 MB of hops,
// 0.010 ms at 3.35 TB/s. As in the native ring, the n - 1 serial flag
// handshakes a tile dominate; the per-row amax and encode add to them.

constexpr int kWarps = kThreads / 32;

struct WireFmt {
  int blk;       // elements a scale block (K for one scale a row)
  int nb;        // scale blocks a row
  int checksum;  // the checksum word follows the scales
  int kw;        // bytes an image row
};

template <bool FP8>
__device__ __forceinline__ signed char wire_quant(float v) {
  if (FP8)
    return static_cast<signed char>(
        __nv_cvt_float_to_fp8(v, __NV_SATFINITE, __NV_E4M3));
  const float r = fminf(fmaxf(rintf(v), -127.f), 127.f);
  return static_cast<signed char>(static_cast<int>(r));
}

template <bool FP8>
__device__ __forceinline__ float wire_dequant(signed char q) {
  if (FP8) {
    const __half_raw h = __nv_cvt_fp8_to_halfraw(
        static_cast<__nv_fp8_storage_t>(q), __NV_E4M3);
    return __half2float(__half(h));
  }
  return static_cast<float>(q);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
  return v;
}

// block-wide reductions through red[kWarps]; every thread gets the result
__device__ __forceinline__ float block_max(float v, float* red) {
  v = warp_max(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < kWarps; ++w) r = fmaxf(r, red[w]);
  __syncthreads();
  return r;
}

__device__ __forceinline__ int block_sum(int v, int* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int r = 0;
  for (int w = 0; w < kWarps; ++w) r += red[w];
  __syncthreads();
  return r;
}

// Encode the f32 row v[K] (shared memory) into the image row dst (kw
// bytes); sc[nb] and red are shared scratch.
template <bool FP8>
__device__ void encode_row(const float* v, int K, const WireFmt& f,
                           float* sc, float* red, signed char* dst) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float fmax = FP8 ? 448.f : 127.f;
  __syncthreads();  // v is complete
  if (f.nb == 1) {
    float mx = 0.f;
    for (int i = tid; i < K; i += kThreads) mx = fmaxf(mx, fabsf(v[i]));
    mx = block_max(mx, red);
    if (tid == 0) sc[0] = fmaxf(mx / fmax, 1e-12f);
  } else {
    for (int b = warp; b < f.nb; b += kWarps) {
      float mx = 0.f;
      for (int i = lane; i < f.blk; i += 32)
        mx = fmaxf(mx, fabsf(v[b * f.blk + i]));
      mx = warp_max(mx);
      if (lane == 0) sc[b] = fmaxf(mx / fmax, 1e-12f);
    }
  }
  __syncthreads();
  int sum = 0;
  for (int i = tid; i < K; i += kThreads) {
    const signed char q = wire_quant<FP8>(v[i] / sc[i / f.blk]);
    dst[i] = q;
    sum += q;
  }
  const signed char* sb = reinterpret_cast<const signed char*>(sc);
  for (int j = tid; j < 4 * f.nb; j += kThreads) {
    dst[K + j] = sb[j];
    sum += sb[j];
  }
  int used = K + 4 * f.nb;
  if (f.checksum) {
    sum = block_sum(sum, reinterpret_cast<int*>(red));
    if (tid < 4)
      dst[used + tid] =
          static_cast<signed char>(static_cast<unsigned>(sum) >> (8 * tid));
    used += 4;
  }
  for (int j = used + tid; j < f.kw; j += kThreads) dst[j] = 0;
  __syncthreads();  // sc and v are free again
}

// The consume edge: v[i] = decode(src)[i] + own[i] in f32, src an image
// row another rank delivered (read past L1 with __ldcg).
template <bool FP8, class X>
__device__ void fold_row(const signed char* src, const typename X::S* own,
                         int K, const WireFmt& f, float* sc, float* v) {
  for (int b = threadIdx.x; b < f.nb; b += kThreads) {
    uint32_t u = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      u |= uint32_t(static_cast<unsigned char>(__ldcg(src + K + 4 * b + j)))
           << (8 * j);
    sc[b] = __uint_as_float(u);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < K; i += kThreads)
    v[i] = __fadd_rn(__fmul_rn(wire_dequant<FP8>(__ldcg(src + i)),
                               sc[i / f.blk]),
                     X::get(own[i]));
  __syncthreads();
}

template <bool FP8, class X, class O>
__global__ void __launch_bounds__(kThreads)
ring_rs_wire_kernel(const typename X::S* x, signed char* slots,
                    typename O::S* out, int* flags, int m, int K, WireFmt f,
                    int rows_per_tile, int n_tiles, int straggle_rank,
                    long long straggle_ns) {
  typedef typename X::S XS;
  extern __shared__ float wsm[];
  float* v = wsm;          // one f32 row
  float* sc = v + K;       // its scales
  float* red = sc + f.nb;  // reduction scratch
  const int n = gridDim.y, me = blockIdx.y;
  const int left = (me + n - 1) % n, right = (me + 1) % n;
  const int nf = 3 * n_tiles;  // [tile][credit, slot 0, slot 1]
  const size_t kw = f.kw;
  shmem::straggler_delay(straggle_rank, me, straggle_ns);
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int r0 = t * rows_per_tile;
    const int rows = min(rows_per_tile, m - r0);
    int* mine = flags + size_t(me) * nf + 3 * t;
    int* left_credit = flags + size_t(left) * nf + 3 * t;
    int* right_arrival = flags + size_t(right) * nf + 3 * t + 1;
    // rank me's row r0 + r of chunk c
    auto own = [&](int c, int r) {
      return x + ((size_t(me) * n + c) * m + r0 + r) * K;
    };
    signed char* slot[2] = {slots + ((size_t(me) * 2) * m + r0) * kw,
                            slots + ((size_t(me) * 2 + 1) * m + r0) * kw};
    signed char* peer[2] = {slots + ((size_t(right) * 2) * m + r0) * kw,
                            slots + ((size_t(right) * 2 + 1) * m + r0) * kw};
    typename O::S* o = out + (size_t(me) * m + r0) * K;

    if (n == 1) {  // no ring step, no credit: x through f32
      for (int r = 0; r < rows; ++r) {
        const XS* src = own(0, r);
        for (int i = threadIdx.x; i < K; i += kThreads)
          o[size_t(r) * K + i] = O::put(X::get(src[i]));
      }
      continue;
    }
    // my slot 1 is free for the left's step 0
    shmem::signal_add(left_credit, 1);
    for (int r = 0; r < rows; ++r) {  // the send edge
      const XS* src = own((me + n - 1) % n, r);
      for (int i = threadIdx.x; i < K; i += kThreads) v[i] = X::get(src[i]);
      encode_row<FP8>(v, K, f, sc, red, slot[0] + r * kw);
    }
    for (int s = 0; s < n - 1; ++s) {
      const int cur = s & 1, nxt = cur ^ 1;
      shmem::signal_wait_until(mine, shmem::kGe, s + 1, "ring_rs_wire", me,
                               3 * t);
      shmem::copy_block(peer[nxt], slot[cur], (long long)rows * kw);
      shmem::signal_add(right_arrival + nxt, 1);
      if (s + 1 <= n - 2) shmem::signal_add(left_credit, 1);
      shmem::signal_wait_until(mine + 1 + nxt, shmem::kEq, s / 2 + 1,
                               "ring_rs_wire", me, 3 * t + 1 + nxt);
      const int c = ((me - s - 2) % n + n) % n;
      for (int r = 0; r < rows; ++r) {
        fold_row<FP8, X>(slot[nxt] + r * kw, own(c, r), K, f, sc, v);
        if (s == n - 2) {  // the final arrival: no re-encode
          for (int i = threadIdx.x; i < K; i += kThreads)
            o[size_t(r) * K + i] = O::put(v[i]);
        } else {
          encode_row<FP8>(v, K, f, sc, red, slot[nxt] + r * kw);
        }
      }
    }
  }
}

template <bool FP8, class X, class O>
cudaError_t launch_wire(const void* x, void* slots, void* out, int* flags,
                        int n, int m, int K, WireFmt f, int rows_per_tile,
                        int straggle_rank, long long straggle_ns, int* info,
                        cudaStream_t st) {
  const int n_tiles = (m + rows_per_tile - 1) / rows_per_tile;
  const size_t smem = sizeof(float) * (size_t(K) + f.nb + kWarps);
  return shmem::launch_world(
      ring_rs_wire_kernel<FP8, X, O>, n, n_tiles, kThreads, smem, st, info,
      static_cast<const typename X::S*>(x), static_cast<signed char*>(slots),
      static_cast<typename O::S*>(out), flags, m, K, f, rows_per_tile,
      n_tiles, straggle_rank, straggle_ns);
}

template <bool FP8, class X>
cudaError_t launch_wire_out(int out_dtype, const void* x, void* slots,
                            void* out, int* flags, int n, int m, int K,
                            WireFmt f, int rows_per_tile, int straggle_rank,
                            long long straggle_ns, int* info,
                            cudaStream_t st) {
  if (out_dtype == 0)
    return launch_wire<FP8, X, F32>(x, slots, out, flags, n, m, K, f,
                                    rows_per_tile, straggle_rank,
                                    straggle_ns, info, st);
  if (out_dtype == 1)
    return launch_wire<FP8, X, BF16>(x, slots, out, flags, n, m, K, f,
                                     rows_per_tile, straggle_rank,
                                     straggle_ns, info, st);
  return cudaErrorInvalidValue;
}

template <bool FP8>
cudaError_t launch_wire_in(int dtype, int out_dtype, const void* x,
                           void* slots, void* out, int* flags, int n, int m,
                           int K, WireFmt f, int rows_per_tile,
                           int straggle_rank, long long straggle_ns,
                           int* info, cudaStream_t st) {
  if (dtype == 0)
    return launch_wire_out<FP8, F32>(out_dtype, x, slots, out, flags, n, m,
                                     K, f, rows_per_tile, straggle_rank,
                                     straggle_ns, info, st);
  if (dtype == 1)
    return launch_wire_out<FP8, BF16>(out_dtype, x, slots, out, flags, n, m,
                                      K, f, rows_per_tile, straggle_rank,
                                      straggle_ns, info, st);
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

// The quantized ring: x (n, n * m, K) rank-stacked, slots (n, 2, m, kw)
// int8, out (n, m, K); flags (n, 3 * ceil(m / rows_per_tile)) zeroed.
// fp8: 1 = e4m3 payload, 0 = int8; blk elements a scale block (nb * blk
// = K); checksum: the image carries the checksum word; kw bytes an image
// row (a multiple of 16). dtype, out_dtype: 0 = float32, 1 = bfloat16.
// straggle_rank's blocks stall straggle_ns on entry (-1: none). info: 3
// ints (see launch_world). Returns a cudaError_t.
extern "C" int rs_wire_launch(const void* x, void* slots, void* out,
                              void* flags, int n, int m, int K, int fp8,
                              int blk, int nb, int checksum, int kw,
                              int rows_per_tile, int dtype, int out_dtype,
                              int straggle_rank, long long straggle_ns,
                              void* info, void* stream) {
  if (n < 1 || m < 1 || K < 1 || blk < 1 || nb < 1 || blk * nb != K ||
      kw < K + 4 * nb + 4 * (checksum != 0) || kw % 16 || rows_per_tile < 1)
    return int(cudaErrorInvalidValue);
  const WireFmt f{blk, nb, checksum != 0, kw};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* fl = static_cast<int*>(flags);
  int* inf = static_cast<int*>(info);
  if (fp8)
    return int(launch_wire_in<true>(dtype, out_dtype, x, slots, out, fl, n,
                                    m, K, f, rows_per_tile, straggle_rank,
                                    straggle_ns, inf, st));
  return int(launch_wire_in<false>(dtype, out_dtype, x, slots, out, fl, n, m,
                                   K, f, rows_per_tile, straggle_rank,
                                   straggle_ns, inf, st));
}

extern "C" const char* rs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
