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
//     target of the left's step 0, is free) and takes its contribution
//     to chunk (me - 1) mod n as slot 0;
//   - at step s = 0 .. n-2 it takes one credit (the right neighbour's
//     slot (s + 1) % 2 is free), puts slot s % 2 into that slot and
//     signals the right's arrival counter of that slot; the send done,
//     slot s % 2 is free again, and unless this was the last step it
//     grants the left a credit; it waits for the left's step-s arrival
//     in its slot (s + 1) % 2 and adds its own contribution to chunk
//     (me - s - 2) mod n to that slot;
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
// rounded bf16 add, element by element, never a packed bf16 add). The
// output is the last sum converted to the input dtype. The plain version
// (kernels/reduce_scatter.py) folds in the same order with the same
// roundings, so the two agree bitwise.
//
// Launch design. The chunk's E elements are cut into tiles of 256
// threads x 8 elements x U (U = 1, 2, 4: 2048, 4096 or 8192 elements,
// the wrapper's _ring_plan), and each tile runs its own ring with its
// own credit and arrival counters (flags (n, 3 * tiles)); block j of
// every rank takes the same tiles in the same order. All n ranks run in
// one cooperative launch (shmem.cuh launch_world), every block resident.
//
// The data path. Thread i owns the same U units of 8 elements of its
// tile at every rank and every step, so what it puts is what it folded:
// slot s % 2 of the protocol lives in its registers (U x 8 values of A),
// and the put stores them straight into the right's slot, 16 bytes at a
// time. A rank's own slots are written only by its left neighbour's puts
// and read only by its fold, which loads the delivered units and its own
// contribution (issued before the arrival wait, so they are in flight
// across it) as 16-byte words, adds element by element in f32 with the
// roundings above, and keeps the sums in registers. The credit still
// guards the peer's slot exactly as above: a slot is free once its fold
// has read it, earlier than the grant says. Where E is not a multiple of
// 8 or a base address not 16-byte aligned, the same kernel moves every
// unit one element at a time, with the same roundings and the same bits.
// The waits poll with a backoff capped at kRingSleepNs, and keep the 5 s
// bound, the printed message and the trap of shmem::spin_until.
//
// Flags that each rank leaves at zero. The flag pool is persistent (the
// wrapper keeps it across calls, zeroed once when made). After rank me's
// arrival wait at step n - 2 of a tile, its credit counter has received
// all n - 1 grants of this launch (its credit wait at step n - 2 was for
// n - 1 of them) and its two arrival counters all n - 1 arrivals (the
// wait at step n - 3 saw the other slot's last one), and no peer adds to
// them again in this launch. So the thread that made those waits stores
// 0 to the tile's three flags (release), and the next launch on the
// stream, which starts after this one ends, finds them at zero. No
// host-side epoch is needed, so a captured graph replays it. A trap
// leaves them set; the context is lost with it.
//
// What bounds it on an H100: bytes. Each rank reads its n chunks once
// and writes one; the ring moves n - 1 chunk-sized puts a rank, each
// written into a peer's slot and read once by its fold. At (4, 512,
// 2048) bf16 the bound is 10.5 MB, 3.1 us at 3.35 TB/s; the n - 1 hops
// of a tile are serial (a credit and an arrival round trip each), so a
// tile's latency, not the bytes, sets the time, and the tiles of all
// ranks fill the card.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "shmem.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnit = 8;  // elements of a native unit: 16 bytes of bf16
// the ring's waits: hops are microseconds apart, so poll often
constexpr unsigned kRingSleepNs = 64;

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

// N elements of storage type S, as registers and as 16-byte words
template <class S, int N>
union Pack {
  S e[N];
  uint4 w[sizeof(S) * N / 16];
};

// The N elements at p into r: 16-byte words when vec (p 16-byte aligned,
// all N in range), else one at a time, those at or past `left` as zero.
// CG: past L1 (data another rank delivered); else the read-only path.
template <bool CG, class S, int N>
__device__ __forceinline__ void load_pack(Pack<S, N>& r, const S* p, bool vec,
                                          long long left) {
  if (vec) {
    const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int k = 0; k < int(sizeof(r.w) / 16); ++k)
      r.w[k] = CG ? __ldcg(q + k) : __ldg(q + k);
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e)
      r.e[e] = e < left ? (CG ? __ldcg(p + e) : __ldg(p + e)) : S(0);
  }
}

template <class S, int N>
__device__ __forceinline__ void store_pack(S* p, const Pack<S, N>& r,
                                           bool vec, long long left) {
  if (vec) {
    uint4* q = reinterpret_cast<uint4*>(p);
#pragma unroll
    for (int k = 0; k < int(sizeof(r.w) / 16); ++k) q[k] = r.w[k];
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e)
      if (e < left) p[e] = r.e[e];
  }
}

__device__ __forceinline__ void ring_wait(const int* flag, shmem::Cmp cmp,
                                          int v, const char* kernel,
                                          int rank, int index) {
  shmem::signal_wait_until(flag, cmp, v, kernel, rank, index, kRingSleepNs);
}

// After the put: publish this block's stores into the right's slot on
// its arrival counter and, unless this was the last step, grant the left
// a credit. shmem.cuh's rule without its __threadfence (fence.sc): the
// block barrier orders every thread's stores before thread 0's
// red.release.gpu, and a release is cumulative over what the barrier
// ordered before it, so the reader's acquire sees them (CUTLASS's
// barrier arrive is the same); 0.8-1.9 us less a call on an H100
// (PERF.md).
__device__ __forceinline__ void ring_signal(int* right_arrival,
                                            int* left_credit, bool grant) {
  __syncthreads();
  if (threadIdx.x == 0) {
    shmem::atom_add_release(right_arrival, 1);
    if (grant) shmem::atom_add_release(left_credit, 1);
  }
}

// Every grant and arrival of the tile's ring has been waited for (by
// thread 0), and no peer adds to these flags again in this launch:
// leave the tile's three flags at zero for the next launch.
__device__ __forceinline__ void ring_reset(int* mine) {
  if (threadIdx.x == 0) {
    shmem::st_release(mine, 0);
    shmem::st_release(mine + 1, 0);
    shmem::st_release(mine + 2, 0);
  }
}

// first element of this thread's unit u in a tile of kThreads x kUnit x U
__device__ __forceinline__ long long unit_at(int u) {
  return (static_cast<long long>(threadIdx.x) + static_cast<long long>(u) *
          kThreads) * kUnit;
}

template <int U, class S>
__device__ __forceinline__ void load_units(Pack<S, kUnit> (&r)[U],
                                           const S* src, long long cnt,
                                           bool vec) {
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (unit_at(u) < cnt)
      load_pack<false>(r[u], src + unit_at(u), vec, cnt - unit_at(u));
}

// registers enough for 4 blocks an SM while a thread's slot share is at
// most 4 words (the wrapper's plans), 2 beyond
template <class A, int U>
struct RingBlocks {
  static constexpr int value = U * sizeof(typename A::S) <= 8 ? 4 : 2;
};

template <class X, class A, int U>
__global__ void __launch_bounds__(kThreads, RingBlocks<A, U>::value)
ring_rs_kernel(const typename X::S* x, typename A::S* acc,
               typename X::S* out, int* flags, long long E, int n_tiles,
               int vec, int straggle_rank, long long straggle_ns) {
  typedef typename X::S XS;
  typedef typename A::S AS;
  constexpr long long kTile = static_cast<long long>(kThreads) * kUnit * U;
  const int n = gridDim.y, me = blockIdx.y;
  const int left = (me + n - 1) % n, right = (me + 1) % n;
  const int nf = 3 * n_tiles;  // flags of a rank: [tile][credit, slot 0, slot 1]
  shmem::straggler_delay(straggle_rank, me, straggle_ns);
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long lo = static_cast<long long>(t) * kTile;
    const long long cnt = min(kTile, E - lo);
    int* mine = flags + size_t(me) * nf + 3 * t;
    int* left_credit = flags + size_t(left) * nf + 3 * t;
    int* right_arrival = flags + size_t(right) * nf + 3 * t + 1;
    const XS* xm = x + size_t(me) * n * E + lo;  // chunk c at xm + c * E
    const AS* slots = acc + size_t(me) * 2 * E + lo;  // slot k at + k * E
    AS* peer = acc + size_t(right) * 2 * E + lo;
    XS* o = out + size_t(me) * E + lo;
    Pack<XS, kUnit> own[U];
    Pack<AS, kUnit> r[U];  // slot s % 2 of the protocol

    load_units<U>(own, xm + size_t((me + n - 1) % n) * E, cnt, vec);
    if (n == 1) {  // no ring step, no credit
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (unit_at(u) >= cnt) continue;
        Pack<XS, kUnit> y;
#pragma unroll
        for (int e = 0; e < kUnit; ++e)
          y.e[e] = X::put(A::get(A::put(X::get(own[u].e[e]))));
        store_pack(o + unit_at(u), y, vec, cnt - unit_at(u));
      }
      continue;
    }
    // my slot 1 is free for the left's step 0
    shmem::signal_add(left_credit, 1);
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int e = 0; e < kUnit; ++e) r[u].e[e] = A::put(X::get(own[u].e[e]));
    for (int s = 0; s < n - 1; ++s) {
      const int nxt = (s & 1) ^ 1;
      // one credit: the right's slot nxt is free
      ring_wait(mine, shmem::kGe, s + 1, "ring_reduce_scatter", me, 3 * t);
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (unit_at(u) < cnt)
          store_pack(peer + nxt * E + unit_at(u), r[u], vec,
                     cnt - unit_at(u));
      // the send is done: slot cur takes the left's step s + 1
      ring_signal(right_arrival + nxt, left_credit, s + 1 <= n - 2);
      load_units<U>(own, xm + size_t(((me - s - 2) % n + n) % n) * E, cnt,
                    vec);
      ring_wait(mine + 1 + nxt, shmem::kEq, s / 2 + 1, "ring_reduce_scatter",
                me, 3 * t + 1 + nxt);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (unit_at(u) >= cnt) continue;
        load_pack<true>(r[u], slots + nxt * E + unit_at(u), vec,
                        cnt - unit_at(u));
#pragma unroll
        for (int e = 0; e < kUnit; ++e)
          r[u].e[e] = A::put(A::get(r[u].e[e]) +
                             A::get(A::put(X::get(own[u].e[e]))));
      }
    }
    ring_reset(mine);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (unit_at(u) >= cnt) continue;
      Pack<XS, kUnit> y;
#pragma unroll
      for (int e = 0; e < kUnit; ++e) y.e[e] = X::put(A::get(r[u].e[e]));
      store_pack(o + unit_at(u), y, vec, cnt - unit_at(u));
    }
  }
}

template <class X, class A, int U>
cudaError_t launch_u(const void* x, void* acc, void* out, int* flags, int n,
                     long long E, int vec, int straggle_rank,
                     long long straggle_ns, int* info, cudaStream_t st) {
  constexpr long long kTile = static_cast<long long>(kThreads) * kUnit * U;
  const int n_tiles = int((E + kTile - 1) / kTile);
  return shmem::launch_world(
      ring_rs_kernel<X, A, U>, n, n_tiles, kThreads, 0, st, info,
      static_cast<const typename X::S*>(x), static_cast<typename A::S*>(acc),
      static_cast<typename X::S*>(out), flags, E, n_tiles, vec,
      straggle_rank, straggle_ns);
}

template <class X, class A>
cudaError_t launch(const void* x, void* acc, void* out, int* flags, int n,
                   long long E, int tile, int vec, int straggle_rank,
                   long long straggle_ns, int* info, cudaStream_t st) {
  switch (tile) {
    case kThreads * kUnit:
      return launch_u<X, A, 1>(x, acc, out, flags, n, E, vec, straggle_rank,
                               straggle_ns, info, st);
    case 2 * kThreads * kUnit:
      return launch_u<X, A, 2>(x, acc, out, flags, n, E, vec, straggle_rank,
                               straggle_ns, info, st);
    case 4 * kThreads * kUnit:
      return launch_u<X, A, 4>(x, acc, out, flags, n, E, vec, straggle_rank,
                               straggle_ns, info, st);
  }
  return cudaErrorInvalidValue;
}

template <class X>
cudaError_t launch_acc(int acc_dtype, const void* x, void* acc, void* out,
                       int* flags, int n, long long E, int tile, int vec,
                       int straggle_rank, long long straggle_ns, int* info,
                       cudaStream_t st) {
  if (acc_dtype == 0)
    return launch<X, F32>(x, acc, out, flags, n, E, tile, vec, straggle_rank,
                          straggle_ns, info, st);
  if (acc_dtype == 1)
    return launch<X, BF16>(x, acc, out, flags, n, E, tile, vec,
                           straggle_rank, straggle_ns, info, st);
  return cudaErrorInvalidValue;
}


// ---- the quantized wire: ring_rs_wire_kernel -----------------------------
//
// Replaces the Pallas TPU kernel `_ring_rs_wire_kernel` reached through
// `_ring_rs_quantized` in triton_dist_tpu/kernels/reduce_scatter.py. The
// protocol is ring_rs_kernel's, unchanged: two slots a rank, a credit
// toward the left, an arrival counter per slot, each rank's flags left
// at zero after its last wait (the argument above). What the slots carry
// changes: the block-scaled wire image of a row (wire/codec.py
// encode_rows), kw int8 columns, instead of the row.
//   - first: rank me loads its contribution to chunk (me - 1) mod n in
//     f32 and encodes it (the send edge);
//   - at step s it takes a credit, puts its image into the right's slot
//     (s + 1) % 2, signals its arrival, grants the left a credit (not
//     after the last step), waits for the left's step-s arrival, and for
//     each row decodes the delivered image and adds its own contribution
//     to chunk (me - s - 2) mod n in f32 (the consume edge); it
//     re-encodes the sum, or, at the final arrival (s = n - 2), stores it
//     in the output dtype without a re-encode.
// That is the fold of wire/numerics.py simulate_ring_rs and of the plain
// version (kernels/reduce_scatter.py ring_reduce_scatter_wire_plain).
//
// Tiled by rows, not columns: a row's scale needs the amax of the whole
// row (block = None) or of a whole scale block, so each tile is a set of
// whole rows of the chunk and runs its own ring (flags (n, 3 * tiles));
// block j of every rank takes the same tiles in the same order. Two row
// forms, by the wrapper's _wire_plan:
//   - in registers (warps > 0; K and the scale block multiples of 16,
//     K <= 16 x kWireU x 32 x warps, 16-byte aligned bases): a row lives
//     on a group of `warps` warps, each thread holding at most kWireU
//     units of 16 elements, loaded as 16-byte words; a tile is one row a
//     group, so a block's rows go in parallel. The amax is a warp-shuffle
//     reduction (one scale a row) or one shared atomicMax a unit (scale
//     blocks), joined by one shared-memory exchange of the group (a
//     named barrier, no block barrier); the checksum likewise. As in the
//     native ring, the encoded image stays in registers and the put
//     stores it, 16 bytes a word, straight into the right's slot.
//   - staged (warps = 0: any other row up to 48 Ki elements): a block
//     works on one row at a time, its f32 values staged in shared memory
//     (a block-wide amax), the image encoded into the rank's own slot and
//     put with shmem::copy_block.
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
// puts m * kw bytes a rank into a peer slot (written once, read once).
// At (512, 4096) bf16, n = 4: 16.8 MB in, 4.2 MB out, 12.9 MB of hops,
// 0.010 ms at 3.35 TB/s. As in the native ring, the n - 1 serial hops of
// a tile set its latency; the codec adds a group exchange a hop.

constexpr int kWarps = kThreads / 32;
constexpr int kWireUnit = 16;  // elements of a wire unit: 16 image bytes
constexpr int kWireU = 2;      // units a thread holds at most

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

// the scale of a block whose amax is `mx`
template <bool FP8>
__device__ __forceinline__ float wire_scale(float mx) {
  return fmaxf(mx / (FP8 ? 448.f : 127.f), 1e-12f);
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

// the signed sum of the four bytes of a scale, for the checksum
__device__ __forceinline__ int byte_sum(float s) {
  const uint32_t u = __float_as_uint(s);
  int sum = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) sum += static_cast<signed char>(u >> (8 * k));
  return sum;
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

// -- the staged row: a block, its f32 values in shared memory --------------

// Encode the f32 row v[K] (shared memory) into the image row dst (kw
// bytes); sc[nb] and red are shared scratch.
template <bool FP8>
__device__ void encode_row(const float* v, int K, const WireFmt& f,
                           float* sc, float* red, signed char* dst) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  __syncthreads();  // v is complete
  if (f.nb == 1) {
    float mx = 0.f;
    for (int i = tid; i < K; i += kThreads) mx = fmaxf(mx, fabsf(v[i]));
    mx = block_max(mx, red);
    if (tid == 0) sc[0] = wire_scale<FP8>(mx);
  } else {
    for (int b = warp; b < f.nb; b += kWarps) {
      float mx = 0.f;
      for (int i = lane; i < f.blk; i += 32)
        mx = fmaxf(mx, fabsf(v[b * f.blk + i]));
      mx = warp_max(mx);
      if (lane == 0) sc[b] = wire_scale<FP8>(mx);
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

// -- the row in registers: a group of warps ---------------------------------

// The threads of one row: `warps` warps (T = 32 x warps threads, this one
// tg of them), group `id` of the block; gsm its shared words: [0, nb)
// the scale blocks' amax as int bits (non-negative floats order as their
// bits), [nb] the checksum. Unit j = tg + u T (u < kWireU) of the row is
// this thread's: elements [16 j, 16 j + 16).
struct Group {
  int id, warps, T, tg;
  int* gsm;
};

// the barrier of a group: a named barrier of its warps (one warp:
// __syncwarp)
__device__ __forceinline__ void group_sync(const Group& g) {
  if (g.warps == 1)
    __syncwarp();
  else
    asm volatile("bar.sync %0, %1;" ::"r"(g.id + 1), "r"(g.T) : "memory");
}

template <class S>
__device__ __forceinline__ void load_row(Pack<S, kWireUnit> (&r)[kWireU],
                                         const S* row, int K, const Group& g) {
#pragma unroll
  for (int u = 0; u < kWireU; ++u) {
    const int j = g.tg + u * g.T;
    if (j < K / kWireUnit)
      load_pack<false>(r[u], row + j * kWireUnit, true, kWireUnit);
  }
}

// Encode the row v into the payload words q and the group's amax and
// checksum words (the arithmetic of encode_row).
template <bool FP8>
__device__ __forceinline__ void encode_regs(
    const float (&v)[kWireU][kWireUnit], uint4 (&q)[kWireU], int K,
    const WireFmt& f, const Group& g) {
  const int nu = K / kWireUnit;
  group_sync(g);  // the last put's reads of gsm are done
  for (int b = g.tg; b <= f.nb; b += g.T) g.gsm[b] = 0;
  group_sync(g);
  float row_mx = 0.f;
#pragma unroll
  for (int u = 0; u < kWireU; ++u) {
    const int j = g.tg + u * g.T;
    if (j >= nu) continue;
    float mx = 0.f;
#pragma unroll
    for (int e = 0; e < kWireUnit; ++e) mx = fmaxf(mx, fabsf(v[u][e]));
    if (f.nb == 1)
      row_mx = fmaxf(row_mx, mx);
    else
      atomicMax(g.gsm + j * kWireUnit / f.blk, __float_as_int(mx));
  }
  if (f.nb == 1) {
    row_mx = warp_max(row_mx);
    if ((threadIdx.x & 31) == 0) atomicMax(g.gsm, __float_as_int(row_mx));
  }
  group_sync(g);
  int sum = 0;
#pragma unroll
  for (int u = 0; u < kWireU; ++u) {
    const int j = g.tg + u * g.T;
    if (j >= nu) continue;
    const float s = wire_scale<FP8>(__int_as_float(g.gsm[j * kWireUnit / f.blk]));
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int e = 0; e < kWireUnit; ++e) {
      const signed char c = wire_quant<FP8>(v[u][e] / s);
      sum += c;
      w[e >> 2] |= uint32_t(static_cast<unsigned char>(c)) << (8 * (e & 3));
    }
    q[u] = make_uint4(w[0], w[1], w[2], w[3]);
  }
  if (f.checksum) {
    for (int b = g.tg; b < f.nb; b += g.T)
      sum += byte_sum(wire_scale<FP8>(__int_as_float(g.gsm[b])));
    sum = warp_sum(sum);
    if ((threadIdx.x & 31) == 0) atomicAdd(g.gsm + f.nb, sum);
  }
}

// The group's image row into dst (a peer's slot row): the payload words,
// then the scale, checksum and zero words. The caller's block barrier
// orders it after the encode's shared atomics.
template <bool FP8>
__device__ __forceinline__ void put_regs(signed char* dst,
                                         const uint4 (&q)[kWireU], int K,
                                         const WireFmt& f, const Group& g) {
  uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int u = 0; u < kWireU; ++u) {
    const int j = g.tg + u * g.T;
    if (j < K / kWireUnit) d[j] = q[u];
  }
  int* tail = reinterpret_cast<int*>(dst + K);
  const int words = (f.kw - K) / 4;
  for (int w = g.tg; w < words; w += g.T)
    tail[w] = w < f.nb ? __float_as_int(wire_scale<FP8>(__int_as_float(g.gsm[w])))
              : (f.checksum && w == f.nb) ? g.gsm[f.nb]
                                          : 0;
}

// The consume edge in registers: v = decode(src) + own, src a delivered
// image row (read past L1), own this row's prefetched input units.
template <bool FP8, class X>
__device__ __forceinline__ void fold_regs(
    float (&v)[kWireU][kWireUnit], const signed char* src,
    const Pack<typename X::S, kWireUnit> (&own)[kWireU], int K,
    const WireFmt& f, const Group& g) {
  const uint4* s4 = reinterpret_cast<const uint4*>(src);
  const float* sc = reinterpret_cast<const float*>(src + K);
#pragma unroll
  for (int u = 0; u < kWireU; ++u) {
    const int j = g.tg + u * g.T;
    if (j >= K / kWireUnit) continue;
    Pack<signed char, kWireUnit> qi;
    qi.w[0] = __ldcg(s4 + j);
    const float s = __ldcg(sc + j * kWireUnit / f.blk);
#pragma unroll
    for (int e = 0; e < kWireUnit; ++e)
      v[u][e] = __fadd_rn(__fmul_rn(wire_dequant<FP8>(qi.e[e]), s),
                          X::get(own[u].e[e]));
  }
}

template <class O>
__device__ __forceinline__ void store_row(typename O::S* row,
                                          const float (&v)[kWireU][kWireUnit],
                                          int K, const Group& g) {
#pragma unroll
  for (int u = 0; u < kWireU; ++u) {
    const int j = g.tg + u * g.T;
    if (j >= K / kWireUnit) continue;
    Pack<typename O::S, kWireUnit> y;
#pragma unroll
    for (int e = 0; e < kWireUnit; ++e) y.e[e] = O::put(v[u][e]);
    store_pack(row + j * kWireUnit, y, true, kWireUnit);
  }
}

template <bool FP8, class X, class O>
__global__ void __launch_bounds__(kThreads, 2)
ring_rs_wire_kernel(const typename X::S* x, signed char* slots,
                    typename O::S* out, int* flags, int m, int K, WireFmt f,
                    int warps, int rows_per_tile, int n_tiles,
                    int straggle_rank, long long straggle_ns) {
  typedef typename X::S XS;
  extern __shared__ float wsm[];
  // the staged form: one f32 row, its scales, reduction scratch
  float* v_sm = wsm;
  float* sc = v_sm + K;
  float* red = sc + f.nb;
  const bool regs = warps > 0;
  Group g;
  g.warps = regs ? warps : kWarps;
  g.T = 32 * g.warps;
  g.id = threadIdx.x / g.T;
  g.tg = threadIdx.x % g.T;
  g.gsm = reinterpret_cast<int*>(wsm) + g.id * (f.nb + 1);
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
    // slot k of rank me at mine_slots + k * m * kw, of the right at peer
    signed char* mine_slots = slots + (size_t(me) * 2 * m + r0) * kw;
    signed char* peer = slots + (size_t(right) * 2 * m + r0) * kw;
    const size_t slot_bytes = size_t(m) * kw;
    typename O::S* o = out + (size_t(me) * m + r0) * K;

    if (n == 1) {  // no ring step, no credit: x through f32
      for (int r = 0; r < rows; ++r) {
        const XS* src = own(0, r);
        for (int i = threadIdx.x; i < K; i += kThreads)
          o[size_t(r) * K + i] = O::put(X::get(src[i]));
      }
      continue;
    }
    // the register form: this group's row of the tile is r0 + g.id
    const bool has_row = regs && g.id < rows;
    float v[kWireU][kWireUnit];
    uint4 q[kWireU];
    Pack<XS, kWireUnit> xin[kWireU];
    // my slot 1 is free for the left's step 0
    shmem::signal_add(left_credit, 1);
    if (has_row) {  // the send edge
      load_row(xin, own((me + n - 1) % n, g.id), K, g);
#pragma unroll
      for (int u = 0; u < kWireU; ++u)
#pragma unroll
        for (int e = 0; e < kWireUnit; ++e) v[u][e] = X::get(xin[u].e[e]);
      encode_regs<FP8>(v, q, K, f, g);
    } else if (!regs) {
      for (int r = 0; r < rows; ++r) {
        const XS* src = own((me + n - 1) % n, r);
        for (int i = threadIdx.x; i < K; i += kThreads)
          v_sm[i] = X::get(src[i]);
        encode_row<FP8>(v_sm, K, f, sc, red, mine_slots + r * kw);
      }
    }
    for (int s = 0; s < n - 1; ++s) {
      const int cur = s & 1, nxt = cur ^ 1;
      ring_wait(mine, shmem::kGe, s + 1, "ring_rs_wire", me, 3 * t);
      if (has_row)
        put_regs<FP8>(peer + nxt * slot_bytes + g.id * kw, q, K, f, g);
      else if (!regs)
        shmem::copy_block(peer + nxt * slot_bytes,
                          mine_slots + cur * slot_bytes, (long long)rows * kw);
      ring_signal(right_arrival + nxt, left_credit, s + 1 <= n - 2);
      const int c = ((me - s - 2) % n + n) % n;
      if (has_row) load_row(xin, own(c, g.id), K, g);
      ring_wait(mine + 1 + nxt, shmem::kEq, s / 2 + 1, "ring_rs_wire", me,
                3 * t + 1 + nxt);
      if (has_row) {
        fold_regs<FP8, X>(v, mine_slots + nxt * slot_bytes + g.id * kw, xin,
                          K, f, g);
        if (s == n - 2)  // the final arrival: no re-encode
          store_row<O>(o + size_t(g.id) * K, v, K, g);
        else
          encode_regs<FP8>(v, q, K, f, g);
      } else if (!regs) {
        for (int r = 0; r < rows; ++r) {
          fold_row<FP8, X>(mine_slots + nxt * slot_bytes + r * kw, own(c, r),
                           K, f, sc, v_sm);
          if (s == n - 2) {
            for (int i = threadIdx.x; i < K; i += kThreads)
              o[size_t(r) * K + i] = O::put(v_sm[i]);
          } else {
            encode_row<FP8>(v_sm, K, f, sc, red,
                            mine_slots + nxt * slot_bytes + r * kw);
          }
        }
      }
    }
    ring_reset(mine);
  }
}

template <bool FP8, class X, class O>
cudaError_t launch_wire(const void* x, void* slots, void* out, int* flags,
                        int n, int m, int K, WireFmt f, int warps,
                        int rows_per_tile, int straggle_rank,
                        long long straggle_ns, int* info, cudaStream_t st) {
  const int n_tiles = (m + rows_per_tile - 1) / rows_per_tile;
  const size_t smem =
      warps ? sizeof(int) * size_t(kWarps / warps) * (f.nb + 1)
            : sizeof(float) * (size_t(K) + f.nb + kWarps);
  return shmem::launch_world(
      ring_rs_wire_kernel<FP8, X, O>, n, n_tiles, kThreads, smem, st, info,
      static_cast<const typename X::S*>(x), static_cast<signed char*>(slots),
      static_cast<typename O::S*>(out), flags, m, K, f, warps, rows_per_tile,
      n_tiles, straggle_rank, straggle_ns);
}

template <bool FP8, class X>
cudaError_t launch_wire_out(int out_dtype, const void* x, void* slots,
                            void* out, int* flags, int n, int m, int K,
                            WireFmt f, int warps, int rows_per_tile,
                            int straggle_rank, long long straggle_ns,
                            int* info, cudaStream_t st) {
  if (out_dtype == 0)
    return launch_wire<FP8, X, F32>(x, slots, out, flags, n, m, K, f, warps,
                                    rows_per_tile, straggle_rank,
                                    straggle_ns, info, st);
  if (out_dtype == 1)
    return launch_wire<FP8, X, BF16>(x, slots, out, flags, n, m, K, f, warps,
                                     rows_per_tile, straggle_rank,
                                     straggle_ns, info, st);
  return cudaErrorInvalidValue;
}

template <bool FP8>
cudaError_t launch_wire_in(int dtype, int out_dtype, const void* x,
                           void* slots, void* out, int* flags, int n, int m,
                           int K, WireFmt f, int warps, int rows_per_tile,
                           int straggle_rank, long long straggle_ns,
                           int* info, cudaStream_t st) {
  if (dtype == 0)
    return launch_wire_out<FP8, F32>(out_dtype, x, slots, out, flags, n, m,
                                     K, f, warps, rows_per_tile,
                                     straggle_rank, straggle_ns, info, st);
  if (dtype == 1)
    return launch_wire_out<FP8, BF16>(out_dtype, x, slots, out, flags, n, m,
                                      K, f, warps, rows_per_tile,
                                      straggle_rank, straggle_ns, info, st);
  return cudaErrorInvalidValue;
}

bool aligned16(const void* a, const void* b, const void* c) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           reinterpret_cast<uintptr_t>(c)) & 15) == 0;
}

}  // namespace

// x (n, n * E), acc (n, 2, E) in the accumulation dtype, out (n, E);
// flags (n, 3 * ceil(E / tile)) at zero (the kernel leaves them so).
// tile: 2048, 4096 or 8192 elements. dtypes: 0 = float32, 1 = bfloat16.
// straggle_rank's blocks stall straggle_ns on entry (-1: none). info: 3
// ints (see launch_world). Returns a cudaError_t.
extern "C" int rs_launch(const void* x, void* acc, void* out, void* flags,
                         int n, long long E, int tile, int dtype,
                         int acc_dtype, int straggle_rank,
                         long long straggle_ns, void* info, void* stream) {
  if (n < 1 || E < 1) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* fl = static_cast<int*>(flags);
  int* inf = static_cast<int*>(info);
  const int vec = E % kUnit == 0 && aligned16(x, acc, out);
  if (dtype == 0)
    return int(launch_acc<F32>(acc_dtype, x, acc, out, fl, n, E, tile, vec,
                               straggle_rank, straggle_ns, inf, st));
  if (dtype == 1)
    return int(launch_acc<BF16>(acc_dtype, x, acc, out, fl, n, E, tile, vec,
                                straggle_rank, straggle_ns, inf, st));
  return int(cudaErrorInvalidValue);
}

// The quantized ring: x (n, n * m, K) rank-stacked, slots (n, 2, m, kw)
// int8, out (n, m, K); flags (n, 3 * ceil(m / rows_per_tile)) at zero
// (the kernel leaves them so). fp8: 1 = e4m3 payload, 0 = int8; blk
// elements a scale block (nb * blk = K); checksum: the image carries the
// checksum word; kw bytes an image row (a multiple of 16). warps: the
// warps of a row in registers (1, 2, 4 or 8; rows_per_tile = 8 / warps,
// K and blk multiples of 16, K <= 32 x 32 x warps), or 0 for the staged
// form (any rows_per_tile); misaligned bases take the staged form.
// dtype, out_dtype: 0 = float32, 1 = bfloat16. straggle_rank's blocks
// stall straggle_ns on entry (-1: none). info: 3 ints (see
// launch_world). Returns a cudaError_t.
extern "C" int rs_wire_launch(const void* x, void* slots, void* out,
                              void* flags, int n, int m, int K, int fp8,
                              int blk, int nb, int checksum, int kw,
                              int warps, int rows_per_tile, int dtype,
                              int out_dtype, int straggle_rank,
                              long long straggle_ns, void* info,
                              void* stream) {
  if (n < 1 || m < 1 || K < 1 || blk < 1 || nb < 1 || blk * nb != K ||
      kw < K + 4 * nb + 4 * (checksum != 0) || kw % 16 || rows_per_tile < 1)
    return int(cudaErrorInvalidValue);
  if (warps) {
    const bool fits = (warps == 1 || warps == 2 || warps == 4 ||
                       warps == 8) &&
                      rows_per_tile == kWarps / warps && K % kWireUnit == 0 &&
                      blk % kWireUnit == 0 &&
                      K <= kWireUnit * kWireU * 32 * warps;
    if (!fits) return int(cudaErrorInvalidValue);
    if (!aligned16(x, slots, out)) warps = 0;
  }
  const WireFmt f{blk, nb, checksum != 0, kw};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* fl = static_cast<int*>(flags);
  int* inf = static_cast<int*>(info);
  if (fp8)
    return int(launch_wire_in<true>(dtype, out_dtype, x, slots, out, fl, n,
                                    m, K, f, warps, rows_per_tile,
                                    straggle_rank, straggle_ns, inf, st));
  return int(launch_wire_in<false>(dtype, out_dtype, x, slots, out, fl, n, m,
                                   K, f, warps, rows_per_tile, straggle_rank,
                                   straggle_ns, inf, st));
}

extern "C" const char* rs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
