// GEMM + ReduceScatter over the virtual world of one card, sm_90a.
//
// Replaces the Pallas TPU kernels reached through `gemm_rs` in
// triton_dist_tpu/kernels/gemm_reduce_scatter.py: `_gemm_rs_kernel`
// (resident B) and `_gemm_rs_kernel_streamed` (streamed B) with their
// shared ring `_rs_ring`, and, at n = 1, `_local_mm_kernel` (the same
// kernel with one rank). Same function: a (n, M, K) and b (n, K, N)
// rank-stacked; rank c keeps out[c] = sum over r of
// (a[r] @ b[r])[c*m : (c+1)*m], m = M / n. With a_order "arrival", a[r]
// holds its row blocks in ag_gemm's ring-arrival order (block s = chunk
// (r - s) mod n, allgather_gemm.cu), and the producer reads chunk c from
// block (r - c) mod n: the JAX kernel's `_src_slot` remap, an index
// change and no copy.
//
// Design: producer GEMM -> tile counter -> consumer reduce, the form of
// the reference's GEMM+RS (SURVEY.md). Each rank computes its partial
// product tile by tile inside the kernel and puts each (BM x BN) tile of
// chunk c into slot `me` of rank c's partition of the heap
// (heap((n, m, N)) of every rank, i.e. (n, n, m, N)), rounded to the
// output dtype as the JAX kernel's partials are, then adds one to that
// tile's counter in rank c's flag pool. After its producer tiles, each
// block of rank c takes tiles of its own chunk, waits until a tile's
// counter reaches n, folds the n slots in rank order 0..n-1 in f32 and
// writes the tile in the output dtype once. The TPU kernel runs a
// two-slot credit ring because VMEM holds only two partial chunks at a
// time; device memory holds all n slots of a chunk, so the port needs
// no credits and no ring order, and every rank's partials are in flight
// at once. All n ranks run in one cooperative launch; producer tiles
// never wait, so the consumer waits cannot form a cycle.
//
// Tile bodies. bf16 (the model's path): 128 x 128 output tiles, 8 warps
// of 64 x 32, mma.sync m16n8k16 with f32 accumulation, the A and B tiles
// staged in shared memory with cp.async in a three-stage ring, rows
// padded by 16 bytes so ldmatrix is free of bank conflicts (the fragment
// code of flash_prefill.cu, tile.cuh). f32: 64 x 64 tiles on the CUDA
// cores with FMA, so the kernel can be held to a tight tolerance.
//
// What bounds it on an H100: operations, 2 * n * M * K * N at the
// model's shapes (the bf16 tensor-core peak), against n * (M*K + K*N)
// inputs read and n * m * N written. Not done yet: wgmma, TMA and warp
// specialisation, which that peak needs; overlap of a rank's consumer
// folds with its producer tiles.
//
// The output dtype O may differ from the input's (bf16 in, f32 out: the
// JAX out_dtype, which on the native wire is also the accumulation
// dtype): the slots hold partials rounded to O, the fold is f32, the
// output O. The quantized wire (JAX `_rs_ring` with a wire format) is
// two launches, JAX's own fallback structure (`_wire_rs_xla(partial)`):
// this kernel in its partials mode, every rank's f32 partial of every
// chunk written to a plain (n, M, N) buffer with no flags and no fold,
// then the wire ring of csrc/reduce_scatter.cu (`ring_rs_wire_kernel`)
// on those partials. The ring order with per-hop requantization is a
// different function from this kernel's all-slots rank-order fold, so
// the wire form cannot reuse the fold; fusing the two launches is later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "shmem.cuh"
#include "tile.cuh"

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(unsigned short x) {
  return __bfloat162float(__ushort_as_bfloat16(x));
}
__device__ __forceinline__ void from_f32(float v, float& o) { o = v; }
__device__ __forceinline__ void from_f32(float v, unsigned short& o) {
  o = __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
// two adjacent outputs (8-byte aligned for f32, 4 for bf16)
__device__ __forceinline__ void put_pair(float v0, float v1,
                                         unsigned short* p) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(v0, v1);
}
__device__ __forceinline__ void put_pair(float v0, float v1, float* p) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}

// ---- bf16 tile body: mma.sync on the tensor cores ------------------------

struct Bf16Body {
  typedef unsigned short S;  // bf16 bits
  static constexpr int BM = 128, BN = 128, BK = 32;
  static constexpr int kThreads = 256, kStages = 3;
  static constexpr int AST = BK + 8;  // smem row strides (+16 bytes)
  static constexpr int BST = BN + 8;
  static constexpr int kStage = BM * AST + BK * BST;  // bf16 per stage
  static constexpr size_t kSmem = sizeof(bf16) * kStage * kStages;

  // dst[rows x cols] (leading dim N, dtype O) = a[rows x K] @ b[K x
  // cols], the edges zero-filled on load and masked on store; K, N
  // multiples of 8
  template <typename O>
  static __device__ __forceinline__ void tile(const S* a, int rows,
                                              const S* b, int cols, int K,
                                              int N, O* dst, void* smem) {
    bf16* sm = static_cast<bf16*>(smem);
    const bf16* A = reinterpret_cast<const bf16*>(a);
    const bf16* B = reinterpret_cast<const bf16*>(b);
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
    const int KT = (K + BK - 1) / BK;

    auto load = [&](int kt, int stage) {
      bf16* as = sm + stage * kStage;
      bf16* bs = as + BM * AST;
      const int k0 = kt * BK;
#pragma unroll
      for (int q = 0; q < 2; ++q) {  // A: 128 rows x 4 chunks of 8
        const int idx = tid + q * kThreads, r = idx >> 2, kc = (idx & 3) * 8;
        const bool ok = r < rows && k0 + kc < K;
        cp_async16(as + r * AST + kc, ok ? A + size_t(r) * K + k0 + kc : A,
                   ok);
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {  // B: 32 rows x 16 chunks of 8
        const int idx = tid + q * kThreads, r = idx >> 4, nc = (idx & 15) * 8;
        const bool ok = k0 + r < K && nc < cols;
        cp_async16(bs + r * BST + nc, ok ? B + size_t(k0 + r) * N + nc : B,
                   ok);
      }
    };

    float acc[4][4][4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < KT) load(s, s);
      cp_async_commit();
    }
    for (int kt = 0; kt < KT; ++kt) {
      cp_async_wait<kStages - 2>();  // stage kt has landed
      __syncthreads();               // and every warp is done with kt - 1
      if (kt + kStages - 1 < KT) load(kt + kStages - 1, (kt + kStages - 1) % kStages);
      cp_async_commit();  // possibly empty: keeps the group count uniform
      const bf16* as = sm + (kt % kStages) * kStage;
      const bf16* bs = as + BM * AST;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t af[4][4], bfr[2][4];
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
          ldsm_x4(af[mi], as + (wm + mi * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * AST +
                              kk * 16 + 8 * (lane >> 4));
#pragma unroll
        for (int nj = 0; nj < 2; ++nj)
          ldsm_x4_trans(bfr[nj], bs + (kk * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * BST +
                                     wn + nj * 16 + 8 * (lane >> 4));
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            mma_bf16(acc[mi][ni], af[mi], bfr[ni >> 1][(ni & 1) * 2],
                     bfr[ni >> 1][(ni & 1) * 2 + 1]);
      }
    }
    cp_async_wait<0>();

#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = wn + ni * 8 + (lane & 3) * 2;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = wm + mi * 16 + (lane >> 2) + 8 * h;
          if (row < rows && col < cols)
            put_pair(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1],
                     dst + size_t(row) * N + col);
        }
      }
  }
};

// ---- f32 tile body: FMA on the CUDA cores --------------------------------

struct F32Body {
  typedef float S;
  static constexpr int BM = 64, BN = 64, BK = 16;
  static constexpr int kThreads = 256;
  static constexpr size_t kSmem = sizeof(float) * BK * (BM + BN);

  template <typename O>
  static __device__ __forceinline__ void tile(const S* a, int rows,
                                              const S* b, int cols, int K,
                                              int N, O* dst, void* smem) {
    float* as = static_cast<float*>(smem);  // [BK][BM], A transposed
    float* bs = as + BK * BM;               // [BK][BN]
    const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int idx = tid + q * kThreads;
        const int ar = idx >> 4, ak = idx & 15;  // A element (ar, k0 + ak)
        as[ak * BM + ar] =
            ar < rows && k0 + ak < K ? a[size_t(ar) * K + k0 + ak] : 0.f;
        const int bk = idx >> 6, bc = idx & 63;  // B element (k0 + bk, bc)
        bs[bk * BN + bc] =
            k0 + bk < K && bc < cols ? b[size_t(k0 + bk) * N + bc] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = as[k * BM + ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = bs[k * BN + tx * 4 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = ty * 4 + i, col = tx * 4 + j;
        if (row < rows && col < cols)
          from_f32(acc[i][j], dst[size_t(row) * N + col]);
      }
  }
};

// ---- the kernel: produce every tile, then fold my chunk -------------------

// PARTIALS: heap is a plain (n, M, N) f32 buffer, rank me's partial of
// chunk c at rows [c * m, (c + 1) * m) of [me]; no flags, no fold.
template <class Body, typename O, bool PARTIALS>
__global__ void __launch_bounds__(Body::kThreads, 2)
gemm_rs_kernel(const typename Body::S* a, const typename Body::S* b,
               O* heap, O* out, int* flags, int M, int K, int N,
               int arrival) {
  typedef typename Body::S S;
  constexpr int BM = Body::BM, BN = Body::BN;
  constexpr int kPer = 16 / sizeof(O);  // elements of a 16-byte word
  extern __shared__ uint4 smem[];
  const int n = gridDim.y, me = blockIdx.y, m = M / n;
  const int tm = (m + BM - 1) / BM, tn = (N + BN - 1) / BN;
  const int per_chunk = tm * tn;
  const S* a_me = a + size_t(me) * M * K;
  const S* b_me = b + size_t(me) * K * N;

  // producer: my partial of every tile of every chunk, into slot `me` of
  // the owner's partition, one counter add per tile
  for (int t = blockIdx.x; t < n * per_chunk; t += gridDim.x) {
    const int c = t / per_chunk, i = (t % per_chunk) / tn, j = t % tn;
    const int src = arrival ? (me - c + n) % n : c;  // chunk c's row block
    const size_t row0 = PARTIALS ? size_t(me) * M + size_t(c) * m
                                 : (size_t(c) * n + me) * m;
    Body::tile(a_me + (size_t(src) * m + size_t(i) * BM) * K, min(BM, m - i * BM),
               b_me + size_t(j) * BN, min(BN, N - j * BN), K, N,
               heap + (row0 + size_t(i) * BM) * N + size_t(j) * BN, smem);
    if (!PARTIALS)
      shmem::signal_add(flags + size_t(c) * per_chunk + t % per_chunk, 1);
  }
  if (PARTIALS) return;

  // consumer: fold the n slots of each tile of my chunk, rank order
  const O* slots = heap + size_t(me) * n * m * N;
  for (int t = blockIdx.x; t < per_chunk; t += gridDim.x) {
    shmem::signal_wait_until(flags + size_t(me) * per_chunk + t, shmem::kEq,
                             n, "gemm_rs", me, t);
    const int i = t / tn, j = t % tn;
    const int rows = min(BM, m - i * BM), vpr = min(BN, N - j * BN) / kPer;
    for (int v = threadIdx.x; v < rows * vpr; v += blockDim.x) {
      const size_t off = size_t(i * BM + v / vpr) * N + j * BN + (v % vpr) * kPer;
      float acc[kPer];
      for (int r = 0; r < n; ++r) {
        // delivered by rank r: __ldcg after the acquire (shmem.cuh)
        const uint4 w = __ldcg(reinterpret_cast<const uint4*>(
            slots + size_t(r) * m * N + off));
        const O* e = reinterpret_cast<const O*>(&w);
#pragma unroll
        for (int q = 0; q < kPer; ++q)
          acc[q] = r == 0 ? to_f32(e[q]) : acc[q] + to_f32(e[q]);
      }
      uint4 o;
      O* oe = reinterpret_cast<O*>(&o);
#pragma unroll
      for (int q = 0; q < kPer; ++q) from_f32(acc[q], oe[q]);
      *reinterpret_cast<uint4*>(out + size_t(me) * m * N + off) = o;
    }
  }
}

template <class Body>
int tiles_per_chunk(int m, int N) {
  return ((m + Body::BM - 1) / Body::BM) * ((N + Body::BN - 1) / Body::BN);
}

template <class Body, typename O, bool PARTIALS>
cudaError_t launch(const void* a, const void* b, void* heap, void* out,
                   int* flags, int n, int M, int K, int N, int arrival,
                   int* info, cudaStream_t st) {
  typedef typename Body::S S;
  return shmem::launch_world(
      gemm_rs_kernel<Body, O, PARTIALS>, n,
      n * tiles_per_chunk<Body>(M / n, N), Body::kThreads, Body::kSmem, st,
      info, static_cast<const S*>(a), static_cast<const S*>(b),
      static_cast<O*>(heap), static_cast<O*>(out), flags, M, K, N, arrival);
}

}  // namespace

// Flags (tile counters) a rank needs: the output tiles of its chunk.
extern "C" int gemm_rs_flag_count(int m, int N, int dtype) {
  return dtype == 1 ? tiles_per_chunk<Bf16Body>(m, N)
                    : tiles_per_chunk<F32Body>(m, N);
}

// a (n, M, K), b (n, K, N) of dtype; heap (n, n, M/n, N) and out (n,
// M/n, N) of out_dtype (partials: heap (n, M, N) f32, out unused and no
// flags); flags (n, gemm_rs_flag_count) zeroed. M % n == 0; K and N
// multiples of 16 bytes' worth of elements. dtype, out_dtype: 0 =
// float32, 1 = bfloat16 (f32 inputs: f32 out). arrival: a's row blocks
// in ring-arrival order. info: 3 ints (see launch_world). Returns a
// cudaError_t.
extern "C" int gemm_rs_launch(const void* a, const void* b, void* heap,
                              void* out, void* flags, int n, int M, int K,
                              int N, int dtype, int out_dtype, int partials,
                              int arrival, void* info, void* stream) {
  const int per = dtype == 1 ? 8 : 4;
  if (n < 1 || M < n || M % n || K < 1 || N < 1 || K % per || N % per ||
      (partials && out_dtype != 0))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* fl = static_cast<int*>(flags);
  int* inf = static_cast<int*>(info);
  if (dtype == 0 && out_dtype == 0)
    return int(partials ? launch<F32Body, float, true>(
                              a, b, heap, out, fl, n, M, K, N, arrival, inf,
                              st)
                        : launch<F32Body, float, false>(
                              a, b, heap, out, fl, n, M, K, N, arrival, inf,
                              st));
  if (dtype == 1 && out_dtype == 0)
    return int(partials ? launch<Bf16Body, float, true>(
                              a, b, heap, out, fl, n, M, K, N, arrival, inf,
                              st)
                        : launch<Bf16Body, float, false>(
                              a, b, heap, out, fl, n, M, K, N, arrival, inf,
                              st));
  if (dtype == 1 && out_dtype == 1)
    return int(launch<Bf16Body, unsigned short, false>(
        a, b, heap, out, fl, n, M, K, N, arrival, inf, st));
  return int(cudaErrorInvalidValue);
}

extern "C" const char* gemm_rs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
