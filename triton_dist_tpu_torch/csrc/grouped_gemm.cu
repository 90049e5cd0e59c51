// Grouped product with an f32 output over device-side group sizes, the
// TP-MoE down product and both products of the EP FFN:
// y[r, i] = x[r, i] @ w[r, e(r, i)] for the rows i of sorted group e of
// rank r, f32 accumulation and output; rows past the last group are zero.
//
// It replaces no TPU kernel: the JAX package computes it with XLA's
// `lax.ragged_dot` (triton_dist_tpu/kernels/grouped_gemm.py:26), which is
// not a Pallas kernel. It was added because no PyTorch call serves: the
// port's route before it (a batched f32-out product over padded blocks)
// read the group sizes on the host, a sync in every MoE layer that also
// keeps the step out of a CUDA graph, and `torch._grouped_mm` has no f32
// output for bf16 operands (its bf16 result widened fell outside the f32
// epsilon band).
//
// Shapes: x bf16 (n, T, K) with a rank stride (0: one x for every rank),
// w bf16 (n, E, K, N) row-major, sizes int32 (n, E) with a rank stride
// (0: the same sizes for every rank), y f32 (n, T, N). K and N multiples
// of 8.
//
// What bounds it: bytes. At decode (Qwen3-30B-A3B, 32 rows a rank, K 192
// at world 4) a row tile is one or two rows, so every tile is the read of
// its expert's (K, 128) weight slab: the reached experts' weights once,
// which is the bound. At prefill the tiles fill and the products approach
// the tensor rate of mma.sync.
//
// Design: a block a (rank, N tile of 128 columns) and a persistent walk
// over the rank's row tiles (64 rows of one group each; a group of s rows
// has ceil(s / 64) tiles, an empty group none). The block scans the
// rank's group sizes into tile and row starts in shared memory once
// (each thread a run of experts, then a scan over the threads), so the
// tile list costs no host read and empty experts cost nothing; tile t is
// found by a binary search over the tile starts. The grid's row dimension
// is the launcher's `walkers` (kernels/grouped_gemm.py `_plan`), which
// each walk tiles t = y, y + walkers, ...; then they zero the rows past
// the last group, y-strided. The body is mma.sync m16n8k16 bf16 with f32
// accumulators, a 3-stage cp.async ring of (64 x 32) A and (32 x 128) B
// tiles, four warps side by side along N. A TMA + wgmma body is later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile.cuh"

namespace {

constexpr int BM = 64, BN = 128, BK = 32;
constexpr int kThreads = 128, kStages = 3;
constexpr int AST = BK + 8;  // smem row strides (+16 bytes)
constexpr int BST = BN + 8;
constexpr int kStage = BM * AST + BK * BST;  // bf16 per stage
constexpr size_t kSmem = sizeof(bf16) * kStage * kStages;
constexpr int kMaxE = 512;

// dst[rows x cols] (leading dim N) = a[rows x K] @ b[K x cols] (leading
// dims K and N), in f32; rows <= BM, cols <= BN, the edges zero-filled on
// load and masked on store
__device__ __forceinline__ void tile_f32(const bf16* A, int rows,
                                         const bf16* B, int cols, int K,
                                         int N, float* dst, bf16* sm) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wn = warp * 32;
  const int KT = (K + BK - 1) / BK;

  auto load = [&](int kt, int stage) {
    bf16* as = sm + stage * kStage;
    bf16* bs = as + BM * AST;
    const int k0 = kt * BK;
#pragma unroll
    for (int q = 0; q < 2; ++q) {  // A: 64 rows x 4 chunks of 8
      const int idx = tid + q * kThreads, r = idx >> 2, kc = (idx & 3) * 8;
      const bool ok = r < rows && k0 + kc < K;
      cp_async16(as + r * AST + kc, ok ? A + size_t(r) * K + k0 + kc : A, ok);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {  // B: 32 rows x 16 chunks of 8
      const int idx = tid + q * kThreads, r = idx >> 4, nc = (idx & 15) * 8;
      const bool ok = k0 + r < K && nc < cols;
      cp_async16(bs + r * BST + nc, ok ? B + size_t(k0 + r) * N + nc : B, ok);
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
    if (kt + kStages - 1 < KT)
      load(kt + kStages - 1, (kt + kStages - 1) % kStages);
    cp_async_commit();  // possibly empty: keeps the group count uniform
    const bf16* as = sm + (kt % kStages) * kStage;
    const bf16* bs = as + BM * AST;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t af[4][4], bfr[2][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldsm_x4(af[mi], as + (mi * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) *
                                     AST +
                            kk * 16 + 8 * (lane >> 4));
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
        ldsm_x4_trans(bfr[nj],
                      bs + (kk * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) *
                               BST +
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
  __syncthreads();  // the ring is free for the next tile

#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = wn + ni * 8 + (lane & 3) * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = mi * 16 + (lane >> 2) + 8 * h;
        if (row < rows && col < cols)
          *reinterpret_cast<float2*>(dst + size_t(row) * N + col) =
              make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      }
    }
}

__global__ void __launch_bounds__(kThreads)
    grouped_f32_kernel(const bf16* __restrict__ x, long long x_rank,
                       const bf16* __restrict__ w, float* __restrict__ y,
                       const int* __restrict__ sizes, int sizes_rank, int T,
                       int K, int N, int E) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sm = reinterpret_cast<bf16*>(smem_raw);
  __shared__ int s_tile[kMaxE + 1], s_row[kMaxE + 1];  // starts, group e
  __shared__ int s_sum[2][kThreads];
  const int r = blockIdx.z, n0 = blockIdx.x * BN, tid = threadIdx.x;
  const int* sz = sizes + size_t(r) * sizes_rank;

  // each thread a run of experts: its sums, a scan over the threads, then
  // each expert's tile and row start
  const int per = (E + kThreads - 1) / kThreads;
  const int lo = min(E, tid * per), hi = min(E, lo + per);
  int rows = 0, tiles = 0;
  for (int e = lo; e < hi; ++e) {
    const int s = max(sz[e], 0);
    rows += s;
    tiles += (s + BM - 1) / BM;
  }
  s_sum[0][tid] = rows;
  s_sum[1][tid] = tiles;
  __syncthreads();
  for (int off = 1; off < kThreads; off <<= 1) {
    const int a = tid >= off ? s_sum[0][tid - off] : 0;
    const int b = tid >= off ? s_sum[1][tid - off] : 0;
    __syncthreads();
    s_sum[0][tid] += a;
    s_sum[1][tid] += b;
    __syncthreads();
  }
  int rb = s_sum[0][tid] - rows, tb = s_sum[1][tid] - tiles;
  for (int e = lo; e < hi; ++e) {
    const int s = max(sz[e], 0);
    s_row[e] = rb;
    s_tile[e] = tb;
    rb += s;
    tb += (s + BM - 1) / BM;
  }
  if (tid == kThreads - 1) {
    s_row[E] = s_sum[0][tid];
    s_tile[E] = s_sum[1][tid];
  }
  __syncthreads();

  const int total = s_tile[E];
  const int cols = min(BN, N - n0);
  const bf16* xr = x + size_t(r) * x_rank;
  float* yr = y + size_t(r) * T * N + n0;
  for (int t = blockIdx.y; t < total; t += gridDim.y) {
    int a = 0, b = E - 1;  // the last group whose tiles start at or before t
    while (a < b) {
      const int mid = (a + b + 1) >> 1;
      if (s_tile[mid] <= t) a = mid;
      else b = mid - 1;
    }
    const int j = t - s_tile[a];
    const int row0 = s_row[a] + j * BM;
    const int grp = s_row[a + 1] - s_row[a];
    const int nrows = min(min(BM, grp - j * BM), T - row0);
    if (nrows <= 0) continue;  // sizes summing past T: the excess is cut
    tile_f32(xr + size_t(row0) * K, nrows,
             w + (size_t(r) * E + a) * K * N + n0, cols, K, N,
             yr + size_t(row0) * N, sm);
  }
  // the rows past the last group: zero, a row a (y, warp) at a time
  for (int row = min(s_row[E], T) + blockIdx.y * (kThreads / 32) + (tid >> 5);
       row < T; row += gridDim.y * (kThreads / 32)) {
    for (int c = (tid & 31) * 4; c < cols; c += 128)
      *reinterpret_cast<float4*>(yr + size_t(row) * N + c) =
          make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

}  // namespace

// x (n, T, K) bf16 at rank stride x_rank elements, w (n, E, K, N) bf16,
// y (n, T, N) f32, sizes (n, E) int32 at rank stride sizes_rank; the grid
// is (ceil(N / 128), walkers, n). Returns a cudaError_t (0 = launched).
extern "C" int grouped_f32_launch(const void* x, long long x_rank,
                                  const void* w, void* y, const void* sizes,
                                  int sizes_rank, int n, int T, int K, int N,
                                  int E, int walkers, void* stream) {
  if (n < 1 || T < 1 || K < 8 || N < 8 || K % 8 || N % 8 || E < 1 ||
      E > kMaxE || walkers < 1)
    return int(cudaErrorInvalidValue);
  dim3 grid((N + BN - 1) / BN, walkers, n);
  grouped_f32_kernel<<<grid, kThreads, kSmem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), x_rank, static_cast<const bf16*>(w),
      static_cast<float*>(y), static_cast<const int*>(sizes), sizes_rank, T,
      K, N, E);
  return int(cudaGetLastError());
}

extern "C" int grouped_f32_max_experts() { return kMaxE; }

extern "C" const char* grouped_f32_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
