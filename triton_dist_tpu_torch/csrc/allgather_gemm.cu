// Fused AllGather + GEMM over the virtual world of one card, sm_90a.
//
// Replaces the Pallas TPU kernel `_ag_gemm_kernel` reached through
// `ag_gemm` in triton_dist_tpu/kernels/allgather_gemm.py (dense and
// grouped forms, native wire; the plain and the silu_pair epilogues;
// rank and arrival order of C). Same function, rank-stacked: a (n, m, K)
// holds rank r's shard at [r], b (n, K, N) rank r's weight; rank r's
// result is C[r] = AllGather(a) @ b[r], (n*m, N). With silu_pair, b is a
// pair (gate, up) of that shape and C[r] = silu(A @ gate[r]) *
// (A @ up[r]), f32 math on the f32 accumulators, rounded once to the
// output dtype.
//
// The grouped (MoE) form: each rank's m rows are E blocks of cap rows
// (moe_utils.pack_by_expert), b is (n, E, K, N) and row block e of every
// gathered chunk multiplies b[r][e]. B is read through strides (a row
// stride ldb >= N, an expert and a rank stride), so the gate and up
// halves are views of one [w_gate | w_up] stack (ldb = 2N) and no
// weight is copied. Row tiles are cut per block of cap rows, so a tile
// never spans two experts (nor two ring steps): a block of cap < 128 rows
// is one tile with its rows past cap predicated off, and the tile's
// expert e = block % E picks its B. The dense form is the grouped form
// with E = 1 and cap = n*m, the same tiles and the same addresses.
//
// The gather. Each rank's gathered A lives in the workspace, heap((n*m,
// K)) of every rank: partition [r], row block c = chunk c. It travels
// the ring of csrc/allgather.cu: at step s, rank me puts chunk
// (me - s) mod n into the same row block of its right neighbour's
// partition, and adds one to that neighbour's arrival counter of step
// s. The first kProducers blocks of every rank do the ring, each a
// contiguous share of every chunk; a producer forwards step s's chunk
// only after the counter of step s - 1 shows every producer's share of
// it arrived. Step 0 forwards the own shard, which needs no wait, and
// also publishes it into the own partition, so the workspace ends as
// the gathered A (return_gathered).
//
// The product. The consumer walks C's tiles over the ARRIVAL-ordered
// gathered A (row block s = chunk (me - s) mod n, s = ring step), row
// tiles outermost, so tiles of early steps come first: the own shard
// (step 0) is read straight from `a` and needs no wait; a tile whose
// rows reach step s >= 1 waits on the arrival counter of step s - 1
// before its A loads. A row tile need not align with a chunk (m = 1 at
// decode, 64 in a serve step): it waits on every step its rows cover,
// and B is read once per row tile, not once per step. Every block,
// producers included once their ring share is done, takes tiles from a
// per-rank counter (dynamic scheduling, tiles in increasing order). The
// store puts row R at R (c_order "arrival") or at its chunk's rank-order
// row (c_order "rank").
//
// No deadlock: producers wait only on producers of an earlier step of
// the same ring, a chain that ends at step 0, which waits on nothing;
// consumers wait only on producers, and a producer never waits on a
// consumer. All n ranks run in one cooperative launch (shmem.cuh), so
// every block is resident; every spin is bounded and traps.
//
// Tile bodies. bf16 (the model's path): 128 x 128 output tiles (128 x 64
// per half with silu_pair, two accumulators, the same 64 f32 registers a
// thread as one 128 x 128 tile), 8 warps, mma.sync m16n8k16 with f32
// accumulation, A and B staged with cp.async in a three-stage ring, the
// fragment code of gemm_reduce_scatter.cu (tile.cuh). f32: 64 x 64 tiles
// on the CUDA cores with FMA, so the kernel can be held to a tight
// tolerance.
//
// What bounds it on an H100: operations, 2 * n * (n*m) * K * N (twice
// that with silu_pair) at the bf16 tensor-core peak, at the prefill
// shapes; bytes (B, n * K * N, read at least once) at a serve step's.
// The TPU kernel's VMEM strip cache, grid-step restructuring and tile
// fitting are TPU concerns and are not carried over. Not done yet:
// wgmma, TMA and warp specialisation, which that peak needs; a finer
// arrival granularity than one counter per step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "shmem.cuh"
#include "tile.cuh"

namespace {

constexpr int kProducers = 8;  // ring blocks a rank
constexpr int kThreads = 256;

__device__ __forceinline__ float silu_mul(float g, float u) {
  return g * (1.f / (1.f + expf(-g))) * u;
}

// One rank's view of the gathered A and of its C. Row R of the
// arrival-ordered gathered A is row R % m of step s = R / m, which holds
// chunk (me - s) mod n.
template <typename S>
struct Gathered {
  const S* a;   // my shard (m, K)
  const S* ws;  // my workspace partition (n*m, K), chunk c at rows c*m
  S* c;         // my C (n*m, N)
  int n, me, m, K, N, arrival;
  int ldb;      // B's row stride (elements)

  __device__ __forceinline__ const S* a_row(int R) const {
    const int s = R / m, lr = R - s * m;
    if (s == 0) return a + size_t(lr) * K;
    return ws + (size_t((me - s + n) % n) * m + lr) * K;
  }
  __device__ __forceinline__ S* c_row(int R) const {
    if (arrival) return c + size_t(R) * N;
    const int s = R / m, lr = R - s * m;
    return c + (size_t((me - s + n) % n) * m + lr) * N;
  }
};

// ---- bf16 tile body: mma.sync on the tensor cores ------------------------

template <int H>  // H = 2: silu_pair, one accumulator per half
struct Bf16Body {
  typedef unsigned short S;  // bf16 bits
  static constexpr int BM = 128, BN = H == 1 ? 128 : 64, BK = 32;
  static constexpr int kStages = 3;
  static constexpr int AST = BK + 8;  // smem row strides (+16 bytes)
  static constexpr int BST = BN + 8;
  static constexpr int kStage = BM * AST + H * BK * BST;  // bf16 per stage
  static constexpr size_t kSmem = sizeof(bf16) * kStage * kStages;
  static constexpr int WN = BN / 4, NI = WN / 8;  // warp columns, n8 frags
  static constexpr int kBq = BK * BN / 8 / kThreads;  // B chunks a thread

  // C rows [R0, R0 + rows) x columns [j0, j0 + cols) of my C, edges
  // zero-filled on load and masked on store; K, N multiples of 8
  static __device__ __forceinline__ void tile(const Gathered<S>& g, int R0,
                                              int rows, int j0, int cols,
                                              const S* const* b, void* smem) {
    const int K = g.K;
    bf16* sm = static_cast<bf16*>(smem);
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int wm = (warp >> 2) * 64, wn = (warp & 3) * WN;
    const int KT = (K + BK - 1) / BK;
    const bf16* base = reinterpret_cast<const bf16*>(g.a);
    // the two A rows this thread loads: tid / 4 and tid / 4 + 64
    const bf16* arow[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int r = (tid >> 2) + 64 * q;
      arow[q] = r < rows ? reinterpret_cast<const bf16*>(g.a_row(R0 + r))
                         : nullptr;
    }
    const int kc = (tid & 3) * 8;

    auto load = [&](int kt, int stage) {
      bf16* as = sm + stage * kStage;
      const int k0 = kt * BK;
#pragma unroll
      for (int q = 0; q < 2; ++q) {  // A: 128 rows x 4 chunks of 8
        const int r = (tid >> 2) + 64 * q;
        const bool ok = arow[q] != nullptr && k0 + kc < K;
        cp_async16(as + r * AST + kc, ok ? arow[q] + k0 + kc : base, ok);
      }
#pragma unroll
      for (int h = 0; h < H; ++h) {  // B: 32 rows x BN / 8 chunks of 8
        bf16* bs = as + BM * AST + h * BK * BST;
        const bf16* B = reinterpret_cast<const bf16*>(b[h]) + j0;
#pragma unroll
        for (int q = 0; q < kBq; ++q) {
          const int idx = tid + q * kThreads;
          const int r = idx / (BN / 8), nc = (idx % (BN / 8)) * 8;
          const bool ok = k0 + r < K && nc < cols;
          cp_async16(bs + r * BST + nc,
                     ok ? B + size_t(k0 + r) * g.ldb + nc : base, ok);
        }
      }
    };

    float acc[H][4][NI][4];
#pragma unroll
    for (int h = 0; h < H; ++h)
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[h][mi][ni][e] = 0.f;

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
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t af[4][4], bfr[H][NI / 2][4];
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
          ldsm_x4(af[mi], as + (wm + mi * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * AST +
                              kk * 16 + 8 * (lane >> 4));
#pragma unroll
        for (int h = 0; h < H; ++h) {
          const bf16* bs = as + BM * AST + h * BK * BST;
#pragma unroll
          for (int nj = 0; nj < NI / 2; ++nj)
            ldsm_x4_trans(bfr[h][nj], bs + (kk * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * BST +
                                          wn + nj * 16 + 8 * (lane >> 4));
        }
#pragma unroll
        for (int h = 0; h < H; ++h)
#pragma unroll
          for (int mi = 0; mi < 4; ++mi)
#pragma unroll
            for (int ni = 0; ni < NI; ++ni)
              mma_bf16(acc[h][mi][ni], af[mi], bfr[h][ni >> 1][(ni & 1) * 2],
                       bfr[h][ni >> 1][(ni & 1) * 2 + 1]);
      }
    }
    cp_async_wait<0>();

#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = wm + mi * 16 + (lane >> 2) + 8 * hr;
        if (row >= rows) continue;
        bf16* D = reinterpret_cast<bf16*>(g.c_row(R0 + row)) + j0;
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
          const int col = wn + ni * 8 + (lane & 3) * 2;
          if (col >= cols) continue;
          float v0 = acc[0][mi][ni][2 * hr], v1 = acc[0][mi][ni][2 * hr + 1];
          if (H == 2) {
            v0 = silu_mul(v0, acc[H - 1][mi][ni][2 * hr]);
            v1 = silu_mul(v1, acc[H - 1][mi][ni][2 * hr + 1]);
          }
          *reinterpret_cast<uint32_t*>(D + col) = pack_bf16(v0, v1);
        }
      }
  }
};

// ---- f32 tile body: FMA on the CUDA cores --------------------------------

template <int H>
struct F32Body {
  typedef float S;
  static constexpr int BM = 64, BN = 64, BK = 16;
  static constexpr size_t kSmem = sizeof(float) * BK * (BM + H * BN);

  static __device__ __forceinline__ void tile(const Gathered<S>& g, int R0,
                                              int rows, int j0, int cols,
                                              const S* const* b, void* smem) {
    const int K = g.K;
    float* as = static_cast<float*>(smem);  // [BK][BM], A transposed
    float* bs = as + BK * BM;               // [H][BK][BN]
    const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15, ak = tid & 15;
    const float* arow[4];  // rows tid / 16 + 16 q
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = (tid >> 4) + 16 * q;
      arow[q] = r < rows ? g.a_row(R0 + r) : nullptr;
    }
    float acc[H][4][4];
#pragma unroll
    for (int h = 0; h < H; ++h)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[h][i][j] = 0.f;
    for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = (tid >> 4) + 16 * q;
        // A rows may have been delivered by another rank: __ldcg
        as[ak * BM + r] = arow[q] != nullptr && k0 + ak < K
                              ? __ldcg(arow[q] + k0 + ak)
                              : 0.f;
      }
#pragma unroll
      for (int h = 0; h < H; ++h)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int idx = tid + q * kThreads;
          const int bk = idx >> 6, bc = idx & 63;  // B element (k0 + bk, bc)
          bs[(h * BK + bk) * BN + bc] =
              k0 + bk < K && bc < cols
                  ? b[h][size_t(k0 + bk) * g.ldb + j0 + bc]
                  : 0.f;
        }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        float av[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = as[k * BM + ty * 4 + i];
#pragma unroll
        for (int h = 0; h < H; ++h) {
          float bv[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = bs[(h * BK + k) * BN + tx * 4 + j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[h][i][j] = fmaf(av[i], bv[j], acc[h][i][j]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty * 4 + i;
      if (row >= rows) continue;
      float* D = g.c_row(R0 + row) + j0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx * 4 + j;
        if (col < cols)
          D[col] = H == 2 ? silu_mul(acc[0][i][j], acc[H - 1][i][j])
                          : acc[0][i][j];
      }
    }
  }
};

// Block-wide copy of words [lo, hi), four loads in flight a thread; src
// may be data another rank delivered (__ldcg, shmem.cuh's rule).
__device__ __forceinline__ void copy_words(uint4* dst, const uint4* src,
                                           long long lo, long long hi) {
  constexpr int U = 4;
  long long i = lo + threadIdx.x;
  for (; i + (U - 1) * kThreads < hi; i += U * kThreads) {
    uint4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) v[u] = __ldcg(src + i + u * kThreads);
#pragma unroll
    for (int u = 0; u < U; ++u) dst[i + u * kThreads] = v[u];
  }
  for (; i < hi; i += kThreads) dst[i] = __ldcg(src + i);
}

// ---- the kernel: ring producers, then tiles in arrival order --------------

// flags of a rank: [0] the tile counter, [1 + s] arrivals of step s.
// Row blocks of cap rows (cap divides m; E blocks a chunk, block q
// multiplies expert q % E); B of rank r, expert e at b + r * b_rs +
// e * b_es, rows ldb apart.
template <class Body>
__global__ void __launch_bounds__(kThreads, 2)
ag_gemm_kernel(const typename Body::S* a, const typename Body::S* b0,
               const typename Body::S* b1, typename Body::S* ws,
               typename Body::S* c, int* flags, int m, int K, int N,
               int arrival, int cap, int E, int ldb, long long b_es,
               long long b_rs) {
  typedef typename Body::S S;
  constexpr int BM = Body::BM, BN = Body::BN;
  extern __shared__ uint4 smem[];
  __shared__ int next_tile;
  const int n = gridDim.y, me = blockIdx.y, right = (me + 1) % n;
  const int producers = min(kProducers, int(gridDim.x));
  const size_t chunk = size_t(m) * K;  // elements of a shard
  int* mine = flags + size_t(me) * n;

  if (int(blockIdx.x) < producers) {
    const long long words = (long long)(chunk * sizeof(S) / 16);
    const long long lo = words * blockIdx.x / producers;
    const long long hi = words * (blockIdx.x + 1) / producers;
    const uint4* own = reinterpret_cast<const uint4*>(a + me * chunk);
    copy_words(reinterpret_cast<uint4*>(ws + (size_t(me) * n + me) * chunk),
               own, lo, hi);
    for (int s = 0; s < n - 1; ++s) {
      const int ch = (me - s + n) % n;  // the chunk this step forwards
      if (s > 0)  // chunk ch arrived from the left at step s - 1
        shmem::signal_wait_until(mine + s, shmem::kEq, producers, "ag_gemm",
                                 me, s);
      const uint4* src =
          s == 0 ? own
                 : reinterpret_cast<const uint4*>(ws + (size_t(me) * n + ch) * chunk);
      copy_words(reinterpret_cast<uint4*>(ws + (size_t(right) * n + ch) * chunk),
                 src, lo, hi);
      shmem::signal_add(flags + size_t(right) * n + 1 + s, 1);
    }
  }

  const Gathered<S> g{a + me * chunk, ws + size_t(me) * n * chunk,
                      c + size_t(me) * n * m * N, n, me, m, K, N, arrival,
                      ldb};
  const int M = n * m, nt = (N + BN - 1) / BN;
  const int tpb = (cap + BM - 1) / BM;  // row tiles a block of cap rows
  const int total = (M / cap) * tpb * nt;
  for (;;) {
    if (threadIdx.x == 0) next_tile = atomicAdd(mine, 1);
    __syncthreads();
    const int t = next_tile;
    __syncthreads();
    if (t >= total) break;
    const int rt = t / nt, q = rt / tpb, w = rt - q * tpb;
    const int R0 = q * cap + w * BM, j0 = (t % nt) * BN;
    const int rows = min(BM, cap - w * BM);
    const int e = q % E;
    const S* b[2] = {b0 + me * b_rs + e * b_es, b1 + me * b_rs + e * b_es};
    // the steps this tile's rows come from; step s >= 1 arrived with
    // flag 1 + (s - 1)
    for (int s = max(1, R0 / m); s <= (R0 + rows - 1) / m; ++s)
      shmem::signal_wait_until(mine + s, shmem::kEq, producers, "ag_gemm", me,
                               s);
    Body::tile(g, R0, rows, j0, min(BN, N - j0), b, smem);
  }
}

struct Geometry {  // the row blocks and B's strides
  int cap, E, ldb;
  long long b_es, b_rs;
};

template <class Body>
cudaError_t launch(const void* a, const void* b0, const void* b1, void* ws,
                   void* c, int* flags, int n, int m, int K, int N,
                   int arrival, Geometry geo, int* info, cudaStream_t st) {
  typedef typename Body::S S;
  const int tiles = (n * m / geo.cap) *
                    ((geo.cap + Body::BM - 1) / Body::BM) *
                    ((N + Body::BN - 1) / Body::BN);
  return shmem::launch_world(
      ag_gemm_kernel<Body>, n, tiles > kProducers ? tiles : kProducers,
      kThreads, Body::kSmem, st, info, static_cast<const S*>(a),
      static_cast<const S*>(b0), static_cast<const S*>(b1),
      static_cast<S*>(ws), static_cast<S*>(c), flags, m, K, N, arrival,
      geo.cap, geo.E, geo.ldb, geo.b_es, geo.b_rs);
}

int launch_any(const void* a, const void* b0, const void* b1, void* ws,
               void* c, void* flags, int n, int m, int K, int N, int dtype,
               int pair, int arrival, Geometry geo, void* info,
               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* fl = static_cast<int*>(flags);
  int* inf = static_cast<int*>(info);
  if (dtype == 0)
    return int(pair ? launch<F32Body<2>>(a, b0, b1, ws, c, fl, n, m, K, N,
                                         arrival, geo, inf, st)
                    : launch<F32Body<1>>(a, b0, b1, ws, c, fl, n, m, K, N,
                                         arrival, geo, inf, st));
  if (dtype == 1)
    return int(pair ? launch<Bf16Body<2>>(a, b0, b1, ws, c, fl, n, m, K, N,
                                          arrival, geo, inf, st)
                    : launch<Bf16Body<1>>(a, b0, b1, ws, c, fl, n, m, K, N,
                                          arrival, geo, inf, st));
  return int(cudaErrorInvalidValue);
}

}  // namespace

// Flags a rank needs: the tile counter and one arrival counter per ring
// step (n - 1 of them).
extern "C" int ag_gemm_flag_count(int n) { return n; }

// a (n, m, K); b0, b1 (n, K, N) (b1 = b0 unless pair: silu_pair's gate
// and up); ws (n, n*m, K); c (n, n*m, N); all of one dtype; flags (n,
// ag_gemm_flag_count) zeroed. K and N multiples of 16 bytes' worth of
// elements. dtype: 0 = float32, 1 = bfloat16. pair: silu_pair epilogue.
// arrival: C's row blocks in ring-arrival order. info: 3 ints (see
// launch_world). Returns a cudaError_t.
extern "C" int ag_gemm_launch(const void* a, const void* b0, const void* b1,
                              void* ws, void* c, void* flags, int n, int m,
                              int K, int N, int dtype, int pair, int arrival,
                              void* info, void* stream) {
  const int per = dtype == 1 ? 8 : 4;
  if (n < 1 || m < 1 || K < 1 || N < 1 || K % per || N % per)
    return int(cudaErrorInvalidValue);
  const Geometry dense{n * m, 1, N, 0, (long long)K * N};
  return launch_any(a, b0, b1, ws, c, flags, n, m, K, N, dtype, pair,
                    arrival, dense, info, stream);
}

// The grouped form: a (n, m, K) with m = E * cap rows a rank (cap rows an
// expert block); b0, b1 of rank r and expert e at b + r * b_rs + e * b_es,
// K rows ldb elements apart (N <= ldb); c (n, n*m, N). ldb, b_es, b_rs
// and both B base addresses multiples of 16 bytes' worth of elements.
extern "C" int ag_gemm_grouped_launch(const void* a, const void* b0,
                                      const void* b1, void* ws, void* c,
                                      void* flags, int n, int m, int K, int N,
                                      int dtype, int pair, int arrival, int E,
                                      int ldb, long long b_es, long long b_rs,
                                      void* info, void* stream) {
  const int per = dtype == 1 ? 8 : 4;
  if (n < 1 || m < 1 || K < 1 || N < 1 || K % per || N % per || E < 1 ||
      m % E || ldb < N || ldb % per || b_es % per || b_rs % per)
    return int(cudaErrorInvalidValue);
  const Geometry grouped{m / E, E, ldb, b_es, b_rs};
  return launch_any(a, b0, b1, ws, c, flags, n, m, K, N, dtype, pair,
                    arrival, grouped, info, stream);
}

extern "C" const char* ag_gemm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
