// Split-KV GQA decode partial for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `_fd_partial_kernel` reached through
// `flash_decode_partial_pallas` in triton_dist_tpu/kernels/
// flash_decode.py. Same function: for each row b (one decode token) and
// query head h, over the keys t < valid[b] of the local KV shard,
//   m = max_t s_t, l = sum_t exp(s_t - m), s_t = scale * q[b,h] . k[b,t],
//   o[b,h] = sum_t exp(s_t - m) v[b,t] / l   (f32),
//   lse[b,h] = m + log(l)                     (f32),
// with query head h reading kv head h / (Hq / Hkv). A row with no valid
// key gives o = 0 and lse = -1e30 (the TPU kernel's NEG_INF), never NaN.
// The SP decode exchanges (o, lse) across ranks and merges them
// (kernels/flash_decode.py flash_decode_combine).
//
// What bounds it on an H100: bytes. Each valid key costs 2 * Hkv * D
// elements of K and V for 4 * Hq * D operations, ~4 operations a byte
// in bf16, far below the ~295 of the tensor cores. So both bodies read
// each K/V byte once, and the question is how close they keep the
// memory busy.
//
// Two bodies (kernels/flash_decode.py `_body_for` picks one).
//
// The Hopper body, fd_tc_kernel (bf16, D = 128, G = Hq / Hkv <= 8: the
// main path's form). A block folds one kv head. One producer thread
// streams its K/V tiles of 128 keys with TMA into a ring of kStages 64 KB
// stages on full / empty mbarriers; eight consumer warps fold them on
// the tensor cores with no block-wide barrier in the key loop. A warp
// folds 16 keys of a stage: S = Q K^T on mma.sync m16n8k16 (the G query
// heads are rows 0..G-1 of the A operand, q unscaled; the scale
// multiplies S in f32), an online softmax in registers, O += P V with P
// split into hi + lo bf16 operands (row 1's fold), so o and lse keep f32
// accuracy. Even with the padding and the split P that is ~24
// operations a byte, so the kernel stays bound by HBM. Each warp holds
// its own (m, l, acc); the warps merge once, through shared memory, in
// warp order, at the end of a piece. The K/V rows come as 128-byte TMA
// boxes (64 of D's elements) of a 3-D map (64, 2 Hkv, rows * T) with the
// 128-byte swizzle, so ldmatrix reads them free of bank conflicts. Keys
// past valid[b] are masked (scores to -inf, V fragments to 0, so garbage
// past the prefix stays out).
//
// Work sized to the live keys, read from `valid` on the device (no host
// sync): the units are the 128-key tiles of each row's live prefix.
// Persistent blocks, one an SM, come in groups of Hkv, a block a kv
// head, so a group's blocks read the same keys' 2 KB rows at the same
// time (a block reading 256 of every 2048 bytes on its own left HBM ~30%
// slower); group g takes the g-th equal contiguous share of the units,
// so a block may fold pieces of several rows, and a (row, kv head)'s
// splits are the groups whose shares meet its row, in group order. (A
// layout reading every kv head's 16 keys a stage, as the JAX kernel
// reads whole Hkv * D rows, and a schedule of fixed splits sized on the
// host were slower: PERF.md row 3.) A row folded by one group writes
// (o, lse) itself; otherwise each split writes its unnormalised (acc, m,
// l) to a slot of `part`, and the last block to count itself on the
// (row, kv head)'s counter (fence, then count) merges the slots in split
// order and resets the counter, so the result does not depend on timing
// and the counters stay at zero for the next call. The wrapper keeps
// `part` and the counters in a pool.
//
// The FMA body, fd_partial_kernel (f32, D = 64, and every other form):
// block (split, kv head, row) folds keys [split * ks, (split + 1) * ks)
// of the valid prefix for the G query heads of its kv head, cp.async
// double-buffered tiles of TK keys in shared memory reused by the G
// heads, arithmetic in f32 on the CUDA cores (so the f32 form is held to
// a tight tolerance), the same last-arriver merge in split order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "tile.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxOut = 8;       // G * D / kThreads outputs a thread, at most
constexpr float kNegInf = -1e30f;

// eight consecutive elements of a shared-memory row as f32
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const bf16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T, int D>
struct Shape {
  static constexpr int TK = sizeof(T) == 2 ? 64 : 32;  // keys a tile
  static constexpr int PAD = 16 / sizeof(T);           // +16 bytes a row
  static constexpr int ST = D + PAD;                   // smem row stride
  static constexpr int CPR = D * int(sizeof(T)) / 16;  // 16-byte chunks a row
  static size_t smem(int G) {
    return sizeof(T) * size_t(4) * TK * ST           // 2 buffers of (K, V)
           + sizeof(float) * (size_t(G) * D          // q, pre-scaled
                              + size_t(G) * TK       // p
                              + 3 * size_t(G));      // m, l, alpha
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fd_partial_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ valid,
                  float* part, int* count, float* __restrict__ o,
                  float* __restrict__ lse, int T_len, int Hq, int Hkv,
                  int ks, float scale) {
  typedef Shape<T, D> Sh;
  constexpr int TK = Sh::TK, ST = Sh::ST, CPR = Sh::CPR;
  extern __shared__ float4 fd_smem4[];
  T* kvs = reinterpret_cast<T*>(fd_smem4);  // [buffer][K or V][key][ST]
  const int G = Hq / Hkv;
  float* qs = reinterpret_cast<float*>(kvs + 4 * TK * ST);
  float* ps = qs + G * D;
  float* ms = ps + G * TK;
  float* ls = ms + G;
  float* as = ls + G;
  __shared__ int last_sh;

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int len = min(max(valid[b], 0), T_len);
  const int n_act = max(1, (len + ks - 1) / ks);  // an empty row: split 0
  if (split >= n_act) return;
  const int k0 = split * ks, k1 = min(k0 + ks, len);
  const int n_tiles = k1 > k0 ? (k1 - k0 + TK - 1) / TK : 0;
  const int GD = G * D;

  for (int i = tid; i < GD; i += kThreads)
    qs[i] = to_f32(q[(size_t(b) * Hq + h * G) * D + i]) * scale;
  for (int i = tid; i < G; i += kThreads) {
    ms[i] = kNegInf;
    ls[i] = 0.f;
  }
  float acc[kMaxOut];
#pragma unroll
  for (int i = 0; i < kMaxOut; ++i) acc[i] = 0.f;

  // K/V tile `tile` of this split into buffer `buf`; keys past k1 read 0
  auto load_kv = [&](int tile, int buf) {
    for (int i = tid; i < 2 * TK * CPR; i += kThreads) {
      const int which = i / (TK * CPR);
      const int j = (i / CPR) % TK, c = i % CPR;
      const int t = k0 + tile * TK + j;
      const T* base = which ? v : k;
      const bool ok = t < k1;
      const T* src =
          ok ? base + ((size_t(b) * T_len + t) * Hkv + h) * D + c * (16 / sizeof(T))
             : base;
      cp_async16(kvs + ((buf * 2 + which) * TK + j) * ST + c * (16 / sizeof(T)),
                 src, ok);
    }
  };

  if (n_tiles > 0) load_kv(0, 0);
  cp_async_commit();
  for (int jt = 0; jt < n_tiles; ++jt) {
    if (jt + 1 < n_tiles) load_kv(jt + 1, (jt + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile jt has landed; q, m, l are written
    const T* ksm = kvs + ((jt & 1) * 2) * TK * ST;
    const T* vsm = ksm + TK * ST;
    const int tbase = k0 + jt * TK;

    // scores: (head, key) pairs over the threads, f32 dot products
    for (int idx = tid; idx < G * TK; idx += kThreads) {
      const int j = idx % TK, g = idx / TK;
      const T* krow = ksm + j * ST;
      const float* qrow = qs + g * D;
      float s = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; d += 8) {
        float kx[8], qx[8];
        load8(krow + d, kx);
        load8(qrow + d, qx);
#pragma unroll
        for (int e = 0; e < 8; ++e) s = fmaf(qx[e], kx[e], s);
      }
      ps[g * TK + j] = tbase + j < k1 ? s : kNegInf;
    }
    __syncthreads();

    // online softmax, a warp a head
    for (int g = warp; g < G; g += kThreads / 32) {
      float mx = kNegInf;
      for (int j = lane; j < TK; j += 32) mx = fmaxf(mx, ps[g * TK + j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = ms[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < TK; j += 32) {
        const bool live = tbase + j < k1;
        const float p = live ? expf(ps[g * TK + j] - m_new) : 0.f;
        ps[g * TK + j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        as[g] = alpha;
        ls[g] = ls[g] * alpha + sum;
        ms[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V: a thread owns outputs tid + kThreads * i
#pragma unroll
    for (int i = 0; i < kMaxOut; ++i) {
      const int oi = tid + kThreads * i;
      if (oi >= GD) break;
      const int g = oi / D, d = oi % D;
      const float* prow = ps + g * TK;
      float a = acc[i] * as[g];
#pragma unroll 8
      for (int j = 0; j < TK; ++j) a = fmaf(prow[j], to_f32(vsm[j * ST + d]), a);
      acc[i] = a;
    }
    __syncthreads();  // the buffer is reloaded two tiles on
  }
  cp_async_wait<0>();
  __syncthreads();

  // this split's unnormalised partial: acc (G, D), then m (G), l (G)
  const int rh = b * Hkv + h;
  const int splits = gridDim.x;
  float* mine = part + (size_t(rh) * splits + split) * (GD + 2 * G);
#pragma unroll
  for (int i = 0; i < kMaxOut; ++i) {
    const int oi = tid + kThreads * i;
    if (oi < GD) mine[oi] = acc[i];
  }
  for (int i = tid; i < G; i += kThreads) {
    mine[GD + i] = ms[i];
    mine[GD + G + i] = ls[i];
  }
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    last_sh = atomicAdd(count + rh, 1) == n_act - 1;
    // every split has counted: back to zero for the next call
    if (last_sh) count[rh] = 0;
  }
  __syncthreads();
  if (!last_sh) return;
  __threadfence();

  // the last block merges the splits in split order
  const float* base = part + size_t(rh) * splits * (GD + 2 * G);
  for (int g = tid; g < G; g += kThreads) {
    float M = kNegInf;
    for (int s = 0; s < n_act; ++s)
      M = fmaxf(M, __ldcg(base + size_t(s) * (GD + 2 * G) + GD + g));
    float L = 0.f;
    for (int s = 0; s < n_act; ++s) {
      const float* ps_ = base + size_t(s) * (GD + 2 * G);
      L += __ldcg(ps_ + GD + G + g) * expf(__ldcg(ps_ + GD + g) - M);
    }
    ms[g] = M;
    ls[g] = L;
    lse[size_t(b) * Hq + h * G + g] = L > 0.f ? M + logf(L) : kNegInf;
  }
  __syncthreads();
  for (int oi = tid; oi < GD; oi += kThreads) {
    const int g = oi / D;
    const float M = ms[g], L = ls[g];
    float acc_o = 0.f;
    for (int s = 0; s < n_act; ++s) {
      const float* ps_ = base + size_t(s) * (GD + 2 * G);
      acc_o += __ldcg(ps_ + oi) * expf(__ldcg(ps_ + GD + g) - M);
    }
    o[(size_t(b) * Hq + h * G) * D + oi] = L > 0.f ? acc_o / L : 0.f;
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* valid, void* part, void* count, void* o,
                   void* lse, int R, int T_len, int Hq, int Hkv, int ks,
                   float scale, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const size_t smem = Shape<T, D>::smem(G);
  cudaError_t e = cudaFuncSetAttribute(
      fd_partial_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (e != cudaSuccess) return e;
  const int splits = (T_len + ks - 1) / ks;
  dim3 grid(splits, Hkv, R);
  fd_partial_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(valid),
      static_cast<float*>(part), static_cast<int*>(count),
      static_cast<float*>(o), static_cast<float*>(lse), T_len, Hq, Hkv, ks,
      scale);
  return cudaGetLastError();
}

}  // namespace

// ---- the Hopper body: TMA ring + mma.sync, bf16, D = 128 -----------------

namespace tc {

constexpr int D = 128;
constexpr int kWarps = 8;                    // consumer warps
constexpr int kThreads = 32 * (kWarps + 1);  // + the producer warp
constexpr int kStages = 3;
constexpr int kSub = 16;           // keys a warp folds a stage
constexpr int TK = kWarps * kSub;  // keys a stage (a unit): 128
constexpr int kBox = TK * 128;     // a (128 keys, 64 columns) TMA box
constexpr int kStageBytes = 4 * kBox;  // K and V, two column halves each
constexpr int kBar = 1;            // the consumers' named barrier
constexpr int kMaxCols = 4;  // merge columns a thread: D / (256 / G)

// The work plan, walked alike by the producer and the consumers
// (kernels/flash_decode.py `work_plan` is its mirror on the host). A
// row's units are the TK-key tiles of its valid prefix, rows in order,
// U units in all. Blocks come in groups of Hkv, a block a kv head, so a
// group's blocks read the same keys' rows at the same time; group g of
// P = min(launched groups, U) takes units [U g / P, U (g + 1) / P), at
// least one each (an empty share would count as a split that never
// comes). A segment is (row, kv head).
struct Plan {
  const int* valid;
  int R, T, Hkv, groups;

  __device__ int len(int b) const {
    return min(max(__ldg(valid + b), 0), T);
  }
  __device__ int tiles(int b) const { return (len(b) + TK - 1) / TK; }
  __device__ int units_before(int b) const {
    int u = 0;
    for (int i = 0; i < b; ++i) u += tiles(i);
    return u;
  }
  // the group whose share holds unit u of U
  __device__ int group_of(int u, int U) const {
    return int(((u + 1ll) * groups + U - 1) / U - 1);
  }
};

// A group's units [u, u1) of the row list, handed out a row at a time:
// units [t0, t1) of row b, whose first unit is pre.
struct Walk {
  int u, u1, b, pre;
  __device__ bool next(const Plan& pl, int& t0, int& t1) {
    if (u >= u1) return false;
    while (pre + pl.tiles(b) <= u) pre += pl.tiles(b++);
    t0 = u - pre;
    t1 = min(u1 - pre, pl.tiles(b));
    u = pre + t1;
    return true;
  }
};

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// A warp's running state for the G query heads of one kv head: lane l
// holds row g = l / 4 (rows >= G are padding); m and l of that row
// (l a lane's partial: the quad sums it at the end), acc[dt] the mma
// accumulator of columns 8 dt.. (entries 0, 1 of row g; 2, 3 padding)
struct State {
  float m, l;
  float acc[D / 8][4];
};

// Fold 16 keys (`live` of them valid, 1..16) of one kv head into st.
// qa: the A fragments of q (rows 0..7, k16 steps; rows 8..15 are zero);
// k, v: the two [16 keys][64] halves of K and V, 128-byte swizzled at
// 1024-byte-aligned shared addresses. P V runs as P_hi V + P_lo V.
__device__ __forceinline__ void fold16(State& st, const uint32_t (&qa)[8][2],
                                       const uint32_t (&k)[2],
                                       const uint32_t (&v)[2], int live,
                                       float scale, int lane) {
  float s[2][4];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
  {
    // x4: (keys 0-7, d), (keys 0-7, d + 8), (keys 8-15, d), (8-15, d + 8)
    const int key = ((lane >> 4) << 3) + (lane & 7);
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const int c = ((2 * ks) & 7) + ((lane >> 3) & 1);
      uint32_t r[4];
      ldsm4(r, k[ks >> 2] + key * 128 + ((c ^ (key & 7)) << 4));
      const uint32_t a[4] = {qa[ks][0], 0u, qa[ks][1], 0u};
      mma_bf16(s[0], a, r[0], r[1]);
      mma_bf16(s[1], a, r[2], r[3]);
    }
  }
  // my row's scores: keys 8 nt + 2 (lane % 4) + e
  const int k0 = 2 * (lane & 3);
  float x[2][2];
  float mx = kNegInf;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      x[nt][e] = 8 * nt + k0 + e < live ? s[nt][e] * scale : kNegInf;
      mx = fmaxf(mx, x[nt][e]);
    }
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
  const float m_new = fmaxf(st.m, mx);  // key 0 is live: finite
  const float alpha = expf(st.m - m_new);
  float p[2][2], sum = 0.f;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      p[nt][e] = 8 * nt + k0 + e < live ? expf(x[nt][e] - m_new) : 0.f;
      sum += p[nt][e];
    }
  st.l = st.l * alpha + sum;
  st.m = m_new;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    st.acc[dt][0] *= alpha;
    st.acc[dt][1] *= alpha;
  }
  // P = hi + lo as two bf16 A operands (rows 8..15 zero)
  uint32_t hi[4] = {0u, 0u, 0u, 0u}, lo[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(p[nt][0], p[nt][1]);
    const float2 hf = __bfloat1622float2(h);
    hi[2 * nt] = *reinterpret_cast<const uint32_t*>(&h);
    lo[2 * nt] = pack_bf16(p[nt][0] - hf.x, p[nt][1] - hf.y);
  }
  // V fragments of keys past `live` to zero: p is 0 there, but the
  // cache past the valid prefix may hold anything (NaN * 0 is NaN)
  const uint32_t mk0 = (k0 < live ? 0xffffu : 0u) |
                       (k0 + 1 < live ? 0xffff0000u : 0u);
  const uint32_t mk1 = (k0 + 8 < live ? 0xffffu : 0u) |
                       (k0 + 9 < live ? 0xffff0000u : 0u);
  {
    // x4 trans: (keys 0-7, n-tile 2 dp), (keys 8-15, 2 dp),
    // (keys 0-7, 2 dp + 1), (keys 8-15, 2 dp + 1)
    const int key = (((lane >> 3) & 1) << 3) + (lane & 7);
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      const int c = ((2 * dp) & 7) + (lane >> 4);
      uint32_t b[4];
      ldsm4_t(b, v[dp >> 2] + key * 128 + ((c ^ (key & 7)) << 4));
      b[0] &= mk0;
      b[1] &= mk1;
      b[2] &= mk0;
      b[3] &= mk1;
      mma_bf16(st.acc[2 * dp], hi, b[0], b[1]);
      mma_bf16(st.acc[2 * dp + 1], hi, b[2], b[3]);
      mma_bf16(st.acc[2 * dp], lo, b[0], b[1]);
      mma_bf16(st.acc[2 * dp + 1], lo, b[2], b[3]);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
fd_tc_kernel(const __grid_constant__ CUtensorMap map_k,
             const __grid_constant__ CUtensorMap map_v,
             const bf16* __restrict__ q, const int* __restrict__ valid,
             float* part, int* count, float* __restrict__ o,
             float* __restrict__ lse, int R, int T, int Hq, int Hkv,
             float scale) {
  extern __shared__ uint8_t tc_smem[];
  __shared__ __align__(8) uint64_t full_bar[kStages], empty_bar[kStages];
  __shared__ int last_sh;
  const int G = Hq / Hkv, GD = G * D, W = GD + 2 * G;  // a state's floats
  const uint32_t base = (hopper::smem_addr(tc_smem) + 1023) & ~1023u;
  // the warps' states for the merge: kWarps x (acc (G, D), m (G), l (G))
  float* scratch = reinterpret_cast<float*>(
      tc_smem + (base - hopper::smem_addr(tc_smem)) +
      size_t(kStages) * kStageBytes);
  Plan pl{valid, R, T, Hkv, int(gridDim.x) / Hkv};
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      hopper::mbar_init(hopper::smem_addr(&full_bar[i]), 1);
      hopper::mbar_init(hopper::smem_addr(&empty_bar[i]), kWarps);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  // an empty row: o = 0, lse = NEG_INF, written by block b % blocks
  for (int b = blockIdx.x; b < R; b += gridDim.x)
    if (pl.len(b) == 0)
      for (int i = tid; i < Hq * (D + 1); i += kThreads) {
        if (i < Hq * D)
          o[size_t(b) * Hq * D + i] = 0.f;
        else
          lse[size_t(b) * Hq + i - Hq * D] = kNegInf;
      }

  // my kv head h of group g, and the group's units of the row list
  const int U = pl.units_before(R);
  const int g = blockIdx.x / Hkv, h = blockIdx.x % Hkv;
  pl.groups = min(pl.groups, U);
  if (g >= pl.groups) return;
  Walk wk{int(1ll * U * g / pl.groups), int(1ll * U * (g + 1) / pl.groups),
          0, 0};

  if (warp == kWarps) {  // the producer warp: one thread issues the loads
    if (lane != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    int t0, t1;
    while (wk.next(pl, t0, t1)) {
      for (int t = t0; t < t1; ++t) {
        const int key = wk.b * T + t * TK;
        const uint32_t fb = hopper::smem_addr(&full_bar[stage]);
        hopper::mbar_wait_quiet(hopper::smem_addr(&empty_bar[stage]),
                                phase ^ 1);
        const uint32_t st = base + stage * kStageBytes;
        hopper::mbar_expect_tx(fb, kStageBytes);
        for (int j = 0; j < 2; ++j) {  // K then V, two column halves each
          hopper::tma_load_3d(st + j * kBox, &map_k, fb, 0, 2 * h + j, key);
          hopper::tma_load_3d(st + (2 + j) * kBox, &map_v, fb, 0, 2 * h + j,
                              key);
        }
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // the consumer warps
  int stage = 0;
  uint32_t phase = 0;
  const int gq = lane >> 2;  // my row of the query group
  // the merges' rows: TPR threads a query row of D columns
  const int TPR = kWarps * 32 / G, rg = tid / TPR, lane_r = tid % TPR;
  int t0, t1;
  while (wk.next(pl, t0, t1)) {
    const int b = wk.b, len = pl.len(b);
    // my q rows as A fragments (unscaled bf16), and a fresh state
    uint32_t qa[8][2];
    {
      const uint32_t* qr = reinterpret_cast<const uint32_t*>(
          q + (size_t(b) * Hq + size_t(h) * G + (gq < G ? gq : 0)) * D);
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        qa[ks][0] = gq < G ? __ldg(qr + 8 * ks + (lane & 3)) : 0u;
        qa[ks][1] = gq < G ? __ldg(qr + 8 * ks + 4 + (lane & 3)) : 0u;
      }
    }
    State st;
    st.m = kNegInf;
    st.l = 0.f;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) st.acc[dt][e] = 0.f;

    for (int t = t0; t < t1; ++t) {
      hopper::mbar_wait_quiet(hopper::smem_addr(&full_bar[stage]), phase);
      // my 16 keys of the stage's 128, in each of its four boxes
      const uint32_t k0 = base + stage * kStageBytes + warp * kSub * 128;
      const uint32_t kb[2] = {k0, k0 + kBox};
      const uint32_t vb[2] = {k0 + 2 * kBox, k0 + 3 * kBox};
      const int live = min(max(len - t * TK - kSub * warp, 0), kSub);
      if (live > 0) fold16(st, qa, kb, vb, live, scale, lane);
      __syncwarp();
      hopper::mbar_arrive_if(hopper::smem_addr(&empty_bar[stage]),
                             lane == 0);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }

    // the piece's end: my state into the scratch
    st.l += __shfl_xor_sync(0xffffffffu, st.l, 1);
    st.l += __shfl_xor_sync(0xffffffffu, st.l, 2);
    if (gq < G) {
      float* sc = scratch + warp * W;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
        *reinterpret_cast<float2*>(sc + gq * D + 8 * dt + 2 * (lane & 3)) =
            make_float2(st.acc[dt][0], st.acc[dt][1]);
      if ((lane & 3) == 0) {
        sc[GD + gq] = st.m;
        sc[GD + G + gq] = st.l;
      }
    }
    hopper::named_sync(kBar, kWarps * 32);
    // the warps' states merged in warp order; the row's split j of ns
    // (the groups whose shares meet it), slot (b + first + j) Hkv + h
    const int first = pl.group_of(wk.pre, U);
    const int ns = pl.group_of(wk.pre + pl.tiles(b) - 1, U) - first + 1;
    float* orow = o + (size_t(b) * Hq + size_t(h) * G + rg) * D;
    float* lrow = lse + size_t(b) * Hq + h * G + rg;
    if (rg < G) {
      float M = kNegInf, L = 0.f, f[kWarps];
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        M = fmaxf(M, scratch[w * W + GD + rg]);
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        f[w] = expf(scratch[w * W + GD + rg] - M);
        L += scratch[w * W + GD + G + rg] * f[w];
      }
      float* slot = part + (size_t(b + g) * Hkv + h) * W;
      for (int d = lane_r; d < D; d += TPR) {
        float A = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w)
          A += scratch[w * W + rg * D + d] * f[w];
        if (ns == 1)
          orow[d] = A / L;
        else
          slot[rg * D + d] = A;
      }
      if (lane_r == 0) {
        if (ns == 1) {
          *lrow = M + logf(L);
        } else {
          slot[GD + rg] = M;
          slot[GD + G + rg] = L;
        }
      }
    }
    hopper::named_sync(kBar, kWarps * 32);  // the scratch is free again
    if (ns > 1) {
      int* ctr = count + size_t(b) * Hkv + h;  // the segment's counter
      if (tid == 0) {
        __threadfence();
        const bool last = atomicAdd(ctr, 1) == ns - 1;
        if (last) *ctr = 0;  // every split has counted
        last_sh = last;
      }
      hopper::named_sync(kBar, kWarps * 32);
      if (last_sh && rg < G) {
        // the last split to count merges the slots in split order; a
        // thread's columns load together, a split at a time
        __threadfence();
        float M = kNegInf, L = 0.f, A[kMaxCols];
        for (int j = 0; j < ns; ++j)
          M = fmaxf(M, __ldcg(part + (size_t(b + first + j) * Hkv + h) * W +
                              GD + rg));
#pragma unroll
        for (int c = 0; c < kMaxCols; ++c) A[c] = 0.f;
        for (int j = 0; j < ns; ++j) {
          const float* p = part + (size_t(b + first + j) * Hkv + h) * W;
          const float f = expf(__ldcg(p + GD + rg) - M);
          L += __ldcg(p + GD + G + rg) * f;
#pragma unroll
          for (int c = 0; c < kMaxCols; ++c)
            if (lane_r + c * TPR < D)
              A[c] += __ldcg(p + rg * D + lane_r + c * TPR) * f;
        }
#pragma unroll
        for (int c = 0; c < kMaxCols; ++c)
          if (lane_r + c * TPR < D) orow[lane_r + c * TPR] = A[c] / L;
        if (lane_r == 0) *lrow = M + logf(L);
      }
    }
  }
}

// K or V (rows * T, Hkv, 128) bf16 as a 3-D map (64 elements, 2 Hkv
// 128-byte column halves of a key's row, rows * T keys), boxes of (64,
// 1, TK): TK keys of one half of one kv head
bool encode_kv(CUtensorMap* map, const void* p, int keys, int Hkv) {
  const uint64_t dims[3] = {64, uint64_t(2 * Hkv), uint64_t(keys)};
  const uint64_t strides[2] = {128, uint64_t(Hkv) * D * 2};
  const uint32_t box[3] = {64, 1, uint32_t(TK)};
  return hopper::encode_bf16(map, p, 3, dims, strides, box);
}

cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* valid, void* part, void* count, void* o,
                   void* lse, int R, int T, int Hq, int Hkv, int groups,
                   float scale, cudaStream_t stream) {
  CUtensorMap maps[2];
  if (!encode_kv(&maps[0], k, R * T, Hkv) ||
      !encode_kv(&maps[1], v, R * T, Hkv))
    return cudaErrorInvalidValue;
  const int G = Hq / Hkv;
  const size_t smem = size_t(kStages) * kStageBytes + 1024 +
                      sizeof(float) * kWarps * (G * D + 2 * G);
  cudaError_t e = cudaFuncSetAttribute(
      fd_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  fd_tc_kernel<<<groups * Hkv, kThreads, smem, stream>>>(
      maps[0], maps[1], static_cast<const bf16*>(q),
      static_cast<const int*>(valid), static_cast<float*>(part),
      static_cast<int*>(count), static_cast<float*>(o),
      static_cast<float*>(lse), R, T, Hq, Hkv, scale);
  return cudaGetLastError();
}

}  // namespace tc

// The FMA body's scratch: part floats, and one zeroed int a (row, kv
// head), which the merging block leaves at zero.
extern "C" long long fd_part_floats(int R, int T_len, int Hq, int Hkv, int D,
                                    int ks) {
  const long long G = Hq / Hkv, splits = (T_len + ks - 1) / ks;
  return (long long)R * Hkv * splits * (G * D + 2 * G);
}

// dtype: 0 = float32, 1 = bfloat16. ks: keys a split, a multiple of the
// tile (64). Returns a cudaError_t (0 = launched).
extern "C" int fd_partial_launch(const void* q, const void* k, const void* v,
                                 const void* valid, void* part, void* count,
                                 void* o, void* lse, int R, int T_len, int Hq,
                                 int Hkv, int D, int dtype, int ks,
                                 float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Hkv <= 0 || Hq % Hkv != 0 || ks <= 0 || ks % 64 != 0 || T_len < 1 ||
      (Hq / Hkv) * D > kThreads * kMaxOut)
    return int(cudaErrorInvalidValue);
  if (dtype == 0 && D == 128)
    return int(launch<float, 128>(q, k, v, valid, part, count, o, lse, R, T_len, Hq, Hkv, ks, scale, st));
  if (dtype == 0 && D == 64)
    return int(launch<float, 64>(q, k, v, valid, part, count, o, lse, R, T_len, Hq, Hkv, ks, scale, st));
  if (dtype == 1 && D == 128)
    return int(launch<bf16, 128>(q, k, v, valid, part, count, o, lse, R, T_len, Hq, Hkv, ks, scale, st));
  if (dtype == 1 && D == 64)
    return int(launch<bf16, 64>(q, k, v, valid, part, count, o, lse, R, T_len, Hq, Hkv, ks, scale, st));
  return int(cudaErrorInvalidValue);
}

// The Hopper body's scratch: `groups` groups of Hkv blocks (one an SM);
// part floats, a slot a (row + group, kv head) of G * D + 2 G floats;
// and one zeroed int a (row, kv head), which the merging block leaves at
// zero.
extern "C" long long fd_tc_part_floats(int R, int Hq, int Hkv, int groups) {
  const long long G = Hq / Hkv;
  return (long long)(R + groups) * Hkv * (G * tc::D + 2 * G);
}

// q (R, Hq, 128), k and v (R, T, Hkv, 128) bf16, 16-byte aligned; valid
// (R,) int32; o (R, Hq, 128), lse (R, Hq) f32; G = Hq / Hkv <= 8.
// Returns a cudaError_t (0 = launched).
extern "C" int fd_tc_launch(const void* q, const void* k, const void* v,
                            const void* valid, void* part, void* count,
                            void* o, void* lse, int R, int T, int Hq,
                            int Hkv, int groups, float scale, void* stream) {
  if (R < 1 || T < 1 || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > 8 ||
      groups < 1)
    return int(cudaErrorInvalidValue);
  return int(tc::launch(q, k, v, valid, part, count, o, lse, R, T, Hq, Hkv,
                        groups, scale, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* fd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
