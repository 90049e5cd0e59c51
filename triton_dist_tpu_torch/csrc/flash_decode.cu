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
// The TPU kernel runs one grid step a row. At world 4, batch 4, that
// would be 16 blocks for 132 SMs, so here each (row, kv head) is split
// over blocks along the keys (the reference's split-KV kernel): block
// (split, kv head, row) folds keys [split * ks, (split + 1) * ks) of the
// valid prefix for the G query heads of its kv head, and writes its
// unnormalised (acc, m, l) to scratch. The last block of a (row, kv
// head) to finish (a counter, the classic fence-then-count reduction)
// merges the splits in split order and writes (o, lse): the result does
// not depend on which block finished last. Splits past the valid prefix
// exit at once; an empty row is one split that folds nothing.
//
// What bounds it on an H100: bytes. Each valid key costs 2 * Hkv * D
// elements of K and V for 4 * Hq * D operations, ~4 operations a byte
// in bf16, far below the ~295 of the tensor cores; so the kernel reads
// each K/V tile once (cp.async, double-buffered, tiles of TK keys in
// shared memory, reused by the G heads of the group) and does its
// arithmetic in f32 on the CUDA cores. Not done yet: a finer split when
// the rows are few, and a wider load pipeline.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// The scratch the wrapper allocates: part floats, and one zeroed int a
// (row, kv head).
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

extern "C" const char* fd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
