// Local flash prefill (GQA, online softmax) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `_fp_local_kernel` reached through
// `flash_prefill_local` in triton_dist_tpu/kernels/flash_prefill.py.
// Same function: out[b,s,hq] = softmax over the live keys of
// (q . k) * scale, weighted sum of v, where key t is live when
// t < kv_len[b] and, if causal, t <= q_positions[b,s]. Query head hq
// reads kv head hq / (Hq / Hkv). A row with no live key outputs 0.
// Keys past min(kv_len[b], 1 + the largest q position of the block)
// are never read (the TPU kernel's dead-page skip, per block here).
//
// What bounds it on an H100. The work is 4*S*T*D operations per query
// head against S*Hq*D + 2*T*Hkv*D input elements. A 64-token serve
// chunk against a 1k cache does about 160 operations per byte read:
// below the card's ~295 bf16 operations per byte, so device memory
// bounds it. A 2k causal prefill does ~800 per byte: the tensor cores'
// rate bounds it.
//
// Design. A query row is a (position, head-of-the-group) pair; one
// block of 4 warps takes a tile of rows of one (batch row, kv head), so
// all G query heads sharing a kv head sit in the same block and each
// K/V tile is read from device memory once per group: the reuse the
// TPU kernel gets from its (block, Hkv*D) pages. Softmax state and
// accumulation are f32; a fully masked tile leaves m unchanged, so
// alpha = 1 and p = 0 and it folds as a no-op, as in the TPU kernel.
// Two bodies:
//
//   bf16 (the model's path): 64 rows per block, 16 per warp. Both
//   products run on the tensor cores as mma.sync m16n8k16 (bf16 in,
//   f32 accumulate); Q, K and V tiles are staged in shared memory with
//   cp.async, K/V double-buffered so the next 64-key tile loads while
//   this one is folded; rows padded by 16 bytes so ldmatrix is free of
//   bank conflicts. The scores stay in registers and turn into the A
//   operand of the P.V product directly (P rounded to bf16 there, as in
//   FlashAttention-2).
//   f32: 32 rows per block, plain FMA on the CUDA cores, K/V staged as
//   f32; it exists so the kernel can be held to a tight tolerance.
//
// Not done yet: wgmma, TMA, warp specialisation and a persistent grid,
// which the tensor-core peak needs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile.cuh"

namespace {

// ---- f32 body: FMA on the CUDA cores ------------------------------------

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 8;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kTile = 32;                     // keys per tile (one per lane)
constexpr float kNegInf = -1e30f;             // the TPU kernel's NEG_INF

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// K tile row stride in floats: the pad makes the float4 reads of 8 lanes
// hit distinct banks
template <int D>
constexpr int kKStride = D + 4;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t(kRows) * D            // q rows, pre-scaled
                          + size_t(kTile) * kKStride<D>  // K tile
                          + size_t(kTile) * D              // V tile
                          + size_t(kRows) * kTile);        // p of each row
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
fp_local_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const int* __restrict__ qpos,
                const int* __restrict__ kv_len, float* __restrict__ out,
                int S, int T_len, int Hq, int Hkv, int causal, float scale) {
  constexpr int KS = kKStride<D>;
  constexpr int DPL = D / 32;  // output columns per lane
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + kRows * D;
  float* vs = ks + kTile * KS;
  float* ps = vs + kTile * D;
  __shared__ int row_pos[kRows];
  __shared__ int block_hi;

  const int G = Hq / Hkv;
  const int b = blockIdx.z, h = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const int n_rows = S * G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int len = min(kv_len[b], T_len);

  // stage this block's query rows (row = s * G + g), pre-scaled
  for (int i = tid; i < kRows * D; i += kWarps * 32) {
    const int r = i / D, d = i % D, gr = row0 + r;
    float x = 0.f;
    if (gr < n_rows) {
      const int s = gr / G, hq = h * G + gr % G;
      x = q[((size_t(b) * S + s) * Hq + hq) * D + d] * scale;
    }
    qs[i] = x;
  }
  if (tid < kRows) {
    const int gr = row0 + tid;
    row_pos[tid] = gr < n_rows ? qpos[size_t(b) * S + gr / G] : -1;
  }
  __syncthreads();
  if (tid == 0) {
    int hi = len;
    if (causal) {
      int mx = -1;
      for (int r = 0; r < kRows; ++r) mx = max(mx, row_pos[r]);
      hi = min(hi, mx + 1);
    }
    block_hi = max(hi, 0);
  }
  __syncthreads();
  const int hi = block_hi;

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DPL];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[i][e] = 0.f;
  }
  const int rbase = warp * kRowsPerWarp;

  for (int k0 = 0; k0 < hi; k0 += kTile) {
    for (int i = tid; i < kTile * D; i += kWarps * 32) {
      const int j = i / D, d = i % D, t = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (t < hi) {
        const size_t off = ((size_t(b) * T_len + t) * Hkv + h) * D + d;
        kx = k[off];
        vx = v[off];
      }
      ks[j * KS + d] = kx;
      vs[j * D + d] = vx;
    }
    __syncthreads();

    // scores: lane owns key k0 + lane
    float sc[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) sc[i] = 0.f;
    const float* krow = ks + lane * KS;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float4 qq = *reinterpret_cast<const float4*>(qs + (rbase + i) * D + d);
        sc[i] += qq.x * kk.x + qq.y * kk.y + qq.z * kk.z + qq.w * kk.w;
      }
    }
    const int t = k0 + lane;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const bool live = t < len && (!causal || t <= row_pos[rbase + i]);
      const float lg = live ? sc[i] : kNegInf;
      const float m_new = fmaxf(m[i], warp_max(lg));
      const float alpha = expf(m[i] - m_new);
      const float p = live ? expf(lg - m_new) : 0.f;
      l[i] = l[i] * alpha + warp_sum(p);
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[i][e] *= alpha;
      ps[(rbase + i) * kTile + lane] = p;
    }
    __syncwarp();

    // weighted sum: lane owns columns lane*DPL .. lane*DPL + DPL - 1
#pragma unroll 2
    for (int j = 0; j < kTile; j += 4) {
      float vv[4][DPL];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int e = 0; e < DPL; ++e) vv[jj][e] = vs[(j + jj) * D + lane * DPL + e];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float4 pp = *reinterpret_cast<const float4*>(ps + (rbase + i) * kTile + j);
#pragma unroll
        for (int e = 0; e < DPL; ++e)
          acc[i][e] += pp.x * vv[0][e] + pp.y * vv[1][e] + pp.z * vv[2][e] + pp.w * vv[3][e];
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int gr = row0 + rbase + i;
    if (gr >= n_rows) continue;
    const int s = gr / G, hq = h * G + gr % G;
    float* o = out + ((size_t(b) * S + s) * Hq + hq) * D + lane * DPL;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) o[e] = l[i] > 0.f ? acc[i][e] * inv : 0.f;
  }
}

template <int D>
cudaError_t launch_fma(const void* q, const void* k, const void* v,
                   const void* qpos, const void* kv_len, void* out, int B,
                   int S, int T_len, int Hq, int Hkv, int causal, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        fp_local_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const int G = Hq / Hkv;
  dim3 grid((S * G + kRows - 1) / kRows, Hkv, B);
  fp_local_kernel<D><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(qpos),
      static_cast<const int*>(kv_len), static_cast<float*>(out), S, T_len, Hq,
      Hkv, causal, scale);
  return cudaGetLastError();
}

// ---- bf16 body: mma.sync on the tensor cores ----------------------------

constexpr int kTcRows = 64;  // query rows per block: one m16 tile per warp
constexpr int kTcKeys = 64;  // keys per K/V tile
constexpr float kLog2e = 1.4426950408889634f;

// smem row stride in bf16: +16 bytes per row keeps ldmatrix's 8 row
// addresses on distinct banks
template <int D>
constexpr int kTcStride = D + 8;

template <int D>
constexpr size_t tc_smem_bytes() {
  // Q tile + two buffers of (K tile, V tile)
  return sizeof(bf16) * size_t(kTcStride<D>) * (kTcRows + 4 * kTcKeys);
}

// Fragment layouts as in tile.cuh: a row is a query row; a column is a
// key (scores) or a head-dim element (output).
template <int D>
__global__ void __launch_bounds__(128)
fp_local_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const int* __restrict__ qpos,
                    const int* __restrict__ kv_len, bf16* __restrict__ out,
                    int S, int T_len, int Hq, int Hkv, int causal,
                    float scale) {
  constexpr int ST = kTcStride<D>;
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  extern __shared__ uint4 tc_smem[];
  bf16* qs = reinterpret_cast<bf16*>(tc_smem);
  bf16* kvs = qs + kTcRows * ST;  // [buffer][K or V][key][ST]
  __shared__ int row_pos[kTcRows];
  __shared__ int block_hi;

  const int G = Hq / Hkv;
  const int b = blockIdx.z, h = blockIdx.y;
  const int row0 = blockIdx.x * kTcRows;
  const int n_rows = S * G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int len = min(kv_len[b], T_len);

  // stage the Q tile: row r = s * G + g reads q[b, s, h * G + g, :]
  for (int i = tid; i < kTcRows * CPR; i += 128) {
    const int r = i / CPR, c = i % CPR, gr = row0 + r;
    const bool ok = gr < n_rows;
    const bf16* src =
        ok ? q + ((size_t(b) * S + gr / G) * Hq + h * G + gr % G) * D + c * 8
           : q;
    cp_async16(qs + r * ST + c * 8, src, ok);
  }
  cp_async_commit();
  if (tid < kTcRows) {
    const int gr = row0 + tid;
    row_pos[tid] = gr < n_rows ? qpos[size_t(b) * S + gr / G] : -1;
  }
  __syncthreads();
  if (tid == 0) {
    int hi = len;
    if (causal) {
      int mx = -1;
      for (int r = 0; r < kTcRows; ++r) mx = max(mx, row_pos[r]);
      hi = min(hi, mx + 1);
    }
    block_hi = max(hi, 0);
  }
  __syncthreads();
  const int hi = block_hi;
  const int n_tiles = (hi + kTcKeys - 1) / kTcKeys;

  // K/V tile `tile` into buffer `buf`; keys at or past hi read as 0
  auto load_kv = [&](int tile, int buf) {
    for (int i = tid; i < 2 * kTcKeys * CPR; i += 128) {
      const int which = i / (kTcKeys * CPR);
      const int j = (i / CPR) % kTcKeys, c = i % CPR;
      const int t = tile * kTcKeys + j;
      const bf16* base = which ? v : k;
      const bool ok = t < hi;
      const bf16* src =
          ok ? base + ((size_t(b) * T_len + t) * Hkv + h) * D + c * 8 : base;
      cp_async16(kvs + ((buf * 2 + which) * kTcKeys + j) * ST + c * 8, src,
                 ok);
    }
  };

  const int wr = warp * 16;  // this warp's first row in the tile
  const int cq = (lane & 3) * 2;
  const int pos_lo = row_pos[wr + (lane >> 2)];
  const int pos_hi = row_pos[wr + (lane >> 2) + 8];
  const float sl2 = scale * kLog2e;  // scores in the log2 domain
  float o[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  if (n_tiles > 0) {
    load_kv(0, 0);
    cp_async_commit();
  }
  for (int jt = 0; jt < n_tiles; ++jt) {
    if (jt + 1 < n_tiles) load_kv(jt + 1, (jt + 1) & 1);
    cp_async_commit();  // possibly empty: keeps the group count uniform
    cp_async_wait<1>();  // Q and tile jt have landed
    __syncthreads();
    const bf16* ks = kvs + ((jt & 1) * 2) * kTcKeys * ST;
    const bf16* vs = ks + kTcKeys * ST;

    // scores S = Q K^T: 16 rows x 64 keys per warp
    float s[kTcKeys / 8][4];
#pragma unroll
    for (int nt = 0; nt < kTcKeys / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, qs + (wr + (lane & 7) + 8 * ((lane >> 3) & 1)) * ST +
                     kk * 16 + 8 * (lane >> 4));
#pragma unroll
      for (int nt = 0; nt < kTcKeys / 8; nt += 2) {
        uint32_t bk[4];
        ldsm_x4(bk, ks + (nt * 8 + (lane & 7) + 8 * (lane >> 4)) * ST +
                        kk * 16 + 8 * ((lane >> 3) & 1));
        mma_bf16(s[nt], a, bk[0], bk[1]);
        mma_bf16(s[nt + 1], a, bk[2], bk[3]);
      }
    }

    // mask, online softmax (f32, log2 domain)
    const int kbase = jt * kTcKeys;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < kTcKeys / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = kbase + nt * 8 + cq + (e & 1);
        const int pos = e < 2 ? pos_lo : pos_hi;
        const bool live = t < len && (!causal || t <= pos);
        const float x = live ? s[nt][e] * sl2 : kNegInf;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int nt = 0; nt < kTcKeys / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[nt][e];
        const float p = x == kNegInf ? 0.f : exp2f(x - m[e >> 1]);
        s[nt][e] = p;
        l[e >> 1] += p;  // per-lane partial; the quad sums at the end
      }
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      o[dt][0] *= alpha[0];
      o[dt][1] *= alpha[0];
      o[dt][2] *= alpha[1];
      o[dt][3] *= alpha[1];
    }

    // O += P V: the score fragments are the A operand, V the B operand
#pragma unroll
    for (int kk = 0; kk < kTcKeys / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dt = 0; dt < D / 8; dt += 2) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, vs + (kk * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) *
                                   ST + dt * 8 + 8 * (lane >> 4));
        mma_bf16(o[dt], a, bv[0], bv[1]);
        mma_bf16(o[dt + 1], a, bv[2], bv[3]);
      }
    }
    __syncthreads();  // the buffer is reloaded two tiles on
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int gr = row0 + wr + (lane >> 2) + 8 * r;
    if (gr >= n_rows) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
    bf16* orow =
        out + ((size_t(b) * S + gr / G) * Hq + h * G + gr % G) * D + cq;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(orow + dt * 8) =
          __floats2bfloat162_rn(o[dt][2 * r] * inv, o[dt][2 * r + 1] * inv);
  }
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       const void* qpos, const void* kv_len, void* out, int B,
                       int S, int T_len, int Hq, int Hkv, int causal,
                       float scale, cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes<D>();
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        fp_local_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const int G = Hq / Hkv;
  dim3 grid((S * G + kTcRows - 1) / kTcRows, Hkv, B);
  fp_local_mma_kernel<D><<<grid, 128, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int*>(qpos),
      static_cast<const int*>(kv_len), static_cast<bf16*>(out), S, T_len, Hq,
      Hkv, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int fp_local_launch(const void* q, const void* k, const void* v,
                               const void* qpos, const void* kv_len,
                               void* out, int B, int S, int T_len, int Hq,
                               int Hkv, int D, int dtype, int causal,
                               float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Hkv <= 0 || Hq % Hkv != 0) return int(cudaErrorInvalidValue);
  if (dtype == 0 && D == 128)
    return int(launch_fma<128>(q, k, v, qpos, kv_len, out, B, S, T_len, Hq, Hkv, causal, scale, st));
  if (dtype == 0 && D == 64)
    return int(launch_fma<64>(q, k, v, qpos, kv_len, out, B, S, T_len, Hq, Hkv, causal, scale, st));
  if (dtype == 1 && D == 128)
    return int(launch_mma<128>(q, k, v, qpos, kv_len, out, B, S, T_len, Hq, Hkv, causal, scale, st));
  if (dtype == 1 && D == 64)
    return int(launch_mma<64>(q, k, v, qpos, kv_len, out, B, S, T_len, Hq, Hkv, causal, scale, st));
  return int(cudaErrorInvalidValue);
}

extern "C" const char* fp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
