// Flash prefill (GQA, online softmax) for Hopper, sm_90a: the local
// kernel and the sequence-parallel kernel, over one shared fold.
//
// Replaces two Pallas TPU kernels of triton_dist_tpu/kernels/
// flash_prefill.py:
//   `_fp_local_kernel`, reached through `flash_prefill_local`
//   (fp_local_launch): out[b,s,hq] = softmax over the live keys of
//   (q . k) * scale, weighted sum of v, where key t is live when
//   t < kv_len[b] and, if causal, t <= q_positions[b,s];
//   `_fp_sp_kernel`, reached through `sp_flash_prefill` (fp_sp_launch):
//   the same function over a sequence sharded on n ranks of the virtual
//   world (runtime/symm_mem.py), rank r holding query and key rows
//   [r*S, (r+1)*S) of every batch row, kv_len global.
// Query head hq reads kv head hq / (Hq / Hkv). A row with no live key
// outputs 0. Keys past min(kv_len[b], 1 + the largest q position of the
// tile) are never read (the TPU kernels' dead-page skip).
//
// The fold (TcFold, FmaFold). A query row is a (position, head-of-the-
// group) pair; a block of 4 warps takes a tile of rows of one (batch
// row, kv head), so the G query heads sharing a kv head sit in one block
// and each K/V tile is read once per group. Softmax state and
// accumulation are f32; a fully masked tile leaves m unchanged, so
// alpha = 1 and p = 0 and it folds as a bitwise no-op, as in the TPU
// kernels. A fold walks one key range (a segment), so the SP kernel
// folds its segments one after another into the same state.
//   bf16 (the model's path, TcFold): 64 rows a block, 16 a warp; both
//   products on the tensor cores as mma.sync m16n8k16 (bf16 in, f32
//   accumulate); Q, K and V staged in shared memory with cp.async, K/V
//   double-buffered in 64-key tiles; rows padded by 16 bytes so ldmatrix
//   is free of bank conflicts. The scores stay in registers and become
//   the A operand of P.V: P = hi + lo, two bf16 values (hi = bf16(p),
//   lo = bf16(p - hi)), two products. The TPU kernels fold P in f32; a P
//   rounded once to bf16 put single elements of the output tens of bf16
//   quanta off the f32 fold (outside the epsilon band, PERF.md's parity
//   table), the split leaves ~2^-17 of p.
//   f32 (FmaFold): 32 rows a block, FMA on the CUDA cores, K/V staged as
//   f32, so the kernels can be held to a tight tolerance.
//
// The SP kernel. All n ranks run in one cooperative launch
// (shmem::launch_world: grid = blocks a rank x n, every block resident).
// Every block first meets the others (barrier_all: the peers must be in
// the kernel before the first puts land). The first P blocks of each rank
// then push its K and V shards to every peer (shmem::
// segment_collect_start, the JAX package's): for each batch row b,
// offset i = 1..n-1 and tensor (K, V), a 1/P share of the (S, Hkv, D)
// segment into slot i-1 of peer (me + i) mod n's receive buffer, then
// add one to that slot's delivery flag; a segment has arrived when its
// flag counts P. Then every block, producers included, claims query tiles
// from one counter shared by all ranks (one card: rank r's causal
// queries see ~r + 1 segments, so the work is pooled, not split by rank),
// each (batch row, kv head) in turn, the latest positions first. A tile
// of rank r folds its segments in the TPU kernel's swizzle order: its own
// (no wait) first, then chunk (r - i) mod n for i = 1..n-1, waiting on
// exactly that segment's K and V flags of row b; a segment wholly past
// the tile's last live key is skipped (a no-op fold). The fold order is
// fixed by the tile, not by arrival, so the result is bitwise the same
// whatever the timing: `straggler` (shmem::straggler_delay on one rank's
// producers) checks that. No deadlock: producers wait on nothing after
// the barrier; a tile waits only on producers, which never wait on a
// tile; every spin is bounded and traps.
//
// What bounds them on an H100. The work is 4*D operations a live (query
// head, key) pair against S*Hq*D + 2*T*Hkv*D input elements. A 64-token
// serve chunk against a 1k cache does ~160 operations a byte read: below
// the card's ~295 bf16 operations a byte, so device memory bounds it. A
// long causal prefill does thousands: the tensor cores' rate bounds it
// (the SP path at 32k positions: 2.75e13 operations, 27.8 ms at 989
// TFLOP/s). The SP kernel's segment push moves (n-1) shards a rank
// (1.5 GB at 32k, ~1 ms of HBM time), overlapped with the local folds.
// Not done yet: wgmma, TMA, warp specialisation, 128-row tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "shmem.cuh"
#include "tile.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernels' NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

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

// Keys of one fold: key position t lives at k + (t - origin) * stride
// (elements; v alike), and the fold covers positions [begin, end). A key
// is live when t < end, t < len and, if causal, t <= the row's position.
template <typename T>
struct Keys {
  const T* k;
  const T* v;
  long long stride;
  int origin, begin, end;
};

// ---- f32 fold: FMA on the CUDA cores -------------------------------------

template <int D>
struct FmaFold {
  typedef float T;
  static constexpr int kD = D;
  static constexpr int kWarps = 4, kRowsPerWarp = 8;
  static constexpr int kRows = kWarps * kRowsPerWarp;  // query rows a block
  static constexpr int kTile = 32;                     // keys a tile (a lane each)
  static constexpr int KS = D + 4;  // K row stride: float4 reads of 8 lanes on distinct banks
  static constexpr int DPL = D / 32;  // output columns a lane
  static constexpr size_t kSmem =
      sizeof(float) * (size_t(kRows) * D + size_t(kTile) * KS +
                       size_t(kTile) * D + size_t(kRows) * kTile);

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DPL];

  // stage the tile's rows: row_src(r) is row r's q (D elements) or null
  template <typename RowSrc>
  __device__ __forceinline__ void stage(void* smem, RowSrc row_src,
                                        float scale, const float*) {
    float* qs = static_cast<float*>(smem);
    for (int i = threadIdx.x; i < kRows * D; i += kWarps * 32) {
      const float* src = row_src(i / D);
      qs[i] = src != nullptr ? src[i % D] * scale : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      m[i] = kNegInf;
      l[i] = 0.f;
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[i][e] = 0.f;
    }
  }

  __device__ __forceinline__ void fold(void* smem, const int* row_pos,
                                       const Keys<float>& key, int len,
                                       int causal) {
    float* qs = static_cast<float*>(smem);
    float* ks = qs + kRows * D;
    float* vs = ks + kTile * KS;
    float* ps = vs + kTile * D;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int rbase = warp * kRowsPerWarp;
    for (int k0 = key.begin; k0 < key.end; k0 += kTile) {
      __syncthreads();  // q staged; the previous tile's K/V read
      for (int i = tid; i < kTile * D; i += kWarps * 32) {
        const int j = i / D, d = i % D, t = k0 + j;
        float kx = 0.f, vx = 0.f;
        if (t < key.end) {
          const size_t off = size_t(t - key.origin) * key.stride + d;
          kx = __ldcg(key.k + off);
          vx = __ldcg(key.v + off);
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
        const bool live = t < key.end && t < len &&
                          (!causal || t <= row_pos[rbase + i]);
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
    }
    __syncthreads();  // the K/V buffers are free for the next fold
  }

  // row_dst(r) is row r's output (D elements) or null
  template <typename RowDst>
  __device__ __forceinline__ void store(RowDst row_dst) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      float* o = row_dst(warp * kRowsPerWarp + i);
      if (o == nullptr) continue;
      const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
#pragma unroll
      for (int e = 0; e < DPL; ++e)
        o[lane * DPL + e] = l[i] > 0.f ? acc[i][e] * inv : 0.f;
    }
  }
};

// ---- bf16 fold: mma.sync on the tensor cores ------------------------------

template <int D>
struct TcFold {
  typedef bf16 T;
  static constexpr int kD = D;
  static constexpr int kRows = 64;  // query rows a block: one m16 tile a warp
  static constexpr int kKeys = 64;  // keys a K/V tile
  static constexpr int ST = D + 8;  // smem row stride: +16 bytes
  static constexpr int CPR = D / 8;  // 16-byte chunks a row
  // Q tile + two buffers of (K tile, V tile)
  static constexpr size_t kSmem = sizeof(bf16) * size_t(ST) * (kRows + 4 * kKeys);

  float o[D / 8][4];
  float m[2], l[2];
  float sl2;  // scale in the log2 domain

  // any: a global address for the zero-filled rows' empty copies
  template <typename RowSrc>
  __device__ __forceinline__ void stage(void* smem, RowSrc row_src,
                                        float scale, const bf16* any) {
    bf16* qs = static_cast<bf16*>(smem);
    for (int i = threadIdx.x; i < kRows * CPR; i += 128) {
      const int r = i / CPR, c = i % CPR;
      const bf16* src = row_src(r);
      cp_async16(qs + r * ST + c * 8, src != nullptr ? src + c * 8 : any,
                 src != nullptr);
    }
    cp_async_commit();
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
    m[0] = m[1] = kNegInf;
    l[0] = l[1] = 0.f;
    sl2 = scale * kLog2e;
  }

  __device__ __forceinline__ void fold(void* smem, const int* row_pos,
                                       const Keys<bf16>& key, int len,
                                       int causal) {
    if (key.end <= key.begin) return;
    bf16* qs = static_cast<bf16*>(smem);
    bf16* kvs = qs + kRows * ST;  // [buffer][K or V][key][ST]
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int n_tiles = (key.end - key.begin + kKeys - 1) / kKeys;
    auto load_kv = [&](int tile, int buf) {
      for (int i = tid; i < 2 * kKeys * CPR; i += 128) {
        const int which = i / (kKeys * CPR);
        const int j = (i / CPR) % kKeys, c = i % CPR;
        const int t = key.begin + tile * kKeys + j;
        const bf16* base = which ? key.v : key.k;
        const bool ok = t < key.end;
        const bf16* src =
            ok ? base + size_t(t - key.origin) * key.stride + c * 8 : base;
        cp_async16(kvs + ((buf * 2 + which) * kKeys + j) * ST + c * 8, src,
                   ok);
      }
    };

    const int wr = warp * 16;  // this warp's first row in the tile
    const int cq = (lane & 3) * 2;
    const int pos_lo = row_pos[wr + (lane >> 2)];
    const int pos_hi = row_pos[wr + (lane >> 2) + 8];

    load_kv(0, 0);
    cp_async_commit();
    for (int jt = 0; jt < n_tiles; ++jt) {
      if (jt + 1 < n_tiles) load_kv(jt + 1, (jt + 1) & 1);
      cp_async_commit();  // possibly empty: keeps the group count uniform
      cp_async_wait<1>();  // Q and tile jt have landed
      __syncthreads();
      const bf16* ks = kvs + ((jt & 1) * 2) * kKeys * ST;
      const bf16* vs = ks + kKeys * ST;

      // scores S = Q K^T: 16 rows x 64 keys a warp
      float s[kKeys / 8][4];
#pragma unroll
      for (int nt = 0; nt < kKeys / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, qs + (wr + (lane & 7) + 8 * ((lane >> 3) & 1)) * ST +
                       kk * 16 + 8 * (lane >> 4));
#pragma unroll
        for (int nt = 0; nt < kKeys / 8; nt += 2) {
          uint32_t bk[4];
          ldsm_x4(bk, ks + (nt * 8 + (lane & 7) + 8 * (lane >> 4)) * ST +
                          kk * 16 + 8 * ((lane >> 3) & 1));
          mma_bf16(s[nt], a, bk[0], bk[1]);
          mma_bf16(s[nt + 1], a, bk[2], bk[3]);
        }
      }

      // mask, online softmax (f32, log2 domain)
      const int kbase = key.begin + jt * kKeys;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int nt = 0; nt < kKeys / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = kbase + nt * 8 + cq + (e & 1);
          const int pos = e < 2 ? pos_lo : pos_hi;
          const bool live = t < key.end && t < len && (!causal || t <= pos);
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
      for (int nt = 0; nt < kKeys / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = s[nt][e];
          const float p = x == kNegInf ? 0.f : exp2f(x - m[e >> 1]);
          s[nt][e] = p;
          l[e >> 1] += p;  // a lane's partial; the quad sums at the end
        }
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        o[dt][0] *= alpha[0];
        o[dt][1] *= alpha[0];
        o[dt][2] *= alpha[1];
        o[dt][3] *= alpha[1];
      }

      // O += P V, P = hi + lo (two bf16 A operands), V the B operand
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float p0 = s[2 * kk + (q >> 1)][(q & 1) * 2];
          const float p1 = s[2 * kk + (q >> 1)][(q & 1) * 2 + 1];
          const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
          const float2 hf = __bfloat1622float2(h);
          hi[q] = *reinterpret_cast<const uint32_t*>(&h);
          lo[q] = pack_bf16(p0 - hf.x, p1 - hf.y);
        }
#pragma unroll
        for (int dt = 0; dt < D / 8; dt += 2) {
          uint32_t bv[4];
          ldsm_x4_trans(bv, vs + (kk * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) *
                                     ST + dt * 8 + 8 * (lane >> 4));
          mma_bf16(o[dt], hi, bv[0], bv[1]);
          mma_bf16(o[dt + 1], hi, bv[2], bv[3]);
          mma_bf16(o[dt], lo, bv[0], bv[1]);
          mma_bf16(o[dt + 1], lo, bv[2], bv[3]);
        }
      }
      __syncthreads();  // the buffer is reloaded two tiles on
    }
    cp_async_wait<0>();
    __syncthreads();  // the K/V buffers are free for the next fold
  }

  template <typename RowDst>
  __device__ __forceinline__ void store(RowDst row_dst) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int cq = (lane & 3) * 2;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[r];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      bf16* orow = row_dst(warp * 16 + (lane >> 2) + 8 * r);
      if (orow == nullptr) continue;
      const float inv = lr > 0.f ? 1.f / lr : 0.f;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
        *reinterpret_cast<__nv_bfloat162*>(orow + cq + dt * 8) =
            __floats2bfloat162_rn(o[dt][2 * r] * inv, o[dt][2 * r + 1] * inv);
    }
  }
};

// A tile's row r is (position s, group member g) = (r0 + r) / G, % G.
// row_pos[r] = the row's key-space position, -1 past the last row;
// returns 1 + the largest.
__device__ __forceinline__ int stage_positions(int* row_pos, int rows,
                                               int r0, int n_rows, int G,
                                               const int* qpos, int pos0) {
  __shared__ int mx_sh;
  if (threadIdx.x == 0) mx_sh = -1;
  __syncthreads();
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const int gr = r0 + r;
    const int p = gr < n_rows ? (qpos != nullptr ? qpos[gr / G] : pos0 + gr / G)
                              : -1;
    row_pos[r] = p;
    atomicMax(&mx_sh, p);
  }
  __syncthreads();
  return mx_sh + 1;
}

// ---- the local kernel ------------------------------------------------------

// grid (row tiles, Hkv, B): one tile of rows of (batch row b, kv head h)
template <typename F>
__global__ void __launch_bounds__(128)
fp_local_kernel(const typename F::T* __restrict__ q,
                const typename F::T* __restrict__ k,
                const typename F::T* __restrict__ v,
                const int* __restrict__ qpos, const int* __restrict__ kv_len,
                typename F::T* __restrict__ out, int S, int T_len, int Hq,
                int Hkv, int causal, float scale) {
  typedef typename F::T T;
  constexpr int D = F::kD;
  extern __shared__ float4 fp_smem4[];
  __shared__ int row_pos[F::kRows];
  const int G = Hq / Hkv;
  const int b = blockIdx.z, h = blockIdx.y;
  const int r0 = blockIdx.x * F::kRows;
  const int n_rows = S * G;
  const int len = min(kv_len[b], T_len);
  F f;
  // row r reads q[b, s, h * G + g, :] and writes out at the same place
  auto row_at = [&](auto* base, int r) -> decltype(base) {
    const int gr = r0 + r;
    if (gr >= n_rows) return nullptr;
    return base + ((size_t(b) * S + gr / G) * Hq + h * G + gr % G) * D;
  };
  f.stage(fp_smem4, [&](int r) { return row_at(q, r); }, scale, q);
  int hi = stage_positions(row_pos, F::kRows, r0, n_rows, G,
                           qpos + size_t(b) * S, 0);
  hi = max(causal ? min(len, hi) : len, 0);
  const Keys<T> keys{k + (size_t(b) * T_len * Hkv + h) * D,
                     v + (size_t(b) * T_len * Hkv + h) * D,
                     (long long)Hkv * D, 0, 0, hi};
  f.fold(fp_smem4, row_pos, keys, len, causal);
  cp_async_wait<0>();  // the Q copy, when no tile ran
  f.store([&](int r) { return row_at(out, r); });
}

template <typename F>
cudaError_t launch_local(const void* q, const void* k, const void* v,
                         const void* qpos, const void* kv_len, void* out,
                         int B, int S, int T_len, int Hq, int Hkv, int causal,
                         float scale, cudaStream_t stream) {
  typedef typename F::T T;
  cudaError_t e = cudaFuncSetAttribute(
      fp_local_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(F::kSmem));
  if (e != cudaSuccess) return e;
  const int G = Hq / Hkv;
  dim3 grid((S * G + F::kRows - 1) / F::kRows, Hkv, B);
  fp_local_kernel<F><<<grid, 128, F::kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(qpos),
      static_cast<const int*>(kv_len), static_cast<T*>(out), S, T_len, Hq,
      Hkv, causal, scale);
  return cudaGetLastError();
}

// ---- the SP kernel ---------------------------------------------------------

// Flag words a rank: delivery flags [tensor][offset - 1][b], then the
// barrier counter, then (rank 0's) tile claim counter.
__host__ __device__ __forceinline__ int sp_flag_words(int n, int B) {
  return 2 * (n - 1) * B + 2;
}

struct SpArgs {
  const void* q;    // (n, B, S, Hq, D)
  const void* k;    // (n, B, S, Hkv, D)
  const void* v;
  const int* kv_len;  // (B,) global
  void* out;        // (n, B, S, Hq, D)
  void* kbuf;       // (n, n - 1, B, S, Hkv, D): slot i-1 = chunk (r - i) mod n
  void* vbuf;
  int* flags;       // (n, sp_flag_words), zeroed
  int n, B, S, Hq, Hkv, causal, producers;
  float scale;
  int strag_rank;
  long long strag_ns;
};

template <typename F>
__global__ void __launch_bounds__(128) fp_sp_kernel(SpArgs a) {
  typedef typename F::T T;
  constexpr int D = F::kD;
  extern __shared__ float4 fp_smem4[];
  __shared__ int row_pos[F::kRows];
  __shared__ int claim_sh;
  const int n = a.n, B = a.B, S = a.S, Hq = a.Hq, Hkv = a.Hkv;
  // a segment is whole when each of the P pushing blocks added its share
  const int me = blockIdx.y, G = Hq / Hkv, P = min(a.producers, int(gridDim.x));
  const int words = sp_flag_words(n, B);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  T* kbuf = static_cast<T*>(a.kbuf);
  T* vbuf = static_cast<T*>(a.vbuf);
  T* out = static_cast<T*>(a.out);
  const size_t seg = size_t(S) * Hkv * D;  // elements of one (row, rank) segment
  auto flag = [&](int rank, int t, int i, int b) {
    return a.flags + size_t(rank) * words + (t * (n - 1) + i - 1) * B + b;
  };

  shmem::barrier_all(a.flags, words, words - 2, me, n, "sp_flash_prefill");

  // producers: the segment push, then they consume too
  if (int(blockIdx.x) < P) {
    shmem::straggler_delay(a.strag_rank, me, a.strag_ns);
    shmem::segment_collect_start(
        me, n, B, 2, (long long)seg * sizeof(T), blockIdx.x, P,
        [&](int t, int b) {
          return static_cast<const void*>((t ? v : k) +
                                          (size_t(me) * B + b) * seg);
        },
        [&](int t, int i, int peer, int b) {
          return static_cast<void*>(
              (t ? vbuf : kbuf) +
              ((size_t(peer) * (n - 1) + i - 1) * B + b) * seg);
        },
        [&](int t, int i, int peer, int b) { return flag(peer, t, i, b); });
  }

  // consumers: every block claims tiles of every rank
  const int n_rows = S * G;
  const int TQ = (n_rows + F::kRows - 1) / F::kRows;  // row tiles a (rank, b, h)
  const int total = n * TQ * B * Hkv;
  int* claim = a.flags + words - 1;
  for (;;) {
    __syncthreads();  // claim_sh and the previous tile's smem are free
    if (threadIdx.x == 0) claim_sh = atomicAdd(claim, 1);
    __syncthreads();
    const int c = claim_sh;
    if (c >= total) break;
    const int bh = c / (n * TQ), late = n * TQ - 1 - c % (n * TQ);
    const int r = late / TQ, qt = late % TQ;
    const int b = bh / Hkv, h = bh % Hkv;
    const int r0 = qt * F::kRows;
    auto row_at = [&](auto* base, int rr) -> decltype(base) {
      const int gr = r0 + rr;
      if (gr >= n_rows) return nullptr;
      return base + (((size_t(r) * B + b) * S + gr / G) * Hq + h * G + gr % G) * D;
    };
    F f;
    f.stage(fp_smem4, [&](int rr) { return row_at(q, rr); }, a.scale, q);
    const int len = min(a.kv_len[b], n * S);
    int hi = stage_positions(row_pos, F::kRows, r0, n_rows, G, nullptr,
                             r * S);
    hi = max(a.causal ? min(len, hi) : len, 0);
    for (int i = 0; i < n; ++i) {
      const int chunk = (r - i + n) % n;
      const int begin = chunk * S, end = min(begin + S, hi);
      if (end <= begin) continue;  // no live key: a no-op fold
      const T* kb;
      const T* vb;
      if (i == 0) {
        kb = k + (size_t(r) * B + b) * seg;
        vb = v + (size_t(r) * B + b) * seg;
      } else {
        shmem::signal_wait_until(flag(r, 0, i, b), shmem::kGe, P,
                                 "sp_flash_prefill", r, 0);
        shmem::signal_wait_until(flag(r, 1, i, b), shmem::kGe, P,
                                 "sp_flash_prefill", r, 1);
        const size_t slot = ((size_t(r) * (n - 1) + i - 1) * B + b) * seg;
        kb = kbuf + slot;
        vb = vbuf + slot;
      }
      const Keys<T> keys{kb + size_t(h) * D, vb + size_t(h) * D,
                         (long long)Hkv * D, begin, begin, end};
      f.fold(fp_smem4, row_pos, keys, len, a.causal);
    }
    cp_async_wait<0>();  // the Q copy, when no segment was folded
    f.store([&](int rr) { return row_at(out, rr); });
  }
}

template <typename F>
cudaError_t launch_sp(const SpArgs& a, int* info, cudaStream_t stream) {
  return shmem::launch_world(fp_sp_kernel<F>, a.n, 1 << 20, 128, F::kSmem,
                             stream, info, a);
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
    return int(launch_local<FmaFold<128>>(q, k, v, qpos, kv_len, out, B, S, T_len, Hq, Hkv, causal, scale, st));
  if (dtype == 0 && D == 64)
    return int(launch_local<FmaFold<64>>(q, k, v, qpos, kv_len, out, B, S, T_len, Hq, Hkv, causal, scale, st));
  if (dtype == 1 && D == 128)
    return int(launch_local<TcFold<128>>(q, k, v, qpos, kv_len, out, B, S, T_len, Hq, Hkv, causal, scale, st));
  if (dtype == 1 && D == 64)
    return int(launch_local<TcFold<64>>(q, k, v, qpos, kv_len, out, B, S, T_len, Hq, Hkv, causal, scale, st));
  return int(cudaErrorInvalidValue);
}

extern "C" int fp_sp_flag_words(int n, int B) { return sp_flag_words(n, B); }

// The SP kernel over n ranks: q, k, v, out rank-stacked; kbuf/vbuf the
// receive slots, flags (n, fp_sp_flag_words) zeroed; producers: pushing
// blocks a rank; straggler: rank strag_rank's producers wait strag_ns ns
// first (rank < 0: none). info receives the grid (shmem.cuh).
extern "C" int fp_sp_launch(const void* q, const void* k, const void* v,
                            const void* kv_len, void* out, void* kbuf,
                            void* vbuf, void* flags, int n, int B, int S,
                            int Hq, int Hkv, int D, int dtype, int causal,
                            float scale, int producers, int strag_rank,
                            long long strag_ns, int* info, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 2 || Hkv <= 0 || Hq % Hkv != 0 || producers < 1 || S < 1 || B < 1)
    return int(cudaErrorInvalidValue);
  SpArgs a{q, k, v, static_cast<const int*>(kv_len), out, kbuf, vbuf,
           static_cast<int*>(flags), n, B, S, Hq, Hkv, causal, producers,
           scale, strag_rank, strag_ns};
  if (dtype == 0 && D == 128) return int(launch_sp<FmaFold<128>>(a, info, st));
  if (dtype == 0 && D == 64) return int(launch_sp<FmaFold<64>>(a, info, st));
  if (dtype == 1 && D == 128) return int(launch_sp<TcFold<128>>(a, info, st));
  if (dtype == 1 && D == 64) return int(launch_sp<TcFold<64>>(a, info, st));
  return int(cudaErrorInvalidValue);
}

extern "C" const char* fp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
