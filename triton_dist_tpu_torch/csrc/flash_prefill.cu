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
// The mma.sync folds (TcFold, FmaFold). A query row is a (position,
// head-of-the-group) pair; a block of 4 warps takes a tile of rows of
// one (batch row, kv head), so the G query heads sharing a kv head sit
// in one block and each K/V tile is read once per group. Softmax state and
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
// (shmem::launch_world: grid = blocks a rank x n, every block resident),
// with no entry barrier: the launches on the stream are ordered, the
// flags of the last one are back at zero and the receive slots are this
// call's, so nothing a peer still reads can be overwritten (the JAX
// kernel barriers against a peer still in an earlier kernel). The push
// (sp_push) follows the fence-once rule of shmem.cuh: for each batch row
// b, a pushing block reads its 16-byte-aligned share of rank me's K and
// V rows [0, min(S, kv_len - me S)) once (ld.global.nc) and stores it
// into slot i - 1 of every peer (me + i) mod n that folds it (under the
// causal mask a peer below me folds none of my chunk, and a key past
// kv_len is never live, so neither is pushed); then one barrier, one
// fence.acq_rel.gpu and a relaxed add of one to each of the 2 (n - 1) B
// delivery flags (tensor, offset, row) at its peers. A segment has
// arrived when its flag counts every pushing block of its source. Every
// block claims query tiles from one counter shared by all ranks (one
// card: rank r's causal queries see ~r + 1 segments, so the work is
// pooled, not split by rank), the latest positions first. A tile of rank
// r folds its segments in the TPU kernel's swizzle order: its own (no
// wait) first, then chunk (r - i) mod n for i = 1..n-1, waiting on
// exactly that segment's K and V flags of row b; a segment wholly past
// the tile's last live key is skipped (a no-op fold). The fold order is
// fixed by the tile, not by arrival, so the result is bitwise the same
// whatever the timing: `straggler` (one rank's pushing threads stall)
// checks that. The flags persist (the wrapper's flash_prefill._SP_POOLS,
// zeroed once when made): many tiles wait on one flag, so no waiter can
// clear it; instead every block counts itself on a finished-block word
// once its claims, waits and adds are done, and the last one sets every
// delivery flag and the claim counter back to zero. No deadlock: pushers
// wait on nothing; a tile waits only on pushers, which never wait on a
// tile; every spin is bounded and traps. Two forms:
//   - wgmma (bf16, D = 128, 128 % G == 0, S % 64 == 0, so a 64-key tile
//     never straddles two segments): the local kernel's TMA + wgmma fold
//     (wf_body, below) over a list of segments, one persistent block of
//     384 threads an SM (33 a rank at world 4); warps 1-3 of warpgroup 0,
//     idle in the local kernel, push in every block (96 threads, the
//     rest of the block folding meanwhile). The producer's lane 0 waits
//     on a remote segment's K and V flags (an acquire spin in PTX, 64 ns
//     backoff, trapping without a message: a printf would serialize the
//     wgmma) and then fences the async proxy (the slot was written by
//     other SMs' generic stores, and TMA reads it) before its first load;
//     the own segment comes from a map over the rank-stacked k / v (n B
//     as the batch dimension), the remote ones from maps over kbuf / vbuf
//     (n (n - 1) B), each tile's first key and live end handed to the
//     consumers beside it in the ring;
//   - mma.sync (every other call: f32, D = 64, ragged S, G not dividing
//     128): TcFold / FmaFold, 128 threads a block, the first kSpMmaPushers
//     blocks of each rank pushing before they fold; its waits print.

// What bounds them on an H100. The work is 4*D operations a live (query
// head, key) pair against S*Hq*D + 2*T*Hkv*D input elements. A 64-token
// serve chunk against a 1k cache does ~160 operations a byte read: below
// the card's ~295 bf16 operations a byte, so device memory bounds it. A
// long causal prefill does thousands: the tensor cores' rate bounds it
// (the SP path at 32k positions: 2.75e13 operations, 27.8 ms at 989
// TFLOP/s). The SP kernel's segment push reads each live K/V row once
// and writes it to every peer that folds it (phase 4s's 32k causal
// prefill: 0.30 GB read, 0.67 GB written, ~0.3 ms of HBM time),
// overlapped with the local folds.
// The bf16, D = 128 forms of both kernels run the TMA + wgmma fold below
// (fp_local_wgmma_kernel, fp_sp_wgmma_kernel); f32 and D = 64 keep TcFold
// and FmaFold.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
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

// ---- the wgmma fold: TMA + wgmma, warp-specialised (bf16, D = 128) -------
//
// The main-path form of both kernels (bf16, D = 128, 128 % G == 0; SP:
// S % 64 == 0), one body (wf_body): the same function and softmax as
// TcFold, on Hopper's units. The SP kernel's items, segments, waits and
// push are in the SP comment above; what follows is the local kernel's
// and the common body.
//   - persistent: one block an SM claims work items from a counter, a
//     work item being (row tile of 128 rows, split) of a (batch row, kv
//     head), the last row tiles (the most live keys under the causal
//     mask) first; a block pays its set-up once and never waits for a
//     wave;
//   - 384 threads: warpgroup 0's first warp the producer (it claims the
//     items and hands them to the consumers through a two-slot ring
//     whose slot goes back once every consumer warp has read it; lane 0
//     issues TMA; setmaxnreg 40), warpgroups 1 and 2 the
//     consumers (setmaxnreg 232), 64 of an item's 128 query rows each;
//   - Q by TMA into one of two buffers, so an item's Q loads while the
//     last item folds: a 4-D map over (B, S, Hq, D) whose box is (128 / G
//     positions, G heads, 64 columns), so the GQA row interleave (row r =
//     position r / G, head h G + r % G) is the box's own row order; two
//     boxes for D = 128, 128-byte swizzle. K and V by TMA in 64-key tiles
//     (4-D maps over (B, T, Hkv, D), two boxes each), a ring of kWfStages
//     stages with a full barrier for K, one for V and an empty barrier
//     (one arrive a consumer warpgroup);
//   - ping-pong (FlashAttention-3's schedule): the two consumer
//     warpgroups take turns issuing their products, one turn a P V and
//     the next tile's S, through named barriers, so one's softmax runs
//     while the other's wgmma do;
//   - S = Q K^T: wgmma m64n64k16 from shared memory, K the K-major B
//     operand (hopper::wgmma_n64_kb); the masks and the online softmax
//     in registers (f32, log2 domain), as TcFold's; then O += P V as the
//     register-A wgmma m64n128k16 (hopper::wgmma_n128_rs), V the MN-major
//     B operand, once with hi = bf16(p) and once with lo = bf16(p - hi):
//     the scores' accumulator packs into the A fragments two 8-key groups
//     at a time;
//   - keys past the end. A TMA box is clipped only at the tensor's
//     bound, so a tile that reaches past kv_len holds whatever the cache
//     has there (a recycled page may hold NaN; an SP slot, rows no peer
//     pushed). The scores there are masked by a select, but 0 x NaN
//     would poison P V: the consumers zero the V rows past the tile's
//     live end (kv_len, or the end of its segment's rows: the producer
//     hands it over with the tile) in shared memory (both warpgroups
//     write the same zeros; the stage goes back only after both) and
//     fence the async proxy before their P V;
//   - split-KV: `splits` items share a row tile's key tiles, strided:
//     split sp folds key tiles sp, sp + splits, sp + 2 splits, ... below
//     the tile's live end. A key tile's split is thus a function of the
//     tile's index and the split count alone, never of the live end
//     (kv_len, or the largest position of the row tile), so a query row
//     folds the same keys in the same splits and order wherever it sits
//     in the chunk and whatever the other rows' positions: a verify row's
//     column j is bitwise the sequential step's column 0 at the same
//     position (speculative decoding). A tile past the row's own last
//     key only adds masked scores, exact no-ops (alpha = exp2(0) = 1,
//     p = 0, V past kv_len zeroed). splits = 1: the item is normalised
//     and stored.
//     Otherwise each item's (m, l, unnormalised O) goes to the workspace
//     in f32 and counts on the tile's counter (fence, atomic add); the
//     item that counts last combines the splits in split order (m = max,
//     weights exp2(m_s - m), l and O summed, O / l, 0 when l = 0; a
//     warp a row at a time, its lanes a float4 each, so a split's row is
//     one coalesced 512-byte read: with a thread reading its own 256
//     bytes, lanes 256 bytes apart, the combine cost 13 µs a split level
//     at the serve step) and sets the counter back
//     to zero. No block waits on another, so no residency is needed. The
//     fold order differs from the one-pass fold: held to the same atol
//     and band, not bitwise. The last block to finish (counted on a
//     finished-block word) sets the claim counter back to zero, so the
//     counters and the workspace persist across calls;
//   - nothing that makes ptxas serialize the wgmma (hopper.cuh,
//     mbar_wait_quiet): no call anywhere in the kernel (1 / l is
//     __fdividef's: the IEEE division calls a slow path) and no control
//     flow it cannot prove warp-uniform between them (the waits keep
//     their loops in PTX and trap without a message; one thread's
//     arrives, signals and stores are predicated PTX; an item and its key
//     tile range are broadcast with __shfl_sync). The next tile's S is
//     issued only after P V is done: issued behind it, while P V's
//     accumulator is rescaled, it made ptxas serialize every wgmma.

constexpr int kWfRows = 128;                 // query rows a work item
constexpr int kWfKeys = 64;                  // keys a K / V tile
constexpr int kWfStages = 4;
constexpr int kWfMaxSplits = 4;              // split-KV items a row tile
constexpr int kWfBox = 64 * 128;             // 64 rows of 128 bytes
constexpr int kWfQBox = kWfRows * 128;       // 128 rows of 128 bytes
constexpr int kWfQBytes = 2 * kWfQBox;       // a Q buffer: two halves
constexpr int kWfStageBytes = 4 * kWfBox;    // K and V, two halves each
constexpr size_t kWfSmem =
    size_t(2 * kWfQBytes) + size_t(kWfStages) * kWfStageBytes + 1024;
constexpr int kWfPushers = 96;  // the SP push: warps 1-3 of warpgroup 0

struct WfArgs {
  const int* qpos;    // local: (B, S); SP: none (rank r's rows sit at r S)
  const int* kv_len;  // (B,)
  void* out;          // (B, S, Hq, D); SP: rank-stacked (n, B, S, Hq, D)
  float* ws;          // split-KV: (tiles, splits, 128, 128) O, then
                      // (tiles, splits, 128, 2) (m, l)
  int* ctr;           // local: (tiles + 2,) zero: a tile's split count,
                      // then the claim and the finished-block counters
  int B, S, T, Hq, Hkv, causal, splits;
  float scale;
  // SP: n ranks (0 for the local kernel), the push's sources and slots,
  // the flag pool and the straggler
  int n;
  const void* q;      // (n, B, S, Hq, D): the mma.sync form's queries
  const void* k;      // (n, B, S, Hkv, D)
  const void* v;
  void* kbuf;         // (n, n - 1, B, S, Hkv, D): slot i-1 = chunk (r - i) mod n
  void* vbuf;
  int* flags;         // (n, words), zero; left at zero: a rank's
                      // delivery flags [tensor][offset - 1][b] first;
                      // rank 0's last two words are the tile claim and
                      // the finished-block counters
  int words;          // flag words a rank, at least 2 (n - 1) B + 2
  int strag_rank;
  long long strag_ns;
};

// a work item: (row tile, split) of a (batch row b, kv head h) of rank
// `rank`'s queries (SP; 0 for the local kernel), the last row tiles
// first (SP: the last of every rank, so the causal work is pooled); qb
// is the query batch index (SP: rank B + b)
template <bool kSp>
struct WfItem {
  int sp, b, qb, h, tile, r0, rank;
  __device__ WfItem(const WfArgs& a, int TQ, int i) {
    const int bh = a.B * a.Hkv;
    b = i % bh / a.Hkv;
    h = i % a.Hkv;
    int qt;
    if (kSp) {
      const int late = a.n * TQ - 1 - i / bh;
      rank = late / TQ;
      qt = late % TQ;
      sp = 0;
    } else {
      const int per = a.splits * bh;
      qt = TQ - 1 - i / per;
      sp = i % per / bh;
      rank = 0;
    }
    qb = rank * a.B + b;
    tile = (qb * a.Hkv + h) * TQ + qt;
    r0 = qt * kWfRows;
  }
};

// An item's keys, alike in every lane of the calling warp: (its first key
// tile, its key tiles, its batch row's clamped kv_len, the keys' live end
// hi). The keys end at hi = min(kv_len, 1 + the largest position of its
// rows) under the causal mask, at kv_len without it. Local: the tiles of
// [0, hi) of its split, x, x + splits, ... (strided, the design comment),
// branch-free (each lane folds 4 positions, 128 / G at most). SP: the
// tiles of every segment it folds, chunk (rank - i) mod n for i =
// 0..n-1, each [chunk S, min(chunk S + S, hi)).
template <bool kSp>
__device__ __forceinline__ int4 wf_keys(const WfArgs& a,
                                        const WfItem<kSp>& w, int G,
                                        int n_rows) {
  const int lane = threadIdx.x % 32;
  if (kSp) {
    const int len = max(min(a.kv_len[w.b], a.n * a.S), 0);
    const int last = w.rank * a.S + (min(w.r0 + kWfRows, n_rows) - 1) / G;
    const int hi = max(a.causal ? min(len, last + 1) : len, 0);
    int nt = 0;
    for (int i = 0; i < a.n; ++i) {
      const int begin = (w.rank - i + a.n) % a.n * a.S;
      const int end = min(begin + a.S, hi);
      nt += end > begin ? (end - begin + kWfKeys - 1) / kWfKeys : 0;
    }
    return make_int4(0, __shfl_sync(0xffffffffu, nt, 0),
                     __shfl_sync(0xffffffffu, len, 0),
                     __shfl_sync(0xffffffffu, hi, 0));
  }
  const int len = max(min(a.kv_len[w.b], a.T), 0);
  const int* qp = a.qpos + size_t(w.b) * a.S;
  const int s0 = w.r0 / G, s1 = min(w.r0 + kWfRows, n_rows) / G;
  int mx = -1;
#pragma unroll
  for (int k = 0; k < kWfRows / 32; ++k)
    mx = max(mx, qp[min(s0 + lane + 32 * k, s1 - 1)]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  const int hi = max(a.causal ? min(len, mx + 1) : len, 0);
  const int nt = __shfl_sync(0xffffffffu, (hi + kWfKeys - 1) / kWfKeys, 0);
  const int cnt = nt > w.sp ? (nt - w.sp + a.splits - 1) / a.splits : 0;
  return make_int4(w.sp, cnt, __shfl_sync(0xffffffffu, len, 0),
                   __shfl_sync(0xffffffffu, hi, 0));
}

// a bf16 pair to global memory by the threads whose `pred` is set
__device__ __forceinline__ void st_bf16x2_if(bf16* p, float x, float y,
                                             bool pred) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %2, 0;\n"
      "@p st.global.b32 [%0], %1;\n"
      "}\n" ::"l"(p),
      "r"(*reinterpret_cast<const uint32_t*>(&v)), "r"(int(pred))
      : "memory");
}

// v to shared address `addr` by the threads whose `pred` is set
__device__ __forceinline__ void st_shared_if(uint32_t addr, int v,
                                             bool pred) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %2, 0;\n"
      "@p st.shared.b32 [%0], %1;\n"
      "}\n" ::"r"(addr),
      "r"(v), "r"(int(pred))
      : "memory");
}

// the thread whose `pred` is set: a gpu-scope fence, an atomic add of 1
// to *ctr, and (when it was the last of `n`) another fence and a reset of
// *ctr to 0; returns whether it was the last (false elsewhere)
__device__ __forceinline__ bool count_last_if(int* ctr, int n, bool pred) {
  int last;
  asm volatile(
      "{\n"
      ".reg .pred p, q;\n"
      ".reg .s32 old;\n"
      "setp.ne.b32 p, %3, 0;\n"
      "mov.b32 %0, 0;\n"
      "@!p bra DONE;\n"
      "fence.acq_rel.gpu;\n"
      "atom.relaxed.gpu.global.add.s32 old, [%1], 1;\n"
      "setp.eq.s32 q, old, %2;\n"
      "@!q bra DONE;\n"
      "fence.acq_rel.gpu;\n"
      "st.relaxed.gpu.global.s32 [%1], 0;\n"
      "mov.b32 %0, 1;\n"
      "DONE:\n"
      "}\n"
      : "=r"(last)
      : "l"(ctr), "r"(n - 1), "r"(int(pred))
      : "memory");
  return last != 0;
}

// The SP segment push of rank me (the fence-once rule of shmem.cuh):
// block `block` of the rank's `blocks` pushing blocks, T threads of
// which this is `tid`; a key row is row_bytes (Hkv x D elements). For
// each row b, its 16-byte-aligned share of the
// K and V rows [0, rows) of the segment, rows = min(S, kv_len - me S)
// (a key past kv_len is never live), is read once (ld.global.nc) and
// stored into slot i - 1 of every peer (me + i) mod n that folds it (a
// causal peer below me folds nothing of me's chunk). Then sync() orders
// every pushing thread's stores before thread 0's one fence.acq_rel and
// a relaxed add of one to each of the rank's 2 (n - 1) B delivery flags
// at its peer: a segment has arrived when its flag counts `blocks`. A
// straggler rank's pushing threads first stall strag_ns.
template <int T, typename Sync>
__device__ __forceinline__ void sp_push(const WfArgs& a, int me, int block,
                                        int blocks, int tid,
                                        long long row_bytes, Sync sync) {
  const int n = a.n, B = a.B, words = a.words;
  if (me == a.strag_rank && a.strag_ns > 0) shmem::stall(a.strag_ns);
  const long long seg_bytes = row_bytes * a.S;  // a (rank, row) segment
  for (int b = 0; b < B; ++b) {
    const int len = max(min(a.kv_len[b], n * a.S), 0);
    const long long rows = min(max(len - me * a.S, 0), a.S);
    long long lo, hi;
    shmem::block_share(rows * row_bytes, blocks, block, &lo, &hi);
    for (int t = 0; t < 2; ++t) {
      const char* src = static_cast<const char*>(t ? a.v : a.k) +
                        (size_t(me) * B + b) * seg_bytes + lo;
      char* slots = static_cast<char*>(t ? a.vbuf : a.kbuf);
      shmem::copy_nc_ends<T, 4>(
          tid, n - 1,
          [&](int e) -> char* {
            const int i = e + 1, peer = (me + i) % n;
            if (a.causal && peer < me) return nullptr;
            return slots + ((size_t(peer) * (n - 1) + i - 1) * B + b) *
                               seg_bytes + lo;
          },
          src, hi - lo);
    }
  }
  sync();
  if (tid != 0) return;
  shmem::fence_acq_rel();
  for (int i = 1; i < n; ++i) {
    int* peer = a.flags + size_t((me + i) % n) * words;
    for (int t = 0; t < 2; ++t)
      for (int b = 0; b < B; ++b)
        shmem::red_add_relaxed(peer + (t * (n - 1) + i - 1) * B + b, 1);
  }
}

// The last block of an SP launch (counted on the finished-block word,
// which count_last_if clears): every delivery flag of every rank and the
// claim counter back to zero for the next launch on the stream.
__device__ __forceinline__ void sp_reset(const WfArgs& a) {
  for (int r = 0; r < a.n; ++r)
    for (int w = 0; w < 2 * (a.n - 1) * a.B; ++w)
      shmem::st_relaxed(a.flags + size_t(r) * a.words + w, 0);
  shmem::st_relaxed(a.flags + a.words - 2, 0);
}

// The TMA + wgmma fold of both kernels (the header comment above): the
// local kernel (kSp false: maps q, k, v) and the SP kernel (kSp true:
// q, the rank-stacked k and v as the own segments, and kbuf / vbuf as
// the remote ones).
template <bool kSp>
__device__ __forceinline__ void wf_body(const CUtensorMap* map_q,
                                        const CUtensorMap* map_k,
                                        const CUtensorMap* map_v,
                                        const CUtensorMap* map_kb,
                                        const CUtensorMap* map_vb,
                                        const WfArgs& a) {
  constexpr int D = 128, S_ = kWfStages;
  extern __shared__ uint8_t wf_smem[];
  __shared__ __align__(8) uint64_t fullk[S_], fullv[S_], empty[S_];
  __shared__ __align__(8) uint64_t q_full[2], q_empty[2];
  __shared__ __align__(8) uint64_t item_full[2], item_empty[2];
  __shared__ int item_q[2], last_sh;
  __shared__ int2 stage_keys[S_];  // a stage's (first key, live end)
  const int G = a.Hq / a.Hkv, n_rows = a.S * G;
  const int TQ = (n_rows + kWfRows - 1) / kWfRows;
  const int tiles = a.B * a.Hkv * TQ;
  const int total = kSp ? a.n * tiles : tiles * a.splits;
  // the claim and finished-block counters
  int* claim = kSp ? a.flags + a.words - 2 : a.ctr + tiles;
  const uint32_t base = (hopper::smem_addr(wf_smem) + 1023) & ~1023u;
  const uint32_t kv0 = base + 2 * kWfQBytes;  // the K / V ring
  auto bar = [](uint64_t& b) { return hopper::smem_addr(&b); };

  if (threadIdx.x == 0) {
    for (int i = 0; i < S_; ++i) {
      hopper::mbar_init(bar(fullk[i]), 1);
      hopper::mbar_init(bar(fullv[i]), 1);
      hopper::mbar_init(bar(empty[i]), 2);
    }
    for (int i = 0; i < 2; ++i) {
      hopper::mbar_init(bar(q_full[i]), 1);
      hopper::mbar_init(bar(q_empty[i]), 2);
      hopper::mbar_init(bar(item_full[i]), 1);
      hopper::mbar_init(bar(item_empty[i]), 8);  // a consumer warp each
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();
  // the warpgroup, warp-uniform to the compiler (a wgmma in a path it
  // cannot prove uniform is serialized: ptxas C7518)
  const int wg = __shfl_sync(0xffffffffu, int(threadIdx.x) / 128, 0);
  const int lane = threadIdx.x % 32;

  // SP: every block of a rank pushes, so a segment is whole when its
  // flag counts them all (8 pushing blocks a rank, tried, left the folds
  // waiting longer: PERF.md)
  const int pushers = gridDim.x;
  if (wg == 0) {  // warp 0 the producer (lane 0 loads); SP: warps 1-3 push
    hopper::regs_dec<40>();
    if (threadIdx.x >= 32) {
      if (kSp)
        sp_push<kWfPushers>(
            a, blockIdx.y, blockIdx.x, pushers, threadIdx.x - 32,
            (long long)a.Hkv * D * 2,
            [] { hopper::named_sync(7, kWfPushers); });
    } else {
      const bool l0 = lane == 0;
      int stage = 0, qslot = 0;
      uint32_t phase = 0, qphase = 0;
      for (int k = 0;; ++k) {
        const int islot = k & 1;
        int item = 0;
        if (l0) {
          hopper::mbar_wait_quiet(bar(item_empty[islot]),
                                  ((k >> 1) & 1) ^ 1);
          item = atomicAdd(claim, 1);
          item_q[islot] = item;
          hopper::mbar_arrive(bar(item_full[islot]));  // release: item_q
        }
        item = __shfl_sync(0xffffffffu, item, 0);
        if (item >= total) break;
        const WfItem<kSp> w(a, TQ, item);
        const int4 jr = wf_keys<kSp>(a, w, G, n_rows);
        if (jr.y == 0) continue;  // no live key: no loads
        if (l0) {
          const uint32_t qs = base + qslot * kWfQBytes;
          hopper::mbar_wait_quiet(bar(q_empty[qslot]), qphase ^ 1);
          hopper::mbar_expect_tx(bar(q_full[qslot]), kWfQBytes);
          for (int hf = 0; hf < 2; ++hf)
            hopper::tma_load_4d(qs + hf * kWfQBox, map_q, bar(q_full[qslot]),
                                64 * hf, w.h * G, w.r0 / G, w.qb);
          // key tile (c2, c3) of maps mk, mv: keys [k0, k0 + 64), live
          // below vend
          auto load = [&](const CUtensorMap* mk, const CUtensorMap* mv,
                          int c2, int c3, int k0, int vend) {
            hopper::mbar_wait_quiet(bar(empty[stage]), phase ^ 1);
            const uint32_t st = kv0 + stage * kWfStageBytes;
            stage_keys[stage] = make_int2(k0, vend);
            hopper::mbar_expect_tx(bar(fullk[stage]), 2 * kWfBox);
            for (int hf = 0; hf < 2; ++hf)
              hopper::tma_load_4d(st + hf * kWfBox, mk, bar(fullk[stage]),
                                  64 * hf, w.h, c2, c3);
            hopper::mbar_expect_tx(bar(fullv[stage]), 2 * kWfBox);
            for (int hf = 0; hf < 2; ++hf)
              hopper::tma_load_4d(st + (2 + hf) * kWfBox, mv,
                                  bar(fullv[stage]), 64 * hf, w.h, c2, c3);
            if (++stage == S_) {
              stage = 0;
              phase ^= 1;
            }
          };
          if (kSp) {
            // segment i: chunk (rank - i) mod n, the own one from the
            // rank-stacked k / v, a remote one from its receive slot once
            // its K and V flags count every pushing block (acquire), then
            // the async-proxy fence: the slot was written by other SMs'
            // generic stores and TMA reads it
            const int n = a.n, words = a.words;
            for (int i = 0; i < n; ++i) {
              const int begin = (w.rank - i + n) % n * a.S;
              const int end = min(begin + a.S, jr.w);
              if (end <= begin) continue;
              const int vend = min(begin + a.S, jr.z);
              const CUtensorMap* mk = map_k;
              const CUtensorMap* mv = map_v;
              int c3 = w.qb;
              if (i > 0) {
                const int* f = a.flags + size_t(w.rank) * words +
                               (i - 1) * a.B + w.b;
                hopper::wait_eq_if(f, pushers, true);
                hopper::wait_eq_if(f + (n - 1) * a.B, pushers, true);
                hopper::fence_proxy_async_global();
                mk = map_kb;
                mv = map_vb;
                c3 = (w.rank * (n - 1) + i - 1) * a.B + w.b;
              }
              for (int k0 = begin; k0 < end; k0 += kWfKeys)
                load(mk, mv, k0 - begin, c3, k0, vend);
            }
          } else {
            for (int i = 0; i < jr.y; ++i) {  // split jr.x's tiles
              const int j = jr.x + i * a.splits;
              load(map_k, map_v, j * kWfKeys, w.b, j * kWfKeys, jr.z);
            }
          }
        }
        __syncwarp();
        if (++qslot == 2) {
          qslot = 0;
          qphase ^= 1;
        }
      }
    }
    // the last block to finish (its claims, waits and adds all done) sets
    // the claim counter (SP: every delivery flag too) back to 0
    hopper::named_sync(6, 128);
    if (count_last_if(claim + 1, int(gridDim.x * gridDim.y),
                      threadIdx.x == 0)) {
      if (kSp)
        sp_reset(a);
      else
        shmem::st_relaxed(claim, 0);
    }
    return;
  }

  // a consumer warpgroup: rows 64 w .. 64 w + 63 of each item
  hopper::regs_inc<232>();
  const int w = wg - 1, ct = threadIdx.x - 128;
  const int warp = threadIdx.x / 32 % 4;
  const int rl = 64 * w + 16 * warp + lane / 4;  // my rows: rl, rl + 8
  const bool leader = ct % 128 == 0;             // of my warpgroup
  const float sl2 = a.scale * kLog2e;
  int stage = 0, qslot = 0;
  uint32_t phase = 0, qphase = 0;
  // ping-pong: the warpgroups take turns issuing their products (named
  // barrier 4 + w: my turn), so one's softmax overlaps the other's
  // wgmma; warpgroup 0 goes first
  auto turn = [&] { hopper::named_sync(4 + w, 256); };
  auto pass = [&] { hopper::named_arrive(5 - w, 256); };
  if (w == 1) hopper::named_arrive(4, 256);
  for (int k = 0;; ++k) {
    const int islot = k & 1;
    hopper::mbar_wait_quiet(bar(item_full[islot]), (k >> 1) & 1);
    // lane 0's read is the warp's: then the slot goes back, a warp at a
    // time (a warpgroup's leader alone could free it before its other
    // warps have read it)
    const int item = __shfl_sync(0xffffffffu, item_q[islot], 0);
    hopper::mbar_arrive_if(bar(item_empty[islot]), lane == 0);
    if (item >= total) {
      if (w == 0) turn();  // warpgroup 1's last pass
      break;
    }
    const WfItem<kSp> wi(a, TQ, item);
    const int4 jr = wf_keys<kSp>(a, wi, G, n_rows);
    const int len = jr.z;
    int pos[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // -1: a row past the end, no live key
      const int gr = wi.r0 + rl + 8 * r;
      pos[r] = gr >= n_rows ? -1
               : kSp       ? wi.rank * a.S + gr / G
                           : a.qpos[size_t(wi.b) * a.S +
                                    min(gr, n_rows - 1) / G];
    }
    const uint32_t qs = base + qslot * kWfQBytes;
    float o[64], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;
    float s[32];
    // S = Q K^T of the tile in `stg`, issued and committed
    auto issue_s = [&](int stg, uint32_t ph) {
      hopper::mbar_wait_quiet(bar(fullk[stg]), ph);
      const uint32_t st = kv0 + stg * kWfStageBytes;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_n64_kb(
            s,
            hopper::desc_sw128(qs + (kk / 4) * kWfQBox + w * 64 * 128 +
                                   (kk % 4) * 32,
                               16, 1024),
            hopper::desc_sw128(st + (kk / 4) * kWfBox + (kk % 4) * 32, 16,
                               1024),
            kk > 0);
      hopper::wgmma_commit();
    };
    if (jr.y > 0) {
      hopper::mbar_wait_quiet(bar(q_full[qslot]), qphase);
      turn();
      issue_s(stage, phase);
      pass();
    }
    for (int j = 0; j < jr.y; ++j) {
      const uint32_t st = kv0 + stage * kWfStageBytes;
      // the tile's first key and the end of its live rows, as the
      // producer loaded it (read after the tile's full barrier)
      const int2 tk = stage_keys[stage];
      const int k0 = __shfl_sync(0xffffffffu, tk.x, 0);
      const int vend = __shfl_sync(0xffffffffu, tk.y, 0);
      hopper::wgmma_wait<0>();  // this tile's S
      hopper::fence_regs(s);

      // mask, online softmax (f32, log2 domain): TcFold's. The logits go
      // to x: the accumulator s is written by wgmma alone (ptxas
      // serializes a wgmma whose accumulator other instructions define,
      // C7515)
      float x[32], mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = k0 + 8 * i + 2 * (lane % 4) + (e & 1);
          const bool live = t < len && (!a.causal || t <= pos[e >> 1]);
          x[4 * i + e] = live ? s[4 * i + e] * sl2 : kNegInf;
          mx[e >> 1] = fmaxf(mx[e >> 1], x[4 * i + e]);
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
      uint32_t phi[4][4], plo[4][4];  // P's A fragments, 16 keys each
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const float x0 = x[4 * i + e], x1 = x[4 * i + e + 1];
          const float p0 = x0 == kNegInf ? 0.f : exp2f(x0 - m[e >> 1]);
          const float p1 = x1 == kNegInf ? 0.f : exp2f(x1 - m[e >> 1]);
          l[e >> 1] += p0 + p1;  // a lane's partial; the quad sums last
          const __nv_bfloat162 hv = __floats2bfloat162_rn(p0, p1);
          const float2 hf = __bfloat1622float2(hv);
          // fragment i / 2, register (e / 2) + 2 (i % 2)
          phi[i / 2][e / 2 + 2 * (i % 2)] =
              *reinterpret_cast<const uint32_t*>(&hv);
          plo[i / 2][e / 2 + 2 * (i % 2)] = pack_bf16(p0 - hf.x, p1 - hf.y);
        }
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        o[4 * i] *= alpha[0];
        o[4 * i + 1] *= alpha[0];
        o[4 * i + 2] *= alpha[1];
        o[4 * i + 3] *= alpha[1];
      }

      hopper::mbar_wait_quiet(bar(fullv[stage]), phase);
      if (k0 + kWfKeys > vend) {  // V rows past the live end: zeros, not
                                  // whatever the cache or slot holds
        // both halves' 64 rows of 8 16-byte words, 8 a thread, predicated
#pragma unroll
        for (int i = 0; i < 2 * kWfKeys * 8 / 128; ++i) {
          const int word = ct % 128 + 128 * i;  // half, row, word
          hopper::st_zero16_if(st + 2 * kWfBox + word * 16,
                               word / 8 % kWfKeys >= vend - k0);
        }
        hopper::fence_proxy_async_shared();
        hopper::named_sync(1 + w, 128);
      }
      turn();
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWfKeys / 16; ++kk) {
        const uint64_t dv =
            hopper::desc_sw128(st + 2 * kWfBox + kk * 2048, kWfBox, 1024);
        hopper::wgmma_n128_rs(o, phi[kk], dv, 1);
        hopper::wgmma_n128_rs(o, plo[kk], dv, 1);
      }
      hopper::wgmma_commit();
      // P V done before the next S is issued: issued behind it, while its
      // accumulator is rescaled, ptxas serializes every wgmma (C7515)
      hopper::wgmma_wait<0>();
      hopper::fence_regs(o);
      hopper::mbar_arrive_if(bar(empty[stage]), leader);
      if (++stage == S_) {
        stage = 0;
        phase ^= 1;
      }
      if (j + 1 < jr.y) issue_s(stage, phase);
      pass();
    }
    if (jr.y > 0) {  // this item's Q buffer goes back
      hopper::mbar_arrive_if(bar(q_empty[qslot]), leader);
      if (++qslot == 2) {
        qslot = 0;
        qphase ^= 1;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    // row r of the tile: position (r0 + r) / G, head h G + (r0 + r) % G
    auto out_row = [&](int r) {
      const int gr = min(wi.r0 + r, n_rows - 1);
      return static_cast<bf16*>(a.out) +
             ((size_t(wi.qb) * a.S + gr / G) * a.Hq + wi.h * G + gr % G) * D;
    };
    if (kSp || a.splits == 1) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        bf16* orow = out_row(rl + 8 * r);
        const bool valid = wi.r0 + rl + 8 * r < n_rows;
        const float inv = l[r] > 0.f ? __fdividef(1.f, l[r]) : 0.f;
#pragma unroll
        for (int i = 0; i < 16; ++i)
          st_bf16x2_if(orow + 8 * i + 2 * (lane % 4), o[4 * i + 2 * r] * inv,
                       o[4 * i + 2 * r + 1] * inv, valid);
      }
      continue;
    }

    // split-KV: my partial into the workspace, then the last one combines
    const size_t part = size_t(total);  // partials
    float* wo = a.ws + (size_t(wi.tile) * a.splits + wi.sp) * kWfRows * D;
    float* wml = a.ws + part * kWfRows * D +
                 (size_t(wi.tile) * a.splits + wi.sp) * kWfRows * 2;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = rl + 8 * r;
#pragma unroll
      for (int i = 0; i < 16; ++i)
        *reinterpret_cast<float2*>(wo + row * D + 8 * i + 2 * (lane % 4)) =
            make_float2(o[4 * i + 2 * r], o[4 * i + 2 * r + 1]);
      // the quad's four lanes store the same (m, l)
      *reinterpret_cast<float2*>(wml + row * 2) = make_float2(m[r], l[r]);
    }
    hopper::named_sync(3, 256);
    const bool last = count_last_if(a.ctr + wi.tile, a.splits, ct == 0);
    st_shared_if(hopper::smem_addr(&last_sh), last, ct == 0);
    hopper::named_sync(3, 256);
    if (!__shfl_sync(0xffffffffu, last_sh, 0)) continue;
    const float* t_o = a.ws + size_t(wi.tile) * a.splits * kWfRows * D;
    const float* t_ml = a.ws + part * kWfRows * D +
                        size_t(wi.tile) * a.splits * kWfRows * 2;
    // a warp 16 rows, 2 at a time, a lane a float4 of each (a split's
    // row is 512 coalesced bytes): every split's (m, l) and rows in flight
#pragma unroll 1
    for (int k2 = 0; k2 < 8; ++k2) {
      const int r0 = ct / 32 * 16 + 2 * k2;
      float2 ml[2][kWfMaxSplits];
      float4 v[2][kWfMaxSplits];
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int q = 0; q < kWfMaxSplits; ++q)
          if (q < a.splits) {
            const size_t at = size_t(q) * kWfRows + r0 + u;
            ml[u][q] = __ldcg(reinterpret_cast<const float2*>(t_ml + at * 2));
            v[u][q] = __ldcg(reinterpret_cast<const float4*>(t_o + at * D) +
                             lane);
          }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float mt = kNegInf;
#pragma unroll
        for (int q = 0; q < kWfMaxSplits; ++q)
          if (q < a.splits) mt = fmaxf(mt, ml[u][q].x);
        float lt = 0.f, acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int q = 0; q < kWfMaxSplits; ++q)
          if (q < a.splits) {
            const float wq = exp2f(ml[u][q].x - mt);
            lt += ml[u][q].y * wq;
            acc[0] += v[u][q].x * wq;
            acc[1] += v[u][q].y * wq;
            acc[2] += v[u][q].z * wq;
            acc[3] += v[u][q].w * wq;
          }
        const float inv = lt > 0.f ? __fdividef(1.f, lt) : 0.f;
        bf16* orow = out_row(r0 + u) + 4 * lane;
        const bool valid = wi.r0 + r0 + u < n_rows;
        st_bf16x2_if(orow, acc[0] * inv, acc[1] * inv, valid);
        st_bf16x2_if(orow + 2, acc[2] * inv, acc[3] * inv, valid);
      }
    }
  }
}

__global__ void __launch_bounds__(384, 1)
fp_local_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      const WfArgs a) {
  wf_body<false>(&map_q, &map_k, &map_v, nullptr, nullptr, a);
}

__global__ void __launch_bounds__(384, 1)
fp_sp_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v,
                   const __grid_constant__ CUtensorMap map_kb,
                   const __grid_constant__ CUtensorMap map_vb,
                   const WfArgs a) {
  wf_body<true>(&map_q, &map_k, &map_v, &map_kb, &map_vb, a);
}

// a 4-D map of q (B, S, Hq, 128): boxes of 128 / G positions of G heads,
// 64 columns; of k or v (B, T, Hkv, 128): boxes of 64 keys of one head
bool encode_q_map(CUtensorMap* map, const void* q, int B, int S, int Hq,
                  int Hkv) {
  const uint64_t d[4] = {128, uint64_t(Hq), uint64_t(S), uint64_t(B)};
  const uint64_t s[3] = {256, uint64_t(Hq) * 256, uint64_t(S) * Hq * 256};
  const uint32_t b[4] = {64, uint32_t(Hq / Hkv), uint32_t(kWfRows / (Hq / Hkv)),
                         1};
  return hopper::encode_bf16(map, q, 4, d, s, b);
}

bool encode_kv_map(CUtensorMap* map, const void* k, int B, int T, int Hkv) {
  const uint64_t d[4] = {128, uint64_t(Hkv), uint64_t(T), uint64_t(B)};
  const uint64_t s[3] = {256, uint64_t(Hkv) * 256, uint64_t(T) * Hkv * 256};
  const uint32_t b[4] = {64, 1, kWfKeys, 1};
  return hopper::encode_bf16(map, k, 4, d, s, b);
}

// ---- the SP kernel's mma.sync form ---------------------------------------

// every other SP call (f32, D = 64, S % 64 != 0, G not dividing 128): the
// mma.sync / FMA fold, 128 threads a block; the first kSpMmaPushers
// blocks of each rank push (sp_push), then every block claims tiles
constexpr int kSpMmaPushers = 8;

template <typename F>
__global__ void __launch_bounds__(128) fp_sp_kernel(WfArgs a) {
  typedef typename F::T T;
  constexpr int D = F::kD;
  extern __shared__ float4 fp_smem4[];
  __shared__ int row_pos[F::kRows];
  __shared__ int claim_sh;
  const int n = a.n, B = a.B, S = a.S, Hq = a.Hq, Hkv = a.Hkv;
  // a segment is whole when each of the P pushing blocks added its share
  const int me = blockIdx.y, G = Hq / Hkv;
  const int P = min(kSpMmaPushers, int(gridDim.x));
  const int words = a.words;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* kbuf = static_cast<const T*>(a.kbuf);
  const T* vbuf = static_cast<const T*>(a.vbuf);
  T* out = static_cast<T*>(a.out);
  const size_t seg = size_t(S) * Hkv * D;  // elements of one (row, rank) segment

  if (int(blockIdx.x) < P)
    sp_push<128>(a, me, blockIdx.x, P, threadIdx.x,
                 (long long)Hkv * D * sizeof(T), [] { __syncthreads(); });

  // consumers: every block claims tiles of every rank
  const int n_rows = S * G;
  const int TQ = (n_rows + F::kRows - 1) / F::kRows;  // row tiles a (rank, b, h)
  const int total = n * TQ * B * Hkv;
  int* claim = a.flags + words - 2;
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
        const int f0 = (i - 1) * B + b;  // K's flag; V's (n - 1) B on
        shmem::signal_wait_until(a.flags + size_t(r) * words + f0, shmem::kEq,
                                 P, "sp_flash_prefill", r, f0, shmem::kPollNs);
        shmem::signal_wait_until(
            a.flags + size_t(r) * words + f0 + (n - 1) * B, shmem::kEq, P,
            "sp_flash_prefill", r, f0 + (n - 1) * B, shmem::kPollNs);
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
  // the last block to finish resets the pool
  __syncthreads();
  if (count_last_if(claim + 1, int(gridDim.x * gridDim.y), threadIdx.x == 0))
    sp_reset(a);
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

// The wgmma fold (bf16, D = 128, 128 % (Hq / Hkv) == 0): q, k, v, qpos,
// kv_len, out as fp_local_launch; splits >= 1 items a row tile (split-
// KV); ctr (fp_wgmma_counters ints) zero, and each call leaves it at
// zero; splits > 1 also needs ws (fp_wgmma_ws_floats floats). Launches
// one block an SM (at most one a work item). Returns a cudaError_t (0 =
// launched).
extern "C" int fp_wgmma_tiles(int B, int S, int Hq, int Hkv) {
  return B * Hkv * ((S * (Hq / Hkv) + kWfRows - 1) / kWfRows);
}

extern "C" int fp_wgmma_counters(int B, int S, int Hq, int Hkv) {
  return fp_wgmma_tiles(B, S, Hq, Hkv) + 2;
}

extern "C" long long fp_wgmma_ws_floats(int B, int S, int Hq, int Hkv,
                                        int splits) {
  return (long long)fp_wgmma_tiles(B, S, Hq, Hkv) * splits * kWfRows *
         (128 + 2);
}

extern "C" int fp_local_wgmma_launch(const void* q, const void* k,
                                     const void* v, const void* qpos,
                                     const void* kv_len, void* out, int B,
                                     int S, int T_len, int Hq, int Hkv,
                                     int causal, float scale, int splits,
                                     void* ws, void* ctr, void* stream) {
  if (B < 1 || S < 1 || T_len < 1 || Hkv <= 0 || Hq % Hkv != 0 ||
      kWfRows % (Hq / Hkv) != 0 || splits < 1 || splits > kWfMaxSplits ||
      ctr == nullptr || (splits > 1 && ws == nullptr))
    return int(cudaErrorInvalidValue);
  CUtensorMap maps[3];
  if (!encode_q_map(&maps[0], q, B, S, Hq, Hkv) ||
      !encode_kv_map(&maps[1], k, B, T_len, Hkv) ||
      !encode_kv_map(&maps[2], v, B, T_len, Hkv))
    return int(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fp_local_wgmma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(kWfSmem));
  if (e != cudaSuccess) return int(e);
  WfArgs a{};
  a.qpos = static_cast<const int*>(qpos);
  a.kv_len = static_cast<const int*>(kv_len);
  a.out = out;
  a.ws = static_cast<float*>(ws);
  a.ctr = static_cast<int*>(ctr);
  a.B = B;
  a.S = S;
  a.T = T_len;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.causal = causal;
  a.splits = splits;
  a.scale = scale;
  const int items = fp_wgmma_tiles(B, S, Hq, Hkv) * splits;
  fp_local_wgmma_kernel<<<items < sms ? items : sms, 384, kWfSmem,
                          static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], a);
  return int(cudaGetLastError());
}

// The SP kernel over n ranks: q, k, v, out rank-stacked (n, B, S, H, D);
// kbuf/vbuf the receive slots (n, n - 1, B, S, Hkv, D); flags (n, words)
// int32 at zero, words at least 2 (n - 1) B + 2 (WfArgs::flags), and
// each launch leaves them at zero;
// straggler: rank strag_rank's pushing threads wait strag_ns ns first
// (rank < 0: none). wgmma = 1 takes the TMA + wgmma form (bf16, D = 128,
// 128 % (Hq / Hkv) == 0, S % 64 == 0), else the mma.sync / FMA form.
// info receives the grid (shmem.cuh).
extern "C" int fp_sp_launch(const void* q, const void* k, const void* v,
                            const void* kv_len, void* out, void* kbuf,
                            void* vbuf, void* flags, int words, int n,
                            int B, int S,
                            int Hq, int Hkv, int D, int dtype, int causal,
                            float scale, int wgmma, int strag_rank,
                            long long strag_ns, int* info, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 2 || Hkv <= 0 || Hq % Hkv != 0 || S < 1 || B < 1 ||
      flags == nullptr || words < 2 * (n - 1) * B + 2)
    return int(cudaErrorInvalidValue);
  WfArgs a{};
  a.kv_len = static_cast<const int*>(kv_len);
  a.out = out;
  a.B = B;
  a.S = S;
  a.T = S;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.causal = causal;
  a.splits = 1;
  a.scale = scale;
  a.n = n;
  a.q = q;
  a.k = k;
  a.v = v;
  a.kbuf = kbuf;
  a.vbuf = vbuf;
  a.flags = static_cast<int*>(flags);
  a.words = words;
  a.strag_rank = strag_rank;
  a.strag_ns = strag_ns;
  if (wgmma) {
    if (dtype != 1 || D != 128 || kWfRows % (Hq / Hkv) != 0 ||
        S % kWfKeys != 0)
      return int(cudaErrorInvalidValue);
    CUtensorMap maps[5];
    if (!encode_q_map(&maps[0], q, n * B, S, Hq, Hkv) ||
        !encode_kv_map(&maps[1], k, n * B, S, Hkv) ||
        !encode_kv_map(&maps[2], v, n * B, S, Hkv) ||
        !encode_kv_map(&maps[3], kbuf, n * (n - 1) * B, S, Hkv) ||
        !encode_kv_map(&maps[4], vbuf, n * (n - 1) * B, S, Hkv))
      return int(cudaErrorInvalidValue);
    return int(shmem::launch_world(fp_sp_wgmma_kernel, n, 1 << 20, 384,
                                   kWfSmem, st, info, maps[0], maps[1],
                                   maps[2], maps[3], maps[4], a));
  }
  if (dtype == 0 && D == 128)
    return int(shmem::launch_world(fp_sp_kernel<FmaFold<128>>, n, 1 << 20,
                                   128, FmaFold<128>::kSmem, st, info, a));
  if (dtype == 0 && D == 64)
    return int(shmem::launch_world(fp_sp_kernel<FmaFold<64>>, n, 1 << 20,
                                   128, FmaFold<64>::kSmem, st, info, a));
  if (dtype == 1 && D == 128)
    return int(shmem::launch_world(fp_sp_kernel<TcFold<128>>, n, 1 << 20,
                                   128, TcFold<128>::kSmem, st, info, a));
  if (dtype == 1 && D == 64)
    return int(shmem::launch_world(fp_sp_kernel<TcFold<64>>, n, 1 << 20,
                                   128, TcFold<64>::kSmem, st, info, a));
  return int(cudaErrorInvalidValue);
}

extern "C" const char* fp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
