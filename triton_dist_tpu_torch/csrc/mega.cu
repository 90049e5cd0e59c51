// The decode megakernel: one decode step's task queue in one persistent
// cooperative launch, sm_90a.
//
// Replaces the Pallas TPU kernel that `compile_graph` builds in
// triton_dist_tpu/mega/kernel.py (:980, body :1192, launched at :1386),
// with its eight branches (:286-925). The queue, the workspace slots and
// the branch arithmetic are the JAX kernel's; how the tasks are spread
// over the card is not.
//
// On the TPU one core walks the queue in program order, so a task's
// inputs are ready when it starts. Here every task is cut into tiles and
// all resident blocks of a rank share them (the reference's scoreboard):
// every block walks the same queue in order and takes the tiles
// i = block, block + blocks, ... of each row. Before a tile, thread 0
// spins (bounded, shmem::spin_until) until the completion counter of each
// producer task holds that producer's tile count; after it, the block
// syncs and adds one to its own task's counter with release semantics.
// The counters are one zeroed int32 a (task, rank), from the virtual
// world's flag pool (runtime/symm_mem.py).
//
// Why it cannot deadlock: the launch is cooperative, so every block is
// resident, and every block walks the same topological order. A tile of
// row r waits only on tiles of rows before r (its producers) and, in the
// AllReduce, on the same tile of row r on the other ranks, which waits
// only on rows before r. By induction over r, every tile of the rows
// before r finishes, every block reaches its tiles of row r after them,
// and row r finishes too.
//
// Branches, with the JAX rounding points (f32 math, rounded to the
// activation dtype where the JAX branch rounds):
//   matmul        y = a @ W[layer] over the B rows, whole-K f32
//                 accumulation rounded once (kernel.py:401-405); tile =
//                 a column block of W and, for a narrow N, a range of K
//                 whose f32 partials the block's last tile adds in K
//                 order before the one rounding. Prologue "rms" (`_rms_f32`,
//                 :192, recomputed each tile from the (B, K) row) or
//                 "silu" (`_silu_f32`, :198), each rounded to the
//                 activation dtype before the product (:350-358).
//   rms_norm      :421, a tile a batch row.
//   silu_mul      :462, add :498 (in the activation dtype), column tiles.
//   allreduce_add at n > 1 each rank's tile puts its column slice into
//                 every rank's mailbox slot for this task, adds one to
//                 that rank's arrival flag of the tile, waits for its own
//                 n arrivals, and folds ranks 0..n-1 in f32 plus the
//                 residual, rounded once (:624-648); at n = 1 partial +
//                 residual in f32. One mailbox slot a task: a launch
//                 never reuses one, so the JAX parity buffers (:608-616)
//                 and their flow control are not needed.
//   attention     :671, a tile a (batch row, kv head): q/k rms-norm,
//                 rope at pos[b] (half split), GQA online softmax over
//                 the cached prefix read through the page table, seeded
//                 with the new token's k/v in f32 (they enter no cache);
//                 writes the attention output and the k_new/v_new rows.
//   barrier       :526, every block of every rank meets once.
//   noop          :925.
//
// What bounds it on an H100: bytes. A decode step reads every weight of
// the layer stack once (Qwen3-8B: 13.89 GB at world 1) plus the KV prefix;
// at B <= 16 the products are far below the ridge. The design streams
// each weight row-major with 16-byte loads (__ldcs: read once, evicted
// first), two batches of 4-8 loads in flight a thread (the next batch
// issued before this one's FMAs), one block a SM; the host cuts each
// matmul so its tiles fill the blocks in one wave with runs of at least
// 128 columns of a weight row (mega/core.py mm_tiling: shorter runs
// streamed at 1.3-1.4 TB/s). cp.async/TMA weight prefetch across task
// boundaries, wgmma and a multi-queue schedule are later work.
//
// Memory order (shmem.cuh's rule): a tile's stores, __syncthreads(),
// thread 0 __threadfence() + release add; a reader's thread 0 acquire
// spin, __syncthreads(), then __ldcg for every workspace and mailbox read
// (another block wrote it, and slots are reused: L1 could hold a stale
// line).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "shmem.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRow = 26;        // queue row (mega/kernel.py ROW)
constexpr int kMaxW = 8;        // weight tensors (kernels/mega.py)
constexpr int kChunk = 128;     // cached positions an attention pass
constexpr int kAccPer = 4;      // attention outputs a thread: g*D <= 1024
constexpr int kMaxPV = 32;      // P.V values a lane: g * D / 32 <= 32
constexpr int kPVRows = 4;      // V rows a warp loads before its FMAs

enum Op {
  kMatmul = 0,
  kRmsNorm,
  kSiluMul,
  kAdd,
  kAllReduceAdd,
  kAttention,
  kBarrier,
  kNoop
};

// argument indices: the order of _ARGS in kernels/mega.py
enum Arg {
  A_QUEUE = 0, A_NROWS, A_POS, A_TABLE, A_MAXP, A_WS, A_WS_RANK, A_WS_SLOT,
  A_WMAX, A_BATCH, A_NORMS, A_NORM_W, A_ROPE, A_KPOOL, A_VPOOL, A_HKV_TOT,
  A_NPAGES, A_PAGE, A_MBOX, A_MB_RANK, A_MB_TASK, A_MB_SRC, A_MB_W, A_FLAGS,
  A_FLAG_STRIDE, A_BARRIER_FLAG, A_PARTIAL, A_PARTIAL_STRIDE, A_NW, A_W0,
  A_WLAYER0 = A_W0 + kMaxW,
  A_WRANK0 = A_WLAYER0 + kMaxW,
  A_COUNT = A_WRANK0 + kMaxW
};

struct Params {
  const int* queue;
  int n_rows;
  const int* pos;
  const int* table;
  int maxp;
  void* ws;
  long long ws_rank, ws_slot;  // elements between ranks, between slots
  int wmax, batch;
  const float* norms;
  int norm_w;
  const float* rope;  // (positions, D) f32: [cos | sin]
  const void* kpool;
  const void* vpool;  // (L, hkv_tot, n_pages, page, D)
  int hkv_tot, n_pages, page;
  void* mbox;  // (n, tasks, n, B, mb_w)
  long long mb_rank, mb_task, mb_src;
  int mb_w;
  int* flags;
  int flag_stride, barrier_flag;
  float* partial;  // (n, partial_stride) f32 partial sums of split matmuls
  long long partial_stride;
  const void* w[kMaxW];
  long long w_layer[kMaxW], w_rank[kMaxW];
};

// S: the storage type, float or unsigned short (bf16 bits)
__device__ __forceinline__ float f32(float x) { return x; }
__device__ __forceinline__ float f32(unsigned short x) {
  return __bfloat162float(__ushort_as_bfloat16(x));
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(unsigned short* p, float v) {
  *p = __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
// v rounded to the storage type and back
__device__ __forceinline__ float rnd(float v, float) { return v; }
__device__ __forceinline__ float rnd(float v, unsigned short) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
// a workspace or mailbox element: another block wrote it, past L1
template <typename S>
__device__ __forceinline__ float ldws(const S* p) {
  return f32(__ldcg(p));
}
// VEC = 16 / sizeof(S) consecutive workspace elements (16-byte aligned)
template <typename S, int VEC>
__device__ __forceinline__ void ldws_vec(const S* p, float (&v)[VEC]) {
  const uint4 w = __ldcg(reinterpret_cast<const uint4*>(p));
  const S* e = reinterpret_cast<const S*>(&w);
#pragma unroll
  for (int j = 0; j < VEC; ++j) v[j] = f32(e[j]);
}
__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// sum of v over the block, returned to every thread (red: kWarps floats)
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();  // red may still be read from the last call
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += red[w];
  return s;
}

template <typename S>
__device__ __forceinline__ S* slot(const Params& p, int rank, int s) {
  return static_cast<S*>(p.ws) + rank * p.ws_rank + s * p.ws_slot;
}

// rows of `a` staged a pass: 64 KB of f32
template <int BP>
__host__ __device__ constexpr int stage_rows() {
  return 16384 / BP;
}

template <int BP>
__host__ __device__ constexpr size_t smem_bytes() {
  return (stage_rows<BP>() * BP + BP + kWarps * BP) * sizeof(float);
}

// U 16-byte weight vectors, rows ks + (r + u) * KS of the pass (zero past
// `rows`): read once, so streamed past L1 and evicted first (__ldcs)
template <int U, typename S>
__device__ __forceinline__ void load_rows(uint4 (&v)[U], const S* wp, int ks,
                                          int KS, int r, int rows, int N) {
#pragma unroll
  for (int u = 0; u < U; ++u)
    v[u] = r + u < rows ? __ldcs(reinterpret_cast<const uint4*>(
                              wp + size_t(ks + (r + u) * KS) * N))
                        : make_uint4(0, 0, 0, 0);
}

// acc[b][j] += a[b] * W[row][j] for one 16-byte vector of the row
template <typename S, int BP, int VEC>
__device__ __forceinline__ void fma_row(float (&acc)[BP][VEC],
                                        const uint4& wv, const float* a) {
  const S* we = reinterpret_cast<const S*>(&wv);
  float wf[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) wf[j] = f32(we[j]);
#pragma unroll
  for (int b = 0; b < BP; b += 4) {
    const float4 av = *reinterpret_cast<const float4*>(a + b);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      acc[b][j] = fmaf(av.x, wf[j], acc[b][j]);
      acc[b + 1][j] = fmaf(av.y, wf[j], acc[b + 1][j]);
      acc[b + 2][j] = fmaf(av.z, wf[j], acc[b + 2][j]);
      acc[b + 3][j] = fmaf(av.w, wf[j], acc[b + 3][j]);
    }
  }
}

// The last of a column block's `split` tiles to arrive adds their f32
// partial sums in K order and rounds once: each tile's partials are
// written, then its thread 0 fences and takes an arrival (acq_rel), so
// the last arriver sees every tile's partials (read past L1).
__device__ __forceinline__ int atom_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

template <typename S>
__device__ void split_combine(const Params& p, const int* q, int col,
                              int split, int B, int TN, int c0, int me,
                              S* y) {
  __shared__ int last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atom_add_acq_rel(
               p.flags + size_t(me) * p.flag_stride + q[13] + col, 1) ==
           split - 1;
  }
  __syncthreads();
  if (!last) return;
  const float* base = p.partial + me * p.partial_stride + q[16] +
                      size_t(col) * split * B * TN;
  for (int o = threadIdx.x; o < B * TN; o += kThreads) {
    float s = 0.f;
    for (int k = 0; k < split; ++k) s += __ldcg(base + k * B * TN + o);
    store(y + size_t(o / TN) * p.wmax + c0 + o % TN, s);
  }
}

// One column tile [c0, c0 + TN) of y (B, N) = prologue(x) @ W (K, N).
// Thread (ks, cg) owns column group cg (VEC columns) and the rows
// k = ks, ks + KS, ...; the KS partial sums of a column are added in ks
// order in shared memory and rounded once.
template <typename S, int BP>
__device__ void matmul_tile(const Params& p, const int* q, int tile, int me,
                            float* sm) {
  constexpr int VEC = 16 / sizeof(S);
  constexpr int KC = stage_rows<BP>();
  constexpr int U = BP <= 4 ? 8 : 4;  // weight vectors a batch a thread
  const int layer = q[1], src = q[2], dst = q[3], nrow = q[4];
  const int TN = q[8], K = q[9], N = q[10], pro = q[11], wi = q[12];
  const float eps = __int_as_float(q[14]);
  const int split = q[15], col = tile / split, ks0 = tile % split;
  const int KR = K / split;  // this tile's rows of W: [ks0 * KR, + KR)
  const int B = p.batch, wmax = p.wmax;
  const S* x = slot<S>(p, me, src);
  S* y = slot<S>(p, me, dst);
  const S* W = static_cast<const S*>(p.w[wi]) + layer * p.w_layer[wi] +
               me * p.w_rank[wi];
  const int c0 = col * TN;
  const int CG = TN / VEC, KS = kThreads / CG;
  const int cg = threadIdx.x % CG, ks = threadIdx.x / CG;
  float* a_s = sm;              // [KC][BP]
  float* scale = sm + KC * BP;  // [BP]
  float* red = scale + BP;      // [kWarps][BP]
  const float* nw = p.norms + size_t(nrow) * p.norm_w;

  if (pro == 1) {  // rms factors of the B rows, over all of K
    float ss[BP];
#pragma unroll
    for (int b = 0; b < BP; ++b) ss[b] = 0.f;
    for (int k = threadIdx.x * VEC; k < K; k += kThreads * VEC) {
#pragma unroll
      for (int b = 0; b < BP; ++b)
        if (b < B) {
          float v[VEC];
          ldws_vec(x + size_t(b) * wmax + k, v);
#pragma unroll
          for (int j = 0; j < VEC; ++j) ss[b] = fmaf(v[j], v[j], ss[b]);
        }
    }
#pragma unroll
    for (int b = 0; b < BP; ++b) {
      const float s = warp_sum(ss[b]);
      if (threadIdx.x % 32 == 0) red[(threadIdx.x / 32) * BP + b] = s;
    }
    __syncthreads();
    if (threadIdx.x < BP) {
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += red[w * BP + threadIdx.x];
      scale[threadIdx.x] = rsqrtf(s / float(K) + eps);
    }
  }

  float acc[BP][VEC];
#pragma unroll
  for (int b = 0; b < BP; ++b)
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[b][j] = 0.f;

  for (int k0 = ks0 * KR; k0 < (ks0 + 1) * KR; k0 += KC) {
    const int kc = min(KC, (ks0 + 1) * KR - k0);
    __syncthreads();  // the last pass's readers of a_s are done
    const int kcv = kc / VEC;  // 16-byte vectors of a row in this pass
    for (int i = threadIdx.x; i < BP * kcv; i += kThreads) {
      const int b = i / kcv, kk = (i - b * kcv) * VEC, k = k0 + kk;
      float v[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[j] = 0.f;
      if (b < B) {
        const S* xr = x + size_t(b) * wmax;
        ldws_vec(xr + k, v);
        if (pro == 1) {
#pragma unroll
          for (int j = 0; j < VEC; ++j)
            v[j] = rnd(v[j] * scale[b] * nw[k + j], S());
        } else if (pro == 2) {
          float u[VEC];
          ldws_vec(xr + K + k, u);
#pragma unroll
          for (int j = 0; j < VEC; ++j)
            v[j] = rnd(v[j] * sigmoid(v[j]) * u[j], S());
        }
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) a_s[(kk + j) * BP + b] = v[j];
    }
    __syncthreads();
    if (ks < KS) {
      // this thread's rows of the pass: kk = ks + r * KS < kc; U of them
      // a batch, the next batch's loads issued before this one's FMAs
      const S* wp = W + size_t(k0) * N + c0 + cg * VEC;
      const int rows = (kc - ks + KS - 1) / KS;
      uint4 cur[U], nxt[U];
      load_rows<U>(cur, wp, ks, KS, 0, rows, N);
      for (int r = 0; r < rows; r += U) {
        if (r + U < rows) load_rows<U>(nxt, wp, ks, KS, r + U, rows, N);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int kk = r + u < rows ? ks + (r + u) * KS : 0;
          fma_row<S, BP, VEC>(acc, cur[u], a_s + kk * BP);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) cur[u] = nxt[u];
      }
    }
  }

  // the KS partial sums of each column, in ks order, rounded once; four
  // rows at a time (4 * KS * TN <= 4 * kThreads * VEC floats). A split
  // matmul writes them in f32 to its partials [col][ks0][b][c] instead
  float* part = sm;
  float* mine = p.partial + me * p.partial_stride + q[16] +
                size_t(col * split + ks0) * B * TN;
#pragma unroll
  for (int b0 = 0; b0 < BP; b0 += 4) {
    if (b0 >= B) break;
    __syncthreads();
    if (ks < KS)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb)
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          part[(bb * KS + ks) * TN + cg * VEC + j] = acc[b0 + bb][j];
    __syncthreads();
    const int nb = min(4, B - b0);
    for (int o = threadIdx.x; o < nb * TN; o += kThreads) {
      const int bb = o / TN, c = o - bb * TN;
      const float* pp = part + bb * KS * TN + c;
      float s = 0.f;
      for (int k = 0; k < KS; ++k) s += pp[k * TN];
      if (split == 1)
        store(y + size_t(b0 + bb) * wmax + c0 + c, s);
      else
        mine[(b0 + bb) * TN + c] = s;
    }
  }
  if (split > 1) split_combine<S>(p, q, col, split, B, TN, c0, me, y);
}

// rms_norm of batch row b over W columns
template <typename S>
__device__ void rms_norm_tile(const Params& p, const int* q, int b, int me,
                              float* sm) {
  const int nrow = q[1], W = q[9];
  const float eps = __int_as_float(q[14]);
  const S* x = slot<S>(p, me, q[2]) + size_t(b) * p.wmax;
  S* y = slot<S>(p, me, q[3]) + size_t(b) * p.wmax;
  const float* nw = p.norms + size_t(nrow) * p.norm_w;
  float ss = 0.f;
  for (int k = threadIdx.x; k < W; k += kThreads) {
    const float v = ldws(x + k);
    ss = fmaf(v, v, ss);
  }
  const float r = rsqrtf(block_sum(ss, sm) / float(W) + eps);
  for (int k = threadIdx.x; k < W; k += kThreads)
    store(y + k, ldws(x + k) * r * nw[k]);
}

// silu_mul (op kSiluMul) or add (kAdd) over columns [c0, c0 + TE)
template <typename S>
__device__ void elementwise_tile(const Params& p, const int* q, int tile,
                                 int me) {
  const int TE = q[8], W = q[9], c0 = tile * TE, B = p.batch;
  const size_t wm = p.wmax;
  for (int i = threadIdx.x; i < B * TE; i += kThreads) {
    const int b = i / TE, c = c0 + i % TE;
    if (q[0] == kSiluMul) {
      const S* x = slot<S>(p, me, q[1]) + b * wm;
      const float g = ldws(x + c), u = ldws(x + W + c);
      store(slot<S>(p, me, q[2]) + b * wm + c, g * sigmoid(g) * u);
    } else {
      store(slot<S>(p, me, q[3]) + b * wm + c,
            ldws(slot<S>(p, me, q[1]) + b * wm + c) +
                ldws(slot<S>(p, me, q[2]) + b * wm + c));
    }
  }
}

// dst = sum over ranks of partial + residual, columns [c0, c0 + TE)
template <typename S>
__device__ void allreduce_add_tile(const Params& p, const int* q, int tile,
                                   int me) {
  const int n = gridDim.y, TE = q[8], c0 = tile * TE, B = p.batch;
  const int mb = q[12], flag = q[13] + tile;
  const size_t wm = p.wmax;
  const S* part = slot<S>(p, me, q[1]);
  const S* res = slot<S>(p, me, q[2]);
  S* y = slot<S>(p, me, q[3]);
  S* box = static_cast<S*>(p.mbox);
  if (n > 1) {
    for (int peer = 0; peer < n; ++peer) {
      S* to = box + peer * p.mb_rank + mb * p.mb_task + me * p.mb_src;
      for (int i = threadIdx.x; i < B * TE; i += kThreads) {
        const int b = i / TE, c = c0 + i % TE;
        to[b * p.mb_w + c] = __ldcg(part + b * wm + c);
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      for (int peer = 0; peer < n; ++peer)
        shmem::atom_add_release(p.flags + size_t(peer) * p.flag_stride + flag,
                                1);
    }
    shmem::signal_wait_until(p.flags + size_t(me) * p.flag_stride + flag,
                             shmem::kEq, n, "mega", me, flag);
  }
  const S* mine = box + me * p.mb_rank + mb * p.mb_task;
  for (int i = threadIdx.x; i < B * TE; i += kThreads) {
    const int b = i / TE, c = c0 + i % TE;
    float acc;
    if (n > 1) {
      acc = ldws(mine + b * p.mb_w + c);
      for (int r = 1; r < n; ++r) acc += ldws(mine + r * p.mb_src + b * p.mb_w + c);
    } else {
      acc = ldws(part + b * wm + c);
    }
    store(y + b * wm + c, acc + ldws(res + b * wm + c));
  }
}

// decode attention of (batch row b, kv head h) = (tile / hkv_l, tile % hkv_l)
// over D = 32 * DL. The cached prefix is folded in passes of kChunk
// positions into an online softmax seeded with the new token: the logits
// with a thread a (position, head), 16-byte loads along a K row; the
// running max, the weights and the denominator with a warp a head; P.V
// with a warp a share of the positions and a lane DL elements of D,
// summed over the warps in order.
template <typename S, int DL>
__device__ void attention_tile(const Params& p, const int* q, int tile,
                               int me, float* sm) {
  constexpr int VEC = 16 / sizeof(S);
  constexpr int D = 32 * DL;
  const int layer = q[1];
  const int hq_l = q[8], hkv_l = q[9], qkn = q[11];
  const float eps = __int_as_float(q[14]);
  const int b = tile / hkv_l, h = tile % hkv_l;
  const int g = hq_l / hkv_l, half = D / 2, hqd = hq_l * D, kw = hkv_l * D;
  const int wid = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t wm = p.wmax;
  float* qs = sm;                // [g][D], then k_new [D], v_new [D]
  float* kn = qs + g * D;
  float* vn = kn + D;
  float* lg = vn + D;            // [g][kChunk]
  float* m_s = lg + g * kChunk;  // running max, denominator, rescale [g]
  float* den_s = m_s + g;
  float* al_s = den_s + g;
  float* part = al_s + g;        // [kWarps][g * D]

  const S* xr = slot<S>(p, me, q[2]) + b * wm;
  for (int i = threadIdx.x; i < (g + 2) * D; i += kThreads) {
    const int v = i / D, d = i % D;
    const int col = v < g ? (h * g + v) * D + d
                          : (v == g ? hqd : hqd + kw) + h * D + d;
    qs[i] = ldws(xr + col);
  }
  __syncthreads();
  if (qkn) {  // rms-norm each q head and k over D
    const float* wq = p.norms + size_t(q[12] + layer) * p.norm_w;
    const float* wk = p.norms + size_t(q[13] + layer) * p.norm_w;
    for (int v = wid; v <= g; v += kWarps) {
      float* x = qs + v * D;
      float ss = 0.f;
      for (int d = lane; d < D; d += 32) ss = fmaf(x[d], x[d], ss);
      const float r = rsqrtf(warp_sum(ss) / float(D) + eps);
      const float* w = v < g ? wq : wk;
      for (int d = lane; d < D; d += 32) x[d] = x[d] * r * w[d];
    }
    __syncthreads();
  }
  const int T = p.pos[b];  // cached positions 0..T-1; the new token at T
  const float* cs = p.rope + size_t(T) * D;
  for (int i = threadIdx.x; i < (g + 1) * half; i += kThreads) {
    float* x = qs + (i / half) * D;
    const int j = i % half;
    const float c = cs[j], s = cs[half + j], x1 = x[j], x2 = x[j + half];
    x[j] = x1 * c - x2 * s;
    x[j + half] = x2 * c + x1 * s;
  }
  __syncthreads();
  S* kno = slot<S>(p, me, q[4]) + b * wm + h * D;
  S* vno = slot<S>(p, me, q[5]) + b * wm + h * D;
  for (int d = threadIdx.x; d < D; d += kThreads) {
    store(kno + d, kn[d]);
    store(vno + d, vn[d]);
  }
  const float scale = 1.f / sqrtf(float(D));
  for (int i = threadIdx.x; i < g * D; i += kThreads) qs[i] *= scale;
  __syncthreads();
  // the online softmax starts from the new token: logit q.k_new, weight 1
  for (int i = wid; i < g; i += kWarps) {
    float s = 0.f;
    for (int d = lane; d < D; d += 32) s = fmaf(qs[i * D + d], kn[d], s);
    s = warp_sum(s);
    if (lane == 0) {
      m_s[i] = s;
      den_s[i] = 1.f;
    }
  }
  float acc[kAccPer];
#pragma unroll
  for (int j = 0; j < kAccPer; ++j) {
    const int o = threadIdx.x + j * kThreads;
    acc[j] = o < g * D ? vn[o % D] : 0.f;
  }
  __syncthreads();

  const size_t head = size_t(layer) * p.hkv_tot + me * hkv_l + h;
  const S* kbase = static_cast<const S*>(p.kpool) + head * p.n_pages * p.page * D;
  const S* vbase = static_cast<const S*>(p.vpool) + head * p.n_pages * p.page * D;
  const int* tbl = p.table + size_t(b) * p.maxp;
  for (int t0 = 0; t0 < T; t0 += kChunk) {
    const int tc = min(kChunk, T - t0);
    for (int i = threadIdx.x; i < g * tc; i += kThreads) {  // logits
      const int hd = i / tc, t = i - hd * tc, tp = t0 + t;
      const S* kr = kbase + (size_t(tbl[tp / p.page]) * p.page + tp % p.page) * D;
      const float* qh = qs + hd * D;
      float s = 0.f;
#pragma unroll
      for (int d0 = 0; d0 < D; d0 += VEC) {
        const uint4 w = __ldg(reinterpret_cast<const uint4*>(kr + d0));
        const S* e = reinterpret_cast<const S*>(&w);
#pragma unroll
        for (int j = 0; j < VEC; ++j) s = fmaf(qh[d0 + j], f32(e[j]), s);
      }
      lg[hd * kChunk + t] = s;
    }
    __syncthreads();
    for (int i = wid; i < g; i += kWarps) {  // max, weights, denominator
      float mx = m_s[i];
      for (int t = lane; t < tc; t += 32) mx = fmaxf(mx, lg[i * kChunk + t]);
      mx = warp_max(mx);
      float sum = 0.f;
      for (int t = lane; t < tc; t += 32) {
        const float e = expf(lg[i * kChunk + t] - mx);
        lg[i * kChunk + t] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float al = expf(m_s[i] - mx);
        al_s[i] = al;
        den_s[i] = den_s[i] * al + sum;
        m_s[i] = mx;
      }
    }
    __syncthreads();
    // P.V: warp wid takes positions wid, wid + kWarps, ...; lane owns
    // d in [lane * DL, lane * DL + DL) of every head (g * DL <= kAccPer *
    // kThreads / 32 values)
    float pacc[kMaxPV];
#pragma unroll
    for (int k = 0; k < kMaxPV; ++k) pacc[k] = 0.f;
    for (int t = wid; t < tc; t += kPVRows * kWarps) {
      float vf[kPVRows][DL];  // kPVRows positions' loads in flight
#pragma unroll
      for (int u = 0; u < kPVRows; ++u) {
        const int tp = t0 + min(t + u * kWarps, tc - 1);
        const S* vr = vbase +
                      (size_t(tbl[tp / p.page]) * p.page + tp % p.page) * D +
                      lane * DL;
#pragma unroll
        for (int j = 0; j < DL; ++j) vf[u][j] = f32(__ldg(vr + j));
      }
#pragma unroll
      for (int u = 0; u < kPVRows; ++u)
        if (t + u * kWarps < tc)
#pragma unroll
          for (int i = 0; i < kMaxPV / DL; ++i)
            if (i < g) {
              const float pw = lg[i * kChunk + t + u * kWarps];
#pragma unroll
              for (int j = 0; j < DL; ++j)
                pacc[i * DL + j] = fmaf(pw, vf[u][j], pacc[i * DL + j]);
            }
    }
#pragma unroll
    for (int i = 0; i < kMaxPV / DL; ++i)
      if (i < g)
#pragma unroll
        for (int j = 0; j < DL; ++j)
          part[wid * g * D + i * D + lane * DL + j] = pacc[i * DL + j];
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kAccPer; ++j) {  // acc = acc * alpha + P.V
      const int o = threadIdx.x + j * kThreads;
      if (o < g * D) {
        float s = 0.f;
        for (int w = 0; w < kWarps; ++w) s += part[w * g * D + o];
        acc[j] = acc[j] * al_s[o / D] + s;
      }
    }
    __syncthreads();
  }
  S* out = slot<S>(p, me, q[3]) + b * wm + h * g * D;
#pragma unroll
  for (int j = 0; j < kAccPer; ++j) {
    const int o = threadIdx.x + j * kThreads;
    if (o < g * D) store(out + o, acc[j] / den_s[o / D]);
  }
}

template <typename S, int BP>
__global__ void __launch_bounds__(kThreads, 1) mega_kernel(Params p) {
  extern __shared__ __align__(16) float sm[];
  const int me = blockIdx.y;
  int* counters = p.flags + size_t(me) * p.flag_stride;
  for (int row = 0; row < p.n_rows; ++row) {
    const int* q = p.queue + row * kRow;
    const int op = q[0], nt = q[7];
    for (int tile = blockIdx.x; tile < nt; tile += gridDim.x) {
      if (threadIdx.x == 0)
        for (int i = 0; i < q[17]; ++i) {
          const int pr = q[18 + i];
          shmem::spin_until(counters + pr, shmem::kEq, p.queue[pr * kRow + 7],
                            "mega", me, pr);
        }
      __syncthreads();
      switch (op) {
        case kMatmul:
          matmul_tile<S, BP>(p, q, tile, me, sm);
          break;
        case kRmsNorm:
          rms_norm_tile<S>(p, q, tile, me, sm);
          break;
        case kSiluMul:
        case kAdd:
          elementwise_tile<S>(p, q, tile, me);
          break;
        case kAllReduceAdd:
          allreduce_add_tile<S>(p, q, tile, me);
          break;
        case kAttention:  // D = 32 * DL
          if (q[10] == 32) attention_tile<S, 1>(p, q, tile, me, sm);
          else if (q[10] == 64) attention_tile<S, 2>(p, q, tile, me, sm);
          else if (q[10] == 128) attention_tile<S, 4>(p, q, tile, me, sm);
          else attention_tile<S, 8>(p, q, tile, me, sm);
          break;
        case kBarrier:
          shmem::barrier_all(p.flags, p.flag_stride, p.barrier_flag, me,
                             gridDim.y, "mega");
          break;
        default:
          break;
      }
      shmem::signal_add(counters + row, 1);
    }
  }
}

template <typename S, int BP>
cudaError_t launch(const Params& prm, int n, int bpr, int* info,
                   cudaStream_t st) {
  void (*kern)(Params) = mega_kernel<S, BP>;
  const size_t smem = smem_bytes<BP>();
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                      smem);
  if (e != cudaSuccess) return e;
  info[0] = per_sm;
  info[1] = sms;
  info[2] = per_sm * sms / n;
  // the tiles were cut for bpr blocks a rank, and the barrier counts them
  if (info[2] < bpr) return cudaErrorCooperativeLaunchTooLarge;
  return shmem::launch_world(kern, n, bpr, kThreads, smem, st, info, prm);
}

}  // namespace

extern "C" int mega_arg_count() { return A_COUNT; }

// a: the A_COUNT int64 arguments (kernels/mega.py _ARGS); n ranks of bpr
// blocks; dtype 0 = float32, 1 = bfloat16; info: 3 ints (launch_world).
// Returns a cudaError_t (0 = launched).
extern "C" int mega_launch(const long long* a, int n, int bpr, int dtype,
                           void* info, void* stream) {
  Params p;
  p.queue = reinterpret_cast<const int*>(a[A_QUEUE]);
  p.n_rows = int(a[A_NROWS]);
  p.pos = reinterpret_cast<const int*>(a[A_POS]);
  p.table = reinterpret_cast<const int*>(a[A_TABLE]);
  p.maxp = int(a[A_MAXP]);
  p.ws = reinterpret_cast<void*>(a[A_WS]);
  p.ws_rank = a[A_WS_RANK];
  p.ws_slot = a[A_WS_SLOT];
  p.wmax = int(a[A_WMAX]);
  p.batch = int(a[A_BATCH]);
  p.norms = reinterpret_cast<const float*>(a[A_NORMS]);
  p.norm_w = int(a[A_NORM_W]);
  p.rope = reinterpret_cast<const float*>(a[A_ROPE]);
  p.kpool = reinterpret_cast<const void*>(a[A_KPOOL]);
  p.vpool = reinterpret_cast<const void*>(a[A_VPOOL]);
  p.hkv_tot = int(a[A_HKV_TOT]);
  p.n_pages = int(a[A_NPAGES]);
  p.page = int(a[A_PAGE]);
  p.mbox = reinterpret_cast<void*>(a[A_MBOX]);
  p.mb_rank = a[A_MB_RANK];
  p.mb_task = a[A_MB_TASK];
  p.mb_src = a[A_MB_SRC];
  p.mb_w = int(a[A_MB_W]);
  p.flags = reinterpret_cast<int*>(a[A_FLAGS]);
  p.flag_stride = int(a[A_FLAG_STRIDE]);
  p.barrier_flag = int(a[A_BARRIER_FLAG]);
  p.partial = reinterpret_cast<float*>(a[A_PARTIAL]);
  p.partial_stride = a[A_PARTIAL_STRIDE];
  const int nw = int(a[A_NW]);
  for (int i = 0; i < kMaxW; ++i) {
    p.w[i] = i < nw ? reinterpret_cast<const void*>(a[A_W0 + i]) : nullptr;
    p.w_layer[i] = a[A_WLAYER0 + i];
    p.w_rank[i] = a[A_WRANK0 + i];
  }
  if (n < 1 || bpr < 1 || p.batch < 1 || p.batch > 16 || nw > kMaxW)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* inf = static_cast<int*>(info);
  const bool small = p.batch <= 4;
  if (dtype == 0)
    return int(small ? launch<float, 4>(p, n, bpr, inf, st)
                     : launch<float, 16>(p, n, bpr, inf, st));
  if (dtype == 1)
    return int(small ? launch<unsigned short, 4>(p, n, bpr, inf, st)
                     : launch<unsigned short, 16>(p, n, bpr, inf, st));
  return int(cudaErrorInvalidValue);
}

extern "C" const char* mega_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
