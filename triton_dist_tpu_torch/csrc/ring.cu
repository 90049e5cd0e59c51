// The resident serving loop's step boundary and step epilogue on the card:
// the integer bookkeeping around each serve step of a window, so that a
// window of W steps is one CUDA graph with no host read between steps.
//
// They replace no TPU kernel. The JAX package runs this bookkeeping as
// XLA code inside its `lax.while_loop` (triton_dist_tpu/models/engine.py
// `_build_resident_loop`: its cond :536-542, `boundary` :514 over
// `mega/ring.py` `device_consume` :387 and `slot_plan` :460, and
// `run_step` :662). They were added because the consumption is a
// data-dependent loop over records, which torch ops cannot express in a
// graph without a host read, and because the loop's exit must be decided
// on the card. Their plain versions are kernels/ring.py
// `ring_boundary_plain` / `ring_emit_plain` over the port's
// mega/ring.py, bitwise the JAX functions.
//
// The window state is one int32 block (kernels/ring.py `WindowGeometry`):
// a header of counters (published, consumed, step0, executed, idle, the
// sticky live word, this step's live flag, the out count, starved), the
// slot state (K, 16), the page table (K, MAXP), the lengths (K,) and the
// output ring (out_cap, 8). The host writes the header's inputs and the
// three state arrays before a window and reads the whole block back
// after it: one read a window.
//
// ring_boundary (step form), at the top of each of the W unrolled steps:
// unless the live word is already 0, it runs the JAX loop's iterations
// that run no forward: test the loop's cond (executed < W and (a slot
// active or (a record pending and idle < poll_budget))), consume every
// visible record at step step0 + executed (admit, retire, verify staging;
// host retirements reported into the output ring with REASON_HOST), and
// if no slot is active count an idle iteration and test again. It stops
// at the first iteration with an active slot, whose inputs it writes into
// the step's static buffers (tokens (K, C) from the admission rows or the
// last token, n_valid, temps, the keys fold_in(PRNGKey(seed), n_out) by
// threefry, emits, and int64 copies of the table and lengths for the
// forward); or, once the cond fails, it clears the live word, and every
// later step of the window is dead: n_valid 0 on every row, so the
// forward's KV scatter lands on the null page 0 only, and ring_emit does
// nothing. ring_boundary (final form), after the W steps: one more
// consumption at step0 + executed, then `starved` if the head record is
// published but not committed.
//
// ring_emit, after the step's sampling: the epilogue of the JAX loop body
// (`run_step`, spec_k = 0): eos and length finishes, lengths += n_valid,
// the slot state's position, phase, n_out, last token and active bit, one
// output record per emitting slot in slot order with a dense seq, and
// executed += 1.
//
// What bounds them: latency. One block each; thread 0 runs the serial
// record loop and the epilogue (K slots, a few records), the block fills
// the step's buffers (K x C tokens, K x MAXP table words). A few
// microseconds a launch, against a serve step of tens of milliseconds.

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

// -- layouts (kernels/ring.py and mega/ring.py) ------------------------------
constexpr int H_PUBLISHED = 0, H_CONSUMED = 1, H_STEP0 = 2, H_EXECUTED = 3,
              H_IDLE = 4, H_LIVE = 5, H_STEP_LIVE = 6, H_OUT_COUNT = 7,
              H_STARVED = 8, HEADER_WORDS = 16;
constexpr int IR_SEQ = 0, IR_KIND = 1, IR_SLOT = 2, IR_AT_STEP = 3,
              IR_PROMPT_LEN = 4, IR_MAX_NEW = 5, IR_TEMP_BITS = 6,
              IR_SEED = 7, IR_EOS = 8, IR_REQID = 9, IR_NOUT = 10,
              IR_SPEC_K = 11, IR_PREFIX = 12, IR_HEADER = 16;
constexpr int KIND_ADMIT = 1, KIND_RETIRE = 2, KIND_VERIFY = 3;
constexpr int OR_WIDTH = 8, FLAG_EMIT = 1, FLAG_RETIRED = 2, REASON_EOS = 1,
              REASON_LENGTH = 2, REASON_HOST = 3;
constexpr int SS_ACTIVE = 0, SS_PHASE = 1, SS_POS = 2, SS_PROMPT_LEN = 3,
              SS_MAX_NEW = 4, SS_N_OUT = 5, SS_TEMP_BITS = 6, SS_SEED = 7,
              SS_EOS = 8, SS_LAST_TOK = 9, SS_REC = 10, SS_REQID = 11,
              SS_SPEC_REC = 12, SS_SPEC_SEQ = 13, SS_SPEC_K = 14,
              SS_WIDTH = 16;
constexpr int kThreads = 256;

struct Window {
  const int* ring;
  int cap, rw;
  int* hdr;
  int* ss;
  int* table;
  int* lengths;
  int* out;
  int K, maxp, out_cap;
};

__device__ Window window_of(const int* ring, int cap, int rw, int* blk, int K,
                            int maxp, int out_cap) {
  Window w;
  w.ring = ring;
  w.cap = cap;
  w.rw = rw;
  w.hdr = blk;
  w.ss = blk + HEADER_WORDS;
  w.table = w.ss + K * SS_WIDTH;
  w.lengths = w.table + K * maxp;
  w.out = w.lengths + K;
  w.K = K;
  w.maxp = maxp;
  w.out_cap = out_cap;
  return w;
}

__device__ bool any_active(const Window& w) {
  for (int s = 0; s < w.K; ++s)
    if (w.ss[s * SS_WIDTH + SS_ACTIVE] > 0) return true;
  return false;
}

// one output record (the JAX scatter_out's row), at the next dense seq
__device__ void put_out(const Window& w, int slot, int step, int token,
                        int flags, int reason, int reqid) {
  const int row = w.hdr[H_OUT_COUNT];
  if (row >= w.out_cap) return;  // out_cap covers every window by design
  int* o = w.out + row * OR_WIDTH;
  o[0] = row + 1;
  o[1] = slot;
  o[2] = step;
  o[3] = token;
  o[4] = flags;
  o[5] = reason;
  o[6] = reqid;
  o[7] = 0;
  w.hdr[H_OUT_COUNT] = row + 1;
}

// device_consume at `step` (thread 0): every visible record, then the
// host retirements reported in slot order. Returns the records consumed.
__device__ int consume(const Window& w, int step) {
  const int published = w.hdr[H_PUBLISHED];
  int consumed = w.hdr[H_CONSUMED];
  const int c0 = consumed;
  uint32_t retired[2] = {0u, 0u};  // slots < 64 (the launcher checks)
  while (consumed < published) {
    const int rec_row = consumed % w.cap;
    const int* rec = w.ring + size_t(rec_row) * w.rw;
    if (rec[IR_SEQ] != consumed + 1 || rec[IR_AT_STEP] > step) break;
    const int slot = rec[IR_SLOT];
    if (slot >= 0 && slot < w.K) {
      int* row = w.ss + slot * SS_WIDTH;
      const int kind = rec[IR_KIND];
      if (kind == KIND_ADMIT) {
        for (int f = 0; f < SS_WIDTH; ++f) row[f] = 0;
        row[SS_ACTIVE] = 1;
        row[SS_POS] = rec[IR_PREFIX];
        row[SS_PROMPT_LEN] = rec[IR_PROMPT_LEN];
        row[SS_MAX_NEW] = rec[IR_MAX_NEW];
        row[SS_TEMP_BITS] = rec[IR_TEMP_BITS];
        row[SS_SEED] = rec[IR_SEED];
        row[SS_EOS] = rec[IR_EOS];
        row[SS_REC] = rec_row;
        row[SS_REQID] = rec[IR_REQID];
        for (int p = 0; p < w.maxp; ++p)
          w.table[slot * w.maxp + p] = rec[IR_HEADER + p];
        w.lengths[slot] = rec[IR_PREFIX];
      } else if (kind == KIND_RETIRE && row[SS_ACTIVE] > 0 &&
                 row[SS_REQID] == rec[IR_REQID]) {
        row[SS_ACTIVE] = 0;
        retired[slot >> 5] |= 1u << (slot & 31);
      } else if (kind == KIND_VERIFY && row[SS_ACTIVE] > 0 &&
                 row[SS_PHASE] == 1 && row[SS_REQID] == rec[IR_REQID] &&
                 row[SS_N_OUT] == rec[IR_NOUT]) {
        row[SS_SPEC_REC] = rec_row;
        row[SS_SPEC_SEQ] = rec[IR_SEQ];
        row[SS_SPEC_K] = rec[IR_SPEC_K];
      }
    }
    ++consumed;
  }
  for (int s = 0; s < w.K; ++s)
    if (retired[s >> 5] >> (s & 31) & 1u)
      put_out(w, s, step, -1, FLAG_RETIRED, REASON_HOST,
              w.ss[s * SS_WIDTH + SS_REQID]);
  w.hdr[H_CONSUMED] = consumed;
  return consumed - c0;
}

__global__ void __launch_bounds__(kThreads)
    ring_boundary_kernel(const int* __restrict__ ring, int cap, int rw,
                         int* blk, int K, int maxp, int out_cap, int chunk,
                         int window, int poll_budget, int final,
                         long long* tokens, long long* n_valid, float* temps,
                         int* keys, int* emits, long long* table64,
                         long long* lengths64) {
  const Window w = window_of(ring, cap, rw, blk, K, maxp, out_cap);
  __shared__ int live;
  const int tid = threadIdx.x;
  if (tid == 0) {
    live = 0;
    if (final) {
      consume(w, w.hdr[H_STEP0] + w.hdr[H_EXECUTED]);
      const int published = w.hdr[H_PUBLISHED];
      const int consumed = w.hdr[H_CONSUMED];
      const int* head = ring + size_t(consumed % cap) * rw;
      w.hdr[H_STARVED] = consumed < published && head[IR_SEQ] != consumed + 1;
    } else if (w.hdr[H_LIVE]) {
      for (;;) {
        const int executed = w.hdr[H_EXECUTED];
        const int consumed = w.hdr[H_CONSUMED];
        const int idle = w.hdr[H_IDLE];
        const bool go = executed < window &&
                        (any_active(w) || (consumed < w.hdr[H_PUBLISHED] &&
                                           idle < poll_budget));
        if (!go) {
          w.hdr[H_LIVE] = 0;
          break;
        }
        const int took = consume(w, w.hdr[H_STEP0] + executed);
        if (any_active(w)) {
          w.hdr[H_IDLE] = 0;
          live = 1;
          break;
        }
        w.hdr[H_IDLE] = took > 0 ? 0 : idle + 1;
      }
    }
    if (!final) w.hdr[H_STEP_LIVE] = live;
  }
  __syncthreads();
  if (final) return;
  const int prompt_base = IR_HEADER + maxp;
  for (int i = tid; i < K * chunk; i += kThreads) {
    const int s = i / chunk, c = i % chunk;
    const int* row = w.ss + s * SS_WIDTH;
    long long t = 0;
    if (live && row[SS_ACTIVE] > 0) {
      const int pos = row[SS_POS], plen = row[SS_PROMPT_LEN];
      if (row[SS_PHASE] == 0) {
        const int n = min(chunk, plen - pos);
        if (c < n) {
          int start = prompt_base + pos;  // dynamic_slice's clamp
          start = max(0, min(start, rw - chunk));
          t = ring[size_t(row[SS_REC]) * rw + start + c];
        }
      } else if (c == 0) {
        t = row[SS_LAST_TOK];
      }
    }
    tokens[i] = t;
  }
  for (int s = tid; s < K; s += kThreads) {
    const int* row = w.ss + s * SS_WIDTH;
    const bool active = live && row[SS_ACTIVE] > 0;
    const bool prefill = row[SS_PHASE] == 0;
    const int pos = row[SS_POS], plen = row[SS_PROMPT_LEN];
    const int n_pref = min(chunk, plen - pos);
    const int n = active ? (prefill ? n_pref : 1) : 0;
    const bool emit = active && (!prefill || pos + n_pref >= plen);
    n_valid[s] = n;
    emits[s] = emit;
    temps[s] = emit ? __int_as_float(row[SS_TEMP_BITS]) : 0.f;
    uint32_t k0 = 0, k1 = 0;
    if (emit) {
      k1 = uint32_t(row[SS_SEED]);
      threefry::fold_in(k0, k1, uint32_t(row[SS_N_OUT]));
    }
    keys[2 * s] = int(k0);
    keys[2 * s + 1] = int(k1);
    if (live) lengths64[s] = w.lengths[s];
  }
  if (live)
    for (int i = tid; i < K * maxp; i += kThreads) table64[i] = w.table[i];
}

__global__ void ring_emit_kernel(const long long* __restrict__ tok, int* blk,
                                 int K, int maxp, int out_cap,
                                 const long long* __restrict__ n_valid,
                                 const int* __restrict__ emits) {
  const Window w = window_of(nullptr, 0, 0, blk, K, maxp, out_cap);
  if (threadIdx.x != 0 || !w.hdr[H_STEP_LIVE]) return;
  const int step = w.hdr[H_STEP0] + w.hdr[H_EXECUTED];
  for (int s = 0; s < K; ++s) {
    int* row = w.ss + s * SS_WIDTH;
    const int nv = int(n_valid[s]);
    const bool emit = emits[s] != 0;
    const int t = int(tok[s]);
    w.lengths[s] += nv;
    const bool prefill = row[SS_PHASE] == 0;
    const int new_pos = row[SS_POS] + (prefill ? nv : 0);
    const bool completing =
        prefill && new_pos >= row[SS_PROMPT_LEN] && row[SS_ACTIVE] > 0;
    const int n_out = row[SS_N_OUT] + (emit ? 1 : 0);
    const int eos = row[SS_EOS];
    const bool hit_eos = emit && eos > 0 && t == eos - 1;
    const bool hit_len = emit && n_out >= row[SS_MAX_NEW];
    const bool finished = hit_eos || hit_len;
    row[SS_POS] = new_pos;
    if (completing) row[SS_PHASE] = 1;
    row[SS_N_OUT] = n_out;
    if (emit) row[SS_LAST_TOK] = t;
    if (finished) row[SS_ACTIVE] = 0;
    if (emit)
      put_out(w, s, step, t, FLAG_EMIT | (finished ? FLAG_RETIRED : 0),
              hit_eos ? REASON_EOS : (hit_len ? REASON_LENGTH : 0),
              row[SS_REQID]);
  }
  w.hdr[H_EXECUTED] += 1;
}

}  // namespace

extern "C" int ring_boundary_launch(const void* ring, int cap, int rw,
                                    void* blk, int K, int maxp, int out_cap,
                                    int chunk, int window, int poll_budget,
                                    int final, void* tokens, void* n_valid,
                                    void* temps, void* keys, void* emits,
                                    void* table64, void* lengths64,
                                    void* stream) {
  if (cap < 2 || K < 1 || K > 64 || maxp < 1 || chunk < 1 ||
      rw < IR_HEADER + maxp + chunk || window < 1 || poll_budget < 1)
    return int(cudaErrorInvalidValue);
  ring_boundary_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ring), cap, rw, static_cast<int*>(blk), K, maxp,
      out_cap, chunk, window, poll_budget, final,
      static_cast<long long*>(tokens), static_cast<long long*>(n_valid),
      static_cast<float*>(temps), static_cast<int*>(keys),
      static_cast<int*>(emits), static_cast<long long*>(table64),
      static_cast<long long*>(lengths64));
  return int(cudaGetLastError());
}

extern "C" int ring_emit_launch(const void* tok, void* blk, int K, int maxp,
                                int out_cap, const void* n_valid,
                                const void* emits, void* stream) {
  if (K < 1 || K > 64 || maxp < 1) return int(cudaErrorInvalidValue);
  ring_emit_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(tok), static_cast<int*>(blk), K, maxp,
      out_cap, static_cast<const long long*>(n_valid),
      static_cast<const int*>(emits));
  return int(cudaGetLastError());
}

extern "C" const char* ring_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
