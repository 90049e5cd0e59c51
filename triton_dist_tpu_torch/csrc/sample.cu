// Per-row token sampling on the card, by the JAX package's own key stream:
// for each row r of logits (R, V) f32, the argmax of
// logits[r] / max(T_r, 1e-6) + Gumbel(key_r) where T_r > 0, else the argmax
// of logits[r]; the lowest index wins a tie and a NaN counts as the
// largest value, as jnp.argmax.
//
// It replaces no TPU kernel: the JAX package samples with XLA code,
// `jax.random.categorical` under `fold_in(PRNGKey(seed), n_out)` keys
// (triton_dist_tpu/models/engine.py:84-90 `_serve_step_math`,
// triton_dist_tpu/mega/ring.py:500 `slot_plan`). It was added so that a
// serve step samples inside its CUDA graph, on the card, with no host
// loop and no host generator, and so that its sampled tokens are the JAX
// package's: the key words, the random bits and the uniforms are bitwise
// JAX's (threefry.cuh); the Gumbel noise goes through logf, which may
// differ from XLA's log by an ulp.
//
// The draw: key (k0, k1) = keys[r]; with `split` the row samples under
// split(key)[1] and writes split(key)[0] to key_next[r] (JAX's
// `key, sub = split(key)` of Engine.generate); element v takes the bits
// at counter base + v, base = r * V with `flat` (one (R, V) draw under one
// key, as jax.random.categorical over a batch) else 0 (one (V,) draw a
// row, as a vmap over the slots); a sampled row's bits also go to
// bits_out[r, v] when the caller passes it (a check's hook, null on the
// serving path); u = max(tiny, f + tiny) with
// f = bitcast(bits >> 9 | 0x3F800000) - 1 (JAX's uniform in [tiny, 1)),
// g = -log(-log(u)).
//
// What bounds it: latency. The bytes are R x V x 4 (2.4 MB at R = 4,
// V = 151936: ~0.7 us at 3.35 TB/s); each element costs a 20-round
// threefry hash and two logf, ~100 instructions. Design: a row is split
// over `parts` blocks of 256 threads (the caller picks parts so that the
// grid covers the SMs), each walking its span of V with a strided loop
// that keeps each thread's best (value, index), then a shuffle reduction
// and one across the warps into the block's partial. The last block of a
// row to finish (a counter a row, zeroed by the caller and bumped after a
// fence) reduces the row's partials by the same rule and writes the
// token, so the result does not depend on `parts` or on the blocks' order.

#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// does (a, ia) win over (b, ib)? NaN is the largest value; ties go to the
// lower index
__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  const bool na = isnan(a), nb = isnan(b);
  if (na || nb) return na && (!nb || ia < ib);
  return a > b || (a == b && ia < ib);
}

__device__ __forceinline__ void take(float& v, int& i, float ov, int oi) {
  if (better(ov, oi, v, i)) {
    v = ov;
    i = oi;
  }
}

// the block's best (value, index) into lane 0 of warp 0
__device__ __forceinline__ void block_best(float& best, int& bi, float* sv,
                                           int* si) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    take(best, bi, __shfl_down_sync(0xffffffffu, best, o),
         __shfl_down_sync(0xffffffffu, bi, o));
  if (lane == 0) {
    sv[warp] = best;
    si[warp] = bi;
  }
  __syncthreads();
  if (warp == 0) {
    best = lane < kWarps ? sv[lane] : -INFINITY;
    bi = lane < kWarps ? si[lane] : INT_MAX;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      take(best, bi, __shfl_down_sync(0xffffffffu, best, o),
           __shfl_down_sync(0xffffffffu, bi, o));
  }
}

__global__ void __launch_bounds__(kThreads)
    sample_kernel(const float* __restrict__ logits, long long stride,
                  const int* __restrict__ keys, const float* __restrict__ temps,
                  long long* __restrict__ out, int* __restrict__ key_next,
                  int* __restrict__ bits_out, float* part_v, int* part_i,
                  unsigned* done, int V, int parts, int flat, int split) {
  const int r = blockIdx.y, p = blockIdx.x, tid = threadIdx.x;
  uint32_t k0 = uint32_t(keys[2 * r]), k1 = uint32_t(keys[2 * r + 1]);
  if (split) {
    uint32_t n0 = k0, n1 = k1;
    threefry::fold_in(n0, n1, 0);
    if (p == 0 && tid == 0 && key_next != nullptr) {
      key_next[2 * r] = int(n0);
      key_next[2 * r + 1] = int(n1);
    }
    threefry::fold_in(k0, k1, 1);
  }
  const float T = temps[r];
  const bool sampled = T > 0.f;
  const float tm = fmaxf(T, 1e-6f);
  const uint64_t base = flat ? uint64_t(r) * uint64_t(V) : 0;
  const float* row = logits + size_t(r) * size_t(stride);
  const int span = (V + parts - 1) / parts;
  const int v0 = p * span, v1 = min(V, v0 + span);

  float best = -INFINITY;
  int bi = INT_MAX;
  for (int v = v0 + tid; v < v1; v += kThreads) {
    float x = row[v];
    if (sampled) {
      const uint32_t b = threefry::bits(k0, k1, base + uint64_t(v));
      if (bits_out != nullptr) bits_out[size_t(r) * V + v] = int(b);
      const float f = __uint_as_float((b >> 9) | 0x3F800000u) - 1.0f;
      const float u = fmaxf(FLT_MIN, f + FLT_MIN);
      const float g = -logf(-logf(u));
      x = x / tm + g;
    }
    take(best, bi, x, v);
  }
  __shared__ float sv[kWarps];
  __shared__ int si[kWarps];
  __shared__ bool last;
  block_best(best, bi, sv, si);
  if (tid == 0) {
    part_v[r * parts + p] = best;
    part_i[r * parts + p] = bi;
    __threadfence();
    last = atomicAdd(done + r, 1u) == unsigned(parts - 1);
  }
  __syncthreads();
  if (!last) return;
  // the row's last block: every partial is visible after the fence
  __threadfence();
  best = -INFINITY;
  bi = INT_MAX;
  const volatile float* pv = part_v + r * parts;
  const volatile int* pi = part_i + r * parts;
  for (int q = tid; q < parts; q += kThreads) take(best, bi, pv[q], pi[q]);
  __syncthreads();
  block_best(best, bi, sv, si);
  if (tid == 0) out[r] = bi;
}

}  // namespace

extern "C" int sample_launch(const void* logits, long long stride,
                             const void* keys, const void* temps, void* out,
                             void* key_next, void* bits_out, void* part_v,
                             void* part_i, void* done, int R, int V,
                             int parts, int flat, int split, void* stream) {
  if (R < 1 || V < 1 || stride < V || parts < 1 || parts > V ||
      R > 65535)
    return int(cudaErrorInvalidValue);
  sample_kernel<<<dim3(parts, R), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), stride,
      static_cast<const int*>(keys), static_cast<const float*>(temps),
      static_cast<long long*>(out), static_cast<int*>(key_next),
      static_cast<int*>(bits_out), static_cast<float*>(part_v),
      static_cast<int*>(part_i), static_cast<unsigned*>(done), V, parts,
      flat, split);
  return int(cudaGetLastError());
}

extern "C" const char* sample_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
