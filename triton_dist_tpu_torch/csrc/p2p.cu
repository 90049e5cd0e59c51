// Point-to-point transfers over the virtual world of one card, sm_90a:
// the pipeline-parallel transport.
//
// p2p_kernel replaces the Pallas TPU kernel `_p2p_kernel` (reached through
// `p2p_send`, triton_dist_tpu/kernels/p2p.py:96; `p2p_read` is the same
// launch in reverse). Rank-stacked x (n, bytes): rank src's x lands in
// rank dst's output, every other rank passes its own x through. Block b
// of each rank owns the b-th 16-byte-aligned share of the bytes. Every
// rank except dst copies its share of x[me] into out[me]; src reads its
// share of x[src] once and stores it both into out[src] and into
// out[dst], then publishes it (the fence-once rule of shmem.cuh): one
// block barrier, thread 0's fence.acq_rel.gpu and a relaxed add of one
// to delivery word b of dst. Block b of dst, and no other block, waits
// until word b reads exactly 1, polling with a 64 ns backoff cap, and
// clears it. Dst never writes its own output: on the TPU that local copy
// would race the incoming put (p2p.py:55-58), and so would two blocks'
// stores here. When src == dst, every rank copies and no flag moves.
//
// Persistent delivery words. The pool (the wrapper's p2p._POOLS, zeroed
// once when made) holds `words` int32 a rank, one a block index; the
// grid never exceeds it. Each word gets one add (from src's block b) and
// has one waiter (dst's block b), which resets it after its wait, so
// every launch finds the pool at zero and leaves it so; a warm call
// makes no pool and no memset.
//
// No entry barrier. The JAX kernel barriers because on a TPU the put
// must not land while dst is still in a previous kernel that uses these
// semaphores (p2p.py:43-45). Here all n ranks run in one cooperative
// launch on one stream: the previous launch has ended on every rank
// before this one starts, its words are back at zero, and every call
// writes an `out` it allocated itself, so nothing a peer still reads can
// be overwritten. (The all-to-all has no barrier on the same argument;
// one here would have every block add to n - 1 peers' counter, 384 adds
// on each of 4 words at the PP handoff, before any byte moves.)
// `straggle_rank` stalls that rank's blocks for `straggle_ns` before
// their sends (or dst's before its waits; shmem::straggler_delay), so
// the peers really wait; the bytes are the same.
//
// Two bodies move the same bytes. Register (p2p_kernel<false>): 512
// threads, each with 8 16-byte loads of x in flight before their stores
// (ld.global.nc: nothing writes x during the launch), bytes where the
// payload or a pointer is not 16-byte aligned (shmem::copy_nc). Bulk
// (<true>): thread 0 streams the block's share through 4 shared-memory
// stages of 16 KiB, cp.async.bulk global -> shared on an mbarrier, then
// shared -> global to each end in a bulk group, and waits for every
// group and fences the async proxy before its publication (hopper.cuh
// bulk_stream, the all-to-all's bulk body too). The wrapper takes the bulk body wherever the
// bytes and pointers are 16-byte aligned (p2p._body_for): on an H100 it
// was 23% faster at the PP handoff's 4 MiB a rank (8.7 against 11.3
// us), 21% at 16 bytes and 1-10% at 4 KiB to 1 MiB (tools/
// profile_p2p_ll.py, PERF.md); the register body moves ragged payloads.
//
// ring_shift_kernel replaces `ring_shift`'s inner `kernel` (p2p.py:130,
// launched :139): every rank puts x[me] into out[(me + shift) mod n],
// the PP stage handoff, and waits for the one arrival into its own
// output. The destination is ((me + shift) % n + n) % n: C's % keeps the
// sign of a negative shift. The prologue is the JAX one: neighbor_barrier
// when |shift| == 1, else barrier_all. A shift of 0 mod n copies to self.
// It still publishes by the release rule (put_slot), over kWords flags a rank
// zeroed on the stream before every launch: [0] the barrier, [1] the
// delivery count; `straggle_rank` stalls that rank after the barrier.
//
// Data movement only: the results are bitwise the plain versions'
// whatever the dtype.
//
// What bounds them on an H100: bytes. p2p reads n - 1 buffers and writes
// n (2 n - 1 at the bound), ring_shift reads and writes n; the PP
// handoff of a (512, 4096) bf16 microbatch a stage at world 4 is 4 MiB
// a rank: p2p 8.8 us, ring_shift 10 us at 3.35 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "shmem.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWords = 2;  // ring_shift's flags a rank: barrier, delivery
constexpr int kBulkThreads = 128;  // bulk body: thread 0 streams

struct P2P {
  const char* x;
  char* out;
  int* flags;  // (n, words): dst's delivery word a block
  int words, src, dst, straggle_rank;
  long long bytes, straggle_ns;
};

template <bool kBulk>
__global__ void __launch_bounds__(kBulk ? kBulkThreads : kThreads,
                                  kBulk ? 1 : 2)
p2p_kernel(P2P a) {
  const int me = blockIdx.y;
  shmem::straggler_delay(a.straggle_rank, me, a.straggle_ns);
  if (me == a.dst && a.src != a.dst) {
    if (threadIdx.x == 0) {
      int* word = a.flags + size_t(me) * a.words + blockIdx.x;
      shmem::spin_until(word, shmem::kEq, 1, "p2p_send", me, blockIdx.x,
                        shmem::kPollNs);
      shmem::st_relaxed(word, 0);
    }
    return;
  }
  long long lo, hi;
  shmem::block_share(a.bytes, gridDim.x, blockIdx.x, &lo, &hi);
  const char* from = a.x + size_t(me) * a.bytes + lo;
  char* own = a.out + size_t(me) * a.bytes + lo;
  const bool put = me == a.src && a.src != a.dst;
  char* remote = put ? a.out + size_t(a.dst) * a.bytes + lo : nullptr;
  if constexpr (kBulk) {
    extern __shared__ __align__(128) unsigned char smem[];
    __shared__ __align__(8) uint64_t bar[hopper::kBulkStages];
    if (threadIdx.x != 0) return;
    const uint32_t bars = hopper::smem_addr(bar);
    for (int s = 0; s < hopper::kBulkStages; ++s)
      hopper::mbar_init(bars + 8 * s, 1);
    hopper::mbar_init_fence();
    const long long bytes = hi - lo;
    uint32_t phase = 0;
    hopper::bulk_stream(
        int((bytes + hopper::kBulkStageBytes - 1) / hopper::kBulkStageBytes),
        [&](int j, const void** src, void** d0, void** d1) {
          const long long off = (long long)j * hopper::kBulkStageBytes;
          *src = from + off;
          *d0 = own + off;
          *d1 = remote ? remote + off : nullptr;
          return uint32_t(min((long long)hopper::kBulkStageBytes,
                              bytes - off));
        },
        hopper::smem_addr(smem), bars, &phase);
  } else {
    shmem::copy_nc<kThreads, 8>(own, remote, from, hi - lo);
    __syncthreads();
    if (threadIdx.x != 0) return;
  }
  if (!put) return;
  shmem::fence_acq_rel();
  shmem::red_add_relaxed(a.flags + size_t(a.dst) * a.words + blockIdx.x, 1);
}

__global__ void __launch_bounds__(kThreads)
ring_shift_kernel(const char* __restrict__ x, char* out, int* flags,
                  long long bytes, int shift, int straggle_rank,
                  long long straggle_ns) {
  const int n = gridDim.y, me = blockIdx.y;
  if (shift == 1 || shift == -1)
    shmem::neighbor_barrier(flags, kWords, 0, me, n, "ring_shift");
  else
    shmem::barrier_all(flags, kWords, 0, me, n, "ring_shift");
  shmem::straggler_delay(straggle_rank, me, straggle_ns);
  const int to = ((me + shift) % n + n) % n;
  long long lo, hi;
  shmem::block_share(bytes, gridDim.x, blockIdx.x, &lo, &hi);
  shmem::put_slot(out + size_t(to) * bytes + lo, x + size_t(me) * bytes + lo,
                  hi - lo, flags + size_t(to) * kWords + 1, 1, true);
  shmem::signal_wait_until(flags + size_t(me) * kWords + 1, shmem::kGe,
                           int(gridDim.x), "ring_shift", me, 1);
}

}  // namespace

// int32 flag words a rank of a ring_shift launch
extern "C" int p2p_flag_words() { return kWords; }

// x, out (n, bytes); flags (n, words) int32 at zero, left at zero; 0 <=
// src, dst < n; straggle_rank < 0 for none; blocks a rank, 1..words,
// capped by what the card holds (info receives the grid, shmem.cuh
// launch_world); bulk = 1 takes the bulk body (bytes and both pointers
// 16-byte aligned). Returns a cudaError_t (0 = launched); n < 2 returns
// before any CUDA call.
extern "C" int p2p_launch(const void* x, void* out, void* flags, int words,
                          int n, long long bytes, int src, int dst,
                          int straggle_rank, long long straggle_ns,
                          int blocks, int bulk, int* info, void* stream) {
  if (n < 2 || bytes < 1 || src < 0 || src >= n || dst < 0 || dst >= n ||
      blocks < 1 || blocks > words)
    return int(cudaErrorInvalidValue);
  if (bulk && ((bytes | reinterpret_cast<uintptr_t>(x) |
                reinterpret_cast<uintptr_t>(out)) & 15))
    return int(cudaErrorMisalignedAddress);
  P2P a{static_cast<const char*>(x), static_cast<char*>(out),
        static_cast<int*>(flags), words, src, dst, straggle_rank, bytes,
        straggle_ns};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bulk)
    return int(shmem::launch_world(
        p2p_kernel<true>, n, blocks, kBulkThreads,
        size_t(hopper::kBulkStages) * hopper::kBulkStageBytes, st, info, a));
  return int(shmem::launch_world(p2p_kernel<false>, n, blocks, kThreads, 0,
                                 st, info, a));
}

// x, out (n, bytes); flags (n, p2p_flag_words()) zeroed; any shift.
extern "C" int ring_shift_launch(const void* x, void* out, void* flags, int n,
                                 long long bytes, int shift,
                                 int straggle_rank, long long straggle_ns,
                                 int want_blocks, void* info, void* stream) {
  if (n < 2 || bytes < 1 || want_blocks < 1) return int(cudaErrorInvalidValue);
  return int(shmem::launch_world(
      ring_shift_kernel, n, want_blocks, kThreads, 0,
      static_cast<cudaStream_t>(stream), static_cast<int*>(info),
      static_cast<const char*>(x), static_cast<char*>(out),
      static_cast<int*>(flags), bytes, shift, straggle_rank, straggle_ns));
}

extern "C" const char* p2p_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
