// Ring halo hop (kernel B2) and fused ring step (kernel B3) across ranks,
// for Hopper (sm_90a): the ring's shards split over processes, each rank
// holding n_local consecutive shards stacked on one card.
//
// Replaces p2pnetwork_tpu/ops/pallas_ring.py::_ring_halo_copy_kernel (B2)
// and ::_ring_halo_segsum_kernel (B3) where a hop crosses ranks. On the TPU
// a hop is an async remote copy from one chip's VMEM to the next chip's,
// with a send and a receive semaphore, S - 1 of them a ring pass. Across
// processes each such hop hands the card (or the link) from one rank's
// context to the next: on one H100 a hop took ~0.25 ms at 2 ranks and
// ~1.3 ms at 8 whatever its bytes (PERF.md, chip_smoke.py phase 4v). So a
// pass moves its blocks in one exchange instead:
//
//   - the gather (ring_gather_kernel): every block a rank reads in a pass
//     is known when the pass starts (local shard d reads global shard
//     (shard_lo + d - t) mod S at step t), so one put kernel writes the
//     rank's [n_local, ...] stack into its ring-order rows of every rank's
//     slab, its own included, through CUDA IPC mappings of the peers'
//     memory (the same store reaches a peer card over NVLink or a peer
//     process on the same card). Each block lands twice, at rows r and
//     r + S of a [2S, ...] slab, so every step's n_local rows are one
//     contiguous range;
//   - the pass kernel (ring_pass_segsum_*): B3's segment sums of every
//     step in one launch over the gathered slab, each output row owned by
//     one worker that loops over the steps (segsum.cuh's row workers).
//
// The semaphores become words in the receiver's memory (ops/ring.py,
// GatherChannel, allocates and maps them):
//   - two slabs, by pass parity, so a rank may run one pass ahead;
//   - arrival: the put kernel's last block to finish (a block-arrival
//     counter), after every block's stores and a system fence, adds 1 with
//     a system-scope release to each peer's pass counter; the receiver's
//     stream waits until its counter reaches (W - 1) * seq
//     (cuStreamWaitValue32: the GPU's front end polls the word, no kernel
//     spins, so ranks whose contexts time-slice one card still progress);
//   - reuse: the same last block then stores seq - 1 to its word in every
//     peer's acknowledgement row: the kernel runs after every read of the
//     previous pass's slab on this rank's stream. Before the put of pass
//     seq a rank's stream waits until every peer has acknowledged seq - 2,
//     the last pass that used the same slab. Acknowledging after the
//     arrival is what makes one summed counter enough: a sender two passes
//     ahead would need an acknowledgement that only follows every other
//     sender's arrival of the pass between.
// The per-hop form (ring_put_kernel and its land) stays for the payloads
// that change from hop to hop: a faulted hop, the re-mask's reverse fold.
// Its slots and flags (PeerChannel) are the same scheme a step at a time:
// the put's last block stores the step's sequence number to the next
// rank's flag, the receiver's stream waits for it, the land kernel copies
// the slot into its row (loads past L1: another context wrote it) and
// acknowledges the step, and a put waits for the acknowledgement of the
// step two back. Every wait is on the stream: a call returns at once, and
// its order against the ring's other launches is the stream's.
//
// What bounds them on an H100. The gather reads the rank's stack once and
// writes it 2W times (twice into each rank's slab): for the bool
// [4, 125008] stack at W = 2 2.5 MB, ~0.75 us at 3.35 TB/s; a hop's put
// and land move 1.25 MB. What a pass costs is its launches, its stream
// waits and, with ranks on one card, the contexts' time slices: one
// hand-over a pass where the hops took S - 1. The copies take 16-byte
// units where every buffer and the shard's bytes allow it (else 4 or 1),
// U of them a thread, the grid covering the payload.
//
// Plain C interface for ctypes; each entry returns 0 or a CUDA error code
// (a cudaError_t, or a CUresult from the stream waits).

#include <cuda.h>
#include <string.h>

#include "segsum.cuh"

namespace {

// A rank's receive area: a header of 32-bit words, then four slots
// (direction x parity) of slot_bytes each.
constexpr int kRecvFlag = 0;     // + dir: last step landed here by the sender
constexpr int kAckFlag = 32;     // + dir: last step the receiver took out
constexpr int kPutCount = 64;    // + dir: the put kernel's block arrivals
constexpr int kLandCount = 96;   // + dir: the land kernel's block arrivals
constexpr int64_t kHeaderBytes = 512;

uint32_t* word(void* area, int w) {
  return static_cast<uint32_t*>(area) + w;
}

unsigned char* slot(void* area, int dir, uint32_t seq, int64_t slot_bytes) {
  return static_cast<unsigned char*>(area) + kHeaderBytes +
         (2 * dir + static_cast<int>(seq & 1u)) * slot_bytes;
}

// Who publishes what when a launch's blocks have all arrived.
struct Signal {
  uint32_t* count;  // this rank's arrival counter for the kernel
  uint32_t* flag;   // the flag to store `seq` in (a peer's memory)
  uint32_t seq;
  uint32_t blocks;  // arrivals that complete the launch
};

__device__ __forceinline__ void store_release_sys(uint32_t* p, uint32_t v) {
  asm volatile("st.release.sys.global.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// Called by every thread of an arriving block after its stores: the last
// block of the launch resets the counter and publishes the step.
__device__ __forceinline__ void arrive(const Signal& s) {
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x == 0) {
    const uint32_t prior = atomicAdd(s.count, 1u);
    if (prior == s.blocks - 1) {
      atomicExch(s.count, 0u);
      __threadfence_system();
      store_release_sys(s.flag, s.seq);
    }
  }
}

// Tile `tile` of a put: units j = tile * kThreads * U + k * kThreads +
// threadIdx.x of the [n_local, per] stack. Shard d goes to d + 1 (forward)
// or d - 1 (reverse) of dst, the boundary shard to the peer's slot.
template <typename V, int U>
__device__ __forceinline__ void put_tile(const V* __restrict__ src,
                                         V* __restrict__ dst,
                                         V* __restrict__ peer, int64_t per,
                                         int n_local, int reverse,
                                         int64_t tile) {
  const int64_t total = per * n_local;
  const int64_t first = tile * (p2p::kThreads * U) + threadIdx.x;
  const int64_t edge = reverse ? 0 : n_local - 1;
  const int64_t step = reverse ? -per : per;
  V v[U];
#pragma unroll
  for (int k = 0; k < U; ++k) {
    const int64_t j = first + k * p2p::kThreads;
    if (j < total) v[k] = src[j];
  }
#pragma unroll
  for (int k = 0; k < U; ++k) {
    const int64_t j = first + k * p2p::kThreads;
    if (j < total) {
      const int64_t d = j / per;
      if (d == edge) {
        peer[j - d * per] = v[k];
      } else {
        dst[j + step] = v[k];
      }
    }
  }
}

template <typename V, int U>
__global__ void __launch_bounds__(p2p::kThreads)
    ring_put_kernel(const V* __restrict__ src, V* __restrict__ dst,
                    V* __restrict__ peer, int64_t per, int n_local,
                    int reverse, Signal sig) {
  put_tile<V, U>(src, dst, peer, per, n_local, reverse, blockIdx.x);
  arrive(sig);
}

// The land: this rank's slot into its landing row, read past L1.
template <typename V, int U>
__global__ void __launch_bounds__(p2p::kThreads)
    ring_land_kernel(const V* __restrict__ own, V* __restrict__ dst,
                     int64_t per, Signal sig) {
  const int64_t first =
      static_cast<int64_t>(blockIdx.x) * (p2p::kThreads * U) + threadIdx.x;
  V v[U];
#pragma unroll
  for (int k = 0; k < U; ++k) {
    const int64_t j = first + k * p2p::kThreads;
    if (j < per) v[k] = __ldcg(own + j);
  }
#pragma unroll
  for (int k = 0; k < U; ++k) {
    const int64_t j = first + k * p2p::kThreads;
    if (j < per) dst[j] = v[k];
  }
  arrive(sig);
}

// Widest copy unit (16, 4 or 1 bytes) that divides a shard's bytes and
// keeps every buffer aligned (the slots are 256-byte aligned).
int vec_bytes(const void* a, const void* b, int64_t shard_bytes) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(a) |
                         reinterpret_cast<uintptr_t>(b) |
                         static_cast<uintptr_t>(shard_bytes);
  if (bits % 16 == 0) return 16;
  if (bits % 4 == 0) return 4;
  return 1;
}

int64_t tiles(int64_t units, int per_thread) {
  const int64_t per_tile = static_cast<int64_t>(p2p::kThreads) * per_thread;
  return (units + per_tile - 1) / per_tile;
}

// The most units a thread (4, 2 or 1) that still leaves 4 blocks an SM.
int units_per_thread(int64_t units, int device, int* u) {
  int sms = 0;
  const cudaError_t err = p2p::sm_count(device, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t want = 4 * static_cast<int64_t>(sms);
  *u = tiles(units, 4) >= want ? 4 : tiles(units, 2) >= want ? 2 : 1;
  return 0;
}

int wait_value(cudaStream_t s, const uint32_t* flag, uint32_t value) {
  const CUresult r = cuStreamWaitValue32(
      reinterpret_cast<CUstream>(s),
      static_cast<CUdeviceptr>(reinterpret_cast<uintptr_t>(flag)), value,
      CU_STREAM_WAIT_VALUE_GEQ);
  return static_cast<int>(r);
}

template <typename V, int U>
int launch_put_land(const void* x, void* out, int n_local, int64_t per,
                    int reverse, void* peer_slot, const Signal& put,
                    const void* own_slot, const Signal& land, cudaStream_t s,
                    const uint32_t* recv_flag) {
  const auto src = static_cast<const V*>(x);
  const auto dst = static_cast<V*>(out);
  Signal p = put;
  p.blocks = static_cast<uint32_t>(tiles(per * n_local, U));
  ring_put_kernel<V, U><<<p.blocks, p2p::kThreads, 0, s>>>(
      src, dst, static_cast<V*>(peer_slot), per, n_local, reverse, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rc = wait_value(s, recv_flag, put.seq);
  if (rc != 0) return rc;
  Signal l = land;
  l.blocks = static_cast<uint32_t>(tiles(per, U));
  const int64_t landing = reverse ? n_local - 1 : 0;
  ring_land_kernel<V, U><<<l.blocks, p2p::kThreads, 0, s>>>(
      static_cast<const V*>(own_slot), dst + landing * per, per, l);
  return static_cast<int>(cudaGetLastError());
}

template <typename V>
int put_land(const void* x, void* out, int n_local, int64_t shard_bytes,
             int reverse, void* peer_slot, const Signal& put,
             const void* own_slot, const Signal& land, int device,
             cudaStream_t s, const uint32_t* recv_flag) {
  const int64_t per = shard_bytes / static_cast<int64_t>(sizeof(V));
  int u = 1;
  const int rc = units_per_thread(per * n_local, device, &u);
  if (rc != 0) return rc;
  switch (u) {
    case 4:
      return launch_put_land<V, 4>(x, out, n_local, per, reverse, peer_slot,
                                   put, own_slot, land, s, recv_flag);
    case 2:
      return launch_put_land<V, 2>(x, out, n_local, per, reverse, peer_slot,
                                   put, own_slot, land, s, recv_flag);
    default:
      return launch_put_land<V, 1>(x, out, n_local, per, reverse, peer_slot,
                                   put, own_slot, land, s, recv_flag);
  }
}

// ------------------------------------------------------------ ring gather
//
// B2 across ranks, a pass at a time: every block a rank reads in a ring
// pass is known when the pass starts (local shard d reads global shard
// (shard_lo + d - t) mod S at step t), so one exchange of the ranks'
// stacks replaces the S - 1 hops. Each rank's gather area holds a header
// and two slabs (by pass parity) of 2S rows of shard_bytes; row r holds
// global shard r mod S, so every step's n_local rows are one contiguous
// range.

// The gather area's header (32-bit words), then at kTableOffset the areas
// of every rank as mapped here, by ring position (this rank's own at its
// position), and at kGatherHeaderBytes the two slabs.
constexpr int kGatherArrive = 0;    // +1 from each sender a pass
constexpr int kGatherCount = 1;     // the put kernel's block arrivals
constexpr int kGatherAck = 32;      // + receiver position: last pass read
constexpr int kMaxWorld = 128;
constexpr int64_t kTableOffset = 1024;
constexpr int64_t kGatherHeaderBytes = 4096;
static_assert((kGatherAck + kMaxWorld) * 4 <= kTableOffset,
              "the acknowledgements fit before the table");
static_assert(kTableOffset + kMaxWorld * 8 <= kGatherHeaderBytes,
              "the table fits in the header");

struct Gather {
  const uint64_t* areas;  // [world] area bases, by ring position
  int64_t slab_offset;    // bytes from an area's base to this pass's slab
  int64_t per;            // units of a shard
  int n_local, n_shards, shard_lo, world, me;
  uint32_t seq;
  uint32_t* count;        // this rank's block arrivals
  uint32_t blocks;        // arrivals that complete the launch
};

__device__ __forceinline__ void add_release_sys(uint32_t* p, uint32_t v) {
  asm volatile("red.release.sys.global.add.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ uint32_t* area_word(uint64_t area, int w) {
  return reinterpret_cast<uint32_t*>(area) + w;
}

// Tile `blockIdx.x` of the put: units j of the [n_local, per] stack, each
// stored at rows shard_lo + d and shard_lo + d + S of every rank's slab.
// The launch's last block then adds 1 to every peer's pass counter and,
// after it, acknowledges pass seq - 1 to every peer: this kernel runs
// after every read of that pass's slab on this rank's stream.
template <typename V, int U>
__global__ void __launch_bounds__(p2p::kThreads)
    ring_gather_kernel(const V* __restrict__ src, Gather a) {
  const int64_t total = a.per * a.n_local;
  const int64_t first =
      static_cast<int64_t>(blockIdx.x) * (p2p::kThreads * U) + threadIdx.x;
  const int64_t wrap = static_cast<int64_t>(a.n_shards) * a.per;
  V v[U];
  int64_t at[U];
#pragma unroll
  for (int k = 0; k < U; ++k) {
    const int64_t j = first + k * p2p::kThreads;
    at[k] = -1;
    if (j < total) {
      v[k] = src[j];
      at[k] = static_cast<int64_t>(a.shard_lo) * a.per + j;
    }
  }
  for (int w = 0; w < a.world; ++w) {
    V* slab = reinterpret_cast<V*>(
        reinterpret_cast<unsigned char*>(a.areas[w]) + a.slab_offset);
#pragma unroll
    for (int k = 0; k < U; ++k) {
      if (at[k] >= 0) {
        slab[at[k]] = v[k];
        slab[at[k] + wrap] = v[k];
      }
    }
  }
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x == 0) {
    const uint32_t prior = atomicAdd(a.count, 1u);
    if (prior == a.blocks - 1) {
      atomicExch(a.count, 0u);
      __threadfence_system();
      for (int w = 0; w < a.world; ++w) {
        if (w != a.me) add_release_sys(area_word(a.areas[w], kGatherArrive), 1u);
      }
      for (int w = 0; w < a.world; ++w) {
        if (w != a.me) {
          store_release_sys(area_word(a.areas[w], kGatherAck + a.me),
                            a.seq - 1u);
        }
      }
    }
  }
}

template <typename V, int U>
int launch_gather(const void* x, const Gather& g, cudaStream_t s) {
  Gather a = g;
  a.blocks = static_cast<uint32_t>(tiles(a.per * a.n_local, U));
  ring_gather_kernel<V, U><<<a.blocks, p2p::kThreads, 0, s>>>(
      static_cast<const V*>(x), a);
  return static_cast<int>(cudaGetLastError());
}

template <typename V>
int gather_units(const void* x, Gather g, int64_t shard_bytes, int device,
                 cudaStream_t s) {
  g.per = shard_bytes / static_cast<int64_t>(sizeof(V));
  int u = 1;
  const int rc = units_per_thread(g.per * g.n_local, device, &u);
  if (rc != 0) return rc;
  switch (u) {
    case 4:
      return launch_gather<V, 4>(x, g, s);
    case 2:
      return launch_gather<V, 2>(x, g, s);
    default:
      return launch_gather<V, 1>(x, g, s);
  }
}

// ------------------------------------------------------------ pass kernel
//
// B3 across ranks, a pass at a time: out[d] = fold over t of B1's segment
// sum of bucket [d, t] (the rank's [n_local, S, NB, W] MXU buckets) over
// the block resident at step t, slab row (shard_lo + d - t) mod S. Each
// output row has one worker (a row group, or a warp on kExtent rows),
// which loops over the S steps into one shared-memory accumulator and
// stores once: no two blocks write one row, and the steps' padding costs
// only its extent.

struct Pass {
  int n_steps, shard_lo;
  int64_t step_stride;    // slots from a shard's step t bucket to t + 1
  int64_t extent_step;    // the same for the extents
};

__device__ __forceinline__ int64_t pass_signal(const Pass& ps, int d, int t) {
  const int s = (ps.shard_lo + d - t) % ps.n_steps;
  return s < 0 ? s + ps.n_steps : s;
}

// run_rows (segsum.cuh) with the row reduced once per ring step.
template <class Op, p2p::Path P>
__device__ void pass_rows(const typename Op::T* __restrict__ slab,
                          const int32_t* __restrict__ src,
                          const int32_t* __restrict__ dst,
                          const uint8_t* __restrict__ mask,
                          typename Op::T* __restrict__ out,
                          const p2p::Rows& g, const Pass& ps, int worker,
                          int n_workers, unsigned char* smem) {
  using T = typename Op::T;
  const int threads = 1 << g.group_log2;
  const int groups = p2p::kThreads >> g.group_log2;
  const int group = threadIdx.x >> g.group_log2;
  const int lane = threadIdx.x & (threads - 1);
  unsigned char* mine = smem + group * g.n_acc * g.acc_bytes;
  __shared__ unsigned long long poison_words[p2p::kPoisonWords];
  p2p::zero_shared(smem, groups * g.n_acc * g.acc_bytes);
  if (threadIdx.x < p2p::kPoisonWords) poison_words[threadIdx.x] = 0ull;
  __syncthreads();
  const int n_chunks = (g.width + 3) / 4;
  int local = 0;
  for (int row = worker * groups + group; row < g.n_rows;
       row += n_workers * groups, ++local) {
    const int buf = local & (g.n_acc - 1);
    T* acc = reinterpret_cast<T*>(mine + buf * g.acc_bytes);
    // One word for the row over every step: a non-finite term at any
    // step spreads over the row as it does in that step's sum.
    const p2p::Poison poison{&poison_words[group * g.n_acc + buf],
                             static_cast<unsigned>(row) + 1u};
    const int d = row / g.rows_per_shard;
    const int r = row - d * g.rows_per_shard;
    for (int t = 0; t < ps.n_steps; ++t) {
      const int64_t at = d * g.bucket_stride + t * ps.step_stride +
                         static_cast<int64_t>(r) * g.width;
      p2p::reduce_row<Op, P>(slab + pass_signal(ps, d, t) * g.signal_stride,
                             src + at, dst + at, mask + at, g.width,
                             n_chunks, lane, threads, acc, poison);
    }
    p2p::group_sync(group, threads);
    p2p::write_back<T>(acc, out + static_cast<int64_t>(row) * g.block, g,
                       lane, threads, poison);
    if (g.n_acc == 1) p2p::group_sync(group, threads);
  }
}

// run_rows_extent (segsum.cuh) with the row reduced once per ring step,
// each step up to its own extent.
template <class Op>
__device__ void pass_rows_extent(const typename Op::T* __restrict__ slab,
                                 const int32_t* __restrict__ src,
                                 const int32_t* __restrict__ dst,
                                 const uint8_t* __restrict__ mask,
                                 const int32_t* __restrict__ extent,
                                 typename Op::T* __restrict__ out,
                                 const p2p::Rows& g, const Pass& ps,
                                 int worker, int n_workers,
                                 unsigned char* smem) {
  using T = typename Op::T;
  constexpr int B = p2p::extent_batch<Op>();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  T* acc = reinterpret_cast<T*>(smem + warp * g.acc_bytes);
  __shared__ unsigned long long poison_words[p2p::kWarpRows];
  p2p::zero_shared(smem, p2p::kWarpRows * g.acc_bytes);
  if (threadIdx.x < p2p::kWarpRows) poison_words[threadIdx.x] = 0ull;
  __syncthreads();
  const int width_chunks = g.width / 4;
  for (int row = worker * p2p::kWarpRows + warp; row < g.n_rows;
       row += n_workers * p2p::kWarpRows) {
    const int d = row / g.rows_per_shard;
    const int r = row - d * g.rows_per_shard;
    const p2p::Poison poison{&poison_words[warp],
                             static_cast<unsigned>(row) + 1u};
    for (int step = 0; step < ps.n_steps; ++step) {
      const int64_t at = d * g.bucket_stride + step * ps.step_stride +
                         static_cast<int64_t>(r) * g.width;
      const T* sig = slab + pass_signal(ps, d, step) * g.signal_stride;
      const int32_t* s = src + at;
      const int32_t* t = dst + at;
      const uint8_t* m = mask + at;
      p2p::Batch<1> first;
      p2p::load_batch<p2p::kVector, 1>(first, s, t, m, g.width, width_chunks,
                                       lane, 32);
      const int ext = min(
          max(__ldg(extent + d * g.extent_stride + step * ps.extent_step + r),
              0),
          g.width);
      const int n_chunks = (ext + 3) / 4;
      if (lane >= n_chunks) {
        first.c[0].n = 0;
        first.c[0].mask = 0u;
      }
      float screen = 0.0f;
      {
        T v[1][4];
        p2p::gather_batch<Op, 1>(sig, first, v);
        p2p::update_batch<Op, 1>(first, v, acc, lane);
        if constexpr (!Op::kOr) screen = p2p::screen_of<1>(v);
      }
      for (int base = 32; base < n_chunks; base += 32 * B) {
        p2p::Batch<B> b;
        p2p::load_batch<p2p::kVector, B>(b, s, t, m, g.width, n_chunks,
                                         base + lane, 32);
        T v[B][4];
        p2p::gather_batch<Op, B>(sig, b, v);
        p2p::update_batch<Op, B>(b, v, acc, lane);
        if constexpr (!Op::kOr) screen += p2p::screen_of<B>(v);
      }
      if constexpr (!Op::kOr) {
        if (p2p::nonfinite(screen)) {
          p2p::note_terms<p2p::kVector>(sig, s, t, m, g.width, n_chunks,
                                        lane, 32, poison);
        }
        // The step's padding past its extent: sig[0] * 0 once, as in
        // run_rows_extent.
        if (lane == 0 && ext < g.width) {
          const float p = __ldg(sig) * 0.0f;
          if (p != 0.0f) atomicAdd(&acc[0], p);
          if (p2p::nonfinite(p)) p2p::note_nonfinite(poison.word, poison.tag, 0);
        }
      }
    }
    __syncwarp();
    p2p::write_back<T>(acc, out + static_cast<int64_t>(row) * g.block, g,
                       lane, 32, poison);
    __syncwarp();
  }
}

template <class Op, p2p::Path P>
__global__ void __launch_bounds__(p2p::kThreads, p2p::kMinBlocks)
    ring_pass_segsum_kernel(const typename Op::T* __restrict__ slab,
                            const int32_t* __restrict__ src,
                            const int32_t* __restrict__ dst,
                            const uint8_t* __restrict__ mask,
                            const int32_t* __restrict__ extent,
                            typename Op::T* __restrict__ out, p2p::Rows g,
                            Pass ps) {
  extern __shared__ __align__(16) unsigned char smem[];
  pass_rows<Op, P>(slab, src, dst, mask, out, g, ps, blockIdx.x, gridDim.x,
                   smem);
}

template <class Op>
__global__ void __launch_bounds__(p2p::kThreads, p2p::kExtentMinBlocks)
    ring_pass_segsum_runs_kernel(const typename Op::T* __restrict__ slab,
                                 const int32_t* __restrict__ src,
                                 const int32_t* __restrict__ dst,
                                 const uint8_t* __restrict__ mask,
                                 const int32_t* __restrict__ extent,
                                 typename Op::T* __restrict__ out,
                                 p2p::Rows g, Pass ps) {
  extern __shared__ __align__(16) unsigned char smem[];
  pass_rows_extent<Op>(slab, src, dst, mask, extent, out, g, ps, blockIdx.x,
                       gridDim.x, smem);
}

template <class Op, p2p::Path P>
constexpr auto pass_kernel_of() {
  if constexpr (P == p2p::kExtent) {
    return ring_pass_segsum_runs_kernel<Op>;
  } else {
    return ring_pass_segsum_kernel<Op, P>;
  }
}

template <class Op, p2p::Path P>
int launch_pass(const void* slab, const void* src, const void* dst,
                const void* mask, const void* extent, void* out,
                const p2p::Rows& g, const Pass& ps, size_t smem, int device,
                cudaStream_t stream) {
  using T = typename Op::T;
  const auto kernel = pass_kernel_of<Op, P>();
  static p2p::Residency residency;  // one per kernel instantiation
  int resident = 0;
  const cudaError_t err = residency.blocks(
      reinterpret_cast<const void*>(kernel), smem, device, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<p2p::row_workers(g, resident), p2p::kThreads, smem, stream>>>(
      static_cast<const T*>(slab), static_cast<const int32_t*>(src),
      static_cast<const int32_t*>(dst), static_cast<const uint8_t*>(mask),
      static_cast<const int32_t*>(extent), static_cast<T*>(out), g, ps);
  return static_cast<int>(cudaGetLastError());
}

// The pass kernel's path and launch: kExtent where extents are given and
// the geometry allows it, else B1's path for the buckets' geometry.
template <class Op>
int ring_pass_segsum(const void* slab, int64_t signal_stride,
                     const void* src, const void* dst, const void* mask,
                     const void* extent, int64_t extent_stride,
                     int64_t extent_step, void* out, int n_local,
                     int n_steps, int shard_lo, int rows_per_shard,
                     int width, int block, int64_t bucket_stride,
                     int64_t step_stride, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int elem = sizeof(typename Op::T);
  // Both strides must keep kVector's 4-slot alignment.
  const int64_t stride_check =
      bucket_stride % 4 == 0 && step_stride % 4 == 0 ? bucket_stride : 1;
  const p2p::Path path =
      extent != nullptr && p2p::choose_extent(src, dst, mask, width,
                                              stride_check, block, elem)
          ? p2p::kExtent
          : p2p::choose_path(Op::kOr, src, dst, mask, width, stride_check);
  size_t smem = 0;
  p2p::Rows g = p2p::plan_rows(path, elem, n_local, rows_per_shard, width,
                               block, bucket_stride, signal_stride, out,
                               &smem);
  g.extent_stride = extent_stride;
  const Pass ps{n_steps, shard_lo, step_stride, extent_step};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto p) {
    return launch_pass<Op, decltype(p)::value>(slab, src, dst, mask, extent,
                                               out, g, ps, smem, device, s);
  };
  return path == p2p::kExtent
             ? launch(std::integral_constant<p2p::Path, p2p::kExtent>())
             : p2p::dispatch<Op>(path, launch);
}

int alloc_area(int64_t bytes, int device, void** area, char* handle) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMalloc(area, static_cast<size_t>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemset(*area, 0, static_cast<size_t>(bytes));
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  cudaIpcMemHandle_t h;
  if (err == cudaSuccess) err = cudaIpcGetMemHandle(&h, *area);
  if (err != cudaSuccess) {
    cudaFree(*area);
    return static_cast<int>(err);
  }
  static_assert(sizeof(h) == 64, "an IPC handle is 64 bytes");
  memcpy(handle, &h, sizeof(h));
  return 0;
}
}  // namespace

extern "C" {

// This rank's receive area, zeroed, and its IPC handle (64 bytes).
int p2p_peer_alloc(int64_t slot_bytes, int device, void** area,
                   char* handle) {
  return alloc_area(kHeaderBytes + 4 * slot_bytes, device, area, handle);
}

// A peer's area, mapped into this process.
int p2p_peer_open(const char* handle, int device, void** ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return static_cast<int>(
      cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess));
}

int p2p_peer_close(void* ptr, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaIpcCloseMemHandle(ptr));
}

int p2p_peer_free(void* area, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaFree(area));
}

// B2 across ranks: one hop of this rank's [n_local, shard_bytes] stack x
// into out; `down` is the mapped area of the rank this one sends to, `up`
// of the rank it receives from (the same rank in a ring of two).
int p2p_ring_put(const void* x, void* out, int n_local, int64_t shard_bytes,
                 int reverse, uint32_t seq, void* own, void* down, void* up,
                 int64_t slot_bytes, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dir = reverse ? 1 : 0;
  if (seq > 2) {
    const int rc = wait_value(s, word(own, kAckFlag + dir), seq - 2);
    if (rc != 0) return rc;
  }
  const Signal put{word(own, kPutCount + dir), word(down, kRecvFlag + dir),
                   seq, 0};
  const Signal land{word(own, kLandCount + dir), word(up, kAckFlag + dir),
                    seq, 0};
  void* peer_slot = slot(down, dir, seq, slot_bytes);
  const void* own_slot = slot(own, dir, seq, slot_bytes);
  const uint32_t* recv = word(own, kRecvFlag + dir);
  switch (vec_bytes(x, out, shard_bytes)) {
    case 16:
      return put_land<uint4>(x, out, n_local, shard_bytes, reverse,
                             peer_slot, put, own_slot, land, device, s, recv);
    case 4:
      return put_land<uint32_t>(x, out, n_local, shard_bytes, reverse,
                                peer_slot, put, own_slot, land, device, s,
                                recv);
    default:
      return put_land<uint8_t>(x, out, n_local, shard_bytes, reverse,
                               peer_slot, put, own_slot, land, device, s,
                               recv);
  }
}

// This rank's gather area (the header and two slabs of slab_bytes),
// zeroed, and its IPC handle (64 bytes).
int p2p_gather_alloc(int64_t slab_bytes, int device, void** area,
                     char* handle) {
  return alloc_area(kGatherHeaderBytes + 2 * slab_bytes, device, area,
                    handle);
}

// The ranks' gather areas as mapped here, by ring position, into this
// rank's header (the put kernel reads them there).
int p2p_gather_table(void* own, const uint64_t* areas, int world,
                     int device) {
  if (world < 1 || world > kMaxWorld) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemcpy(static_cast<unsigned char*>(own) + kTableOffset, areas,
                   world * sizeof(uint64_t), cudaMemcpyHostToDevice);
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  return static_cast<int>(err);
}

// B2 across ranks, a pass at a time: this rank's [n_local, shard_bytes]
// stack x into rows shard_lo + d and shard_lo + d + S of every rank's slab
// of pass seq (parity seq & 1), then this rank's stream waits until every
// peer's stack has landed in its own slab. Before the put, the stream
// waits until every peer has acknowledged pass seq - 2, the last that
// used the same slab.
int p2p_ring_gather(const void* x, int n_local, int64_t shard_bytes,
                    int n_shards, int shard_lo, uint32_t seq, void* own,
                    int world, int me, int64_t slab_bytes, int device,
                    void* stream) {
  if (world < 1 || world > kMaxWorld || me < 0 || me >= world) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (seq > 2) {
    for (int w = 0; w < world; ++w) {
      if (w == me) continue;
      const int rc = wait_value(s, word(own, kGatherAck + w), seq - 2);
      if (rc != 0) return rc;
    }
  }
  Gather g{};
  g.areas = reinterpret_cast<const uint64_t*>(
      static_cast<unsigned char*>(own) + kTableOffset);
  g.slab_offset = kGatherHeaderBytes + static_cast<int64_t>(seq & 1u) *
                                           slab_bytes;
  g.n_local = n_local;
  g.n_shards = n_shards;
  g.shard_lo = shard_lo;
  g.world = world;
  g.me = me;
  g.seq = seq;
  g.count = word(own, kGatherCount);
  const void* slab = static_cast<unsigned char*>(own) + g.slab_offset;
  int rc;
  switch (vec_bytes(x, slab, shard_bytes)) {
    case 16:
      rc = gather_units<uint4>(x, g, shard_bytes, device, s);
      break;
    case 4:
      rc = gather_units<uint32_t>(x, g, shard_bytes, device, s);
      break;
    default:
      rc = gather_units<uint8_t>(x, g, shard_bytes, device, s);
  }
  if (rc != 0 || world == 1) return rc;
  return wait_value(s, word(own, kGatherArrive),
                    static_cast<uint32_t>(world - 1) * seq);
}

int p2p_ring_pass_segsum_or(const void* slab, int64_t signal_stride,
                            const void* src, const void* dst,
                            const void* mask, const void* extent,
                            int64_t extent_stride, int64_t extent_step,
                            void* out, int n_local, int n_steps,
                            int shard_lo, int rows_per_shard, int width,
                            int block, int64_t bucket_stride,
                            int64_t step_stride, int device, void* stream) {
  return ring_pass_segsum<p2p::OrOp>(
      slab, signal_stride, src, dst, mask, extent, extent_stride,
      extent_step, out, n_local, n_steps, shard_lo, rows_per_shard, width,
      block, bucket_stride, step_stride, device, stream);
}

int p2p_ring_pass_segsum_sum(const void* slab, int64_t signal_stride,
                             const void* src, const void* dst,
                             const void* mask, const void* extent,
                             int64_t extent_stride, int64_t extent_step,
                             void* out, int n_local, int n_steps,
                             int shard_lo, int rows_per_shard, int width,
                             int block, int64_t bucket_stride,
                             int64_t step_stride, int device, void* stream) {
  return ring_pass_segsum<p2p::SumOp>(
      slab, signal_stride, src, dst, mask, extent, extent_stride,
      extent_step, out, n_local, n_steps, shard_lo, rows_per_shard, width,
      block, bucket_stride, step_stride, device, stream);
}
}  // extern "C"
