// The row engine of the blocked segment sum, shared by B1 (segsum.cu) and
// the fused ring step B3 (ring.cu). It replaces the row reduction of
// p2pnetwork_tpu/ops/pallas_edge.py::_segsum_kernel.
//
// A launch reduces n_rows = n_shards * rows_per_shard rows. Row `row`
// belongs to shard d = row / rows_per_shard; its W slots start at
// d * bucket_stride + (row % rows_per_shard) * width, so a bucket that is a
// strided slice of a larger array (the ring's [S, S, NB, W] layout, step t
// taken as [:, t]) is read in place; it reads the signal of its own shard,
// signal + d * signal_stride. One shard with signal_stride 0 is the plain
// single-device layout. Row `row` writes out[row * block, +block).
//
// What bounds it on an H100. A slot is 9 bytes of src/local_dst/mask, read
// once (27.5 us of DRAM bytes on the blocked layout [7813, 1408]), and one
// gather of signal[src]. With sources spread over the whole signal, as in
// chip_smoke.py's random layouts, every gather is a 32-byte L2 sector
// request of its own, and the ~10-11M gathers of the blocked layout take
// longer than its bytes: L2 request throughput is what bounds the wide
// dense rows, not DRAM latency. The sum also adds with f32 atomics in
// shared memory, which this card runs as a compare-and-swap loop
// (ATOMS.CAST.SPIN in the SASS), contended at block = 128.
//
// What the first design lost. One 256-thread block per row with each
// thread walking its slots through a chain of scalar loads (mask, then
// src, then signal[src], then dst) was taken to be bound by DRAM latency.
// The variants timed on the card (PERF.md) say otherwise: a persistent
// grid staging each row's bytes into shared memory two rows ahead by 1-D
// bulk copies (TMA, cp.async.bulk + mbarrier) was 11-32% slower on every
// dense layout than loads in registers, and was removed. Its ~38 KB of
// stages per block shrink the L1 that catches part of the gathers, and
// its latency hiding buys nothing where the L2 sets the pace. Pipelining
// each thread's next chunk across the row boundary, more blocks per SM,
// or per-warp copies of the accumulator moved no row by more than the
// noise between calls. What helped: vector
// loads off the dependency chain; one chunk per thread at a time on dense
// rows (fewer registers, so more threads and more gathers in flight: the
// sum needed it); loads of wide sparse rows only where a slot is live; and
// several rows per block for narrow rows.
//
// The engine. The grid is persistent (the blocks that fit on the card at
// once, from the occupancy of the kernel): each row group of a block
// walks rows row = first, first + step, ... A thread owns chunks of 4
// consecutive slots and holds batch_of(path) chunks at once: it issues all
// their src/local_dst/mask loads, then the independent signal gathers of
// their slots, then the shared-memory updates. Each row reduces into an
// accumulator of `block` elements in shared memory (flag bytes for OR, f32
// for the sum), written out with 16-byte stores and zeroed in the same
// pass; two accumulators per row group let that write-back run beside the
// next row's scatter, behind one barrier per row (one accumulator, and a
// second barrier, where two do not fit). A row group is the smallest
// number of warps (1 to 8) in which no thread takes more than two chunks
// of a row (batch 1) or one batch of four (batch 4), or the whole block
// where the row is wider than that.
//
// Paths, chosen per launch from the geometry (choose_path):
//
//   kVector  W and the shard stride multiples of 4 slots, src/local_dst
//            16-byte and mask 4-byte aligned (any width for the sum,
//            W <= 2048 for OR): the main path's dense layouts (blocked
//            [7813, 1408]: a row per block; remainder [1954, 640]: two),
//            the ring hybrid's narrow rows ([8, 245, 128]: a warp per row,
//            8 rows per block) and the sum over the ring mxu buckets
//            ([8, 245, 4864]: a row per block). src and local_dst load as
//            one int4 each, mask as one uchar4, all unconditional; one
//            chunk per thread at a time, which keeps registers low and more
//            threads in flight (four at a time was slower for the sum).
//   kSparse  OR over aligned rows wider than 2048 slots: the mxu buckets,
//            padded to the widest bucket and 13% live at 1M nodes. The
//            masks of a thread's four chunks load first, then src/local_dst
//            only for chunks with a live slot (padding is each row's tail,
//            so whole chunks skip); OR needs no signal behind a masked slot.
//   kScalar  any other geometry (widths or strides not multiples of 4,
//            rows not aligned): kVector's structure with one element per
//            load, still all issued before use.
//
// The sum keeps the reference's NaN rule: a masked slot still multiplies
// its signal (signal * mask), so its src is read and its signal gathered
// on every path. OR writes flags (idempotent, bit-exact); the sum's
// atomics add in an order that varies from run to run (exact on integer
// values below 2^24).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace p2p {

constexpr int kThreads = 256;
// OR over rows wider than this (the ring mxu buckets: padded, sparse)
// loads src/local_dst only where a slot is live.
constexpr int kWideWidth = 2048;
// Shared memory a block's accumulators may take (two buffers per row group
// when they fit): the most dynamic shared memory any launch asks for.
constexpr int kAccBudget = 64 * 1024;

enum Path : int { kVector, kSparse, kScalar };

// Chunks a thread holds at once on a path.
__host__ __device__ constexpr int batch_of(Path p) {
  return p == kSparse ? 4 : 1;
}
// Blocks per SM the kernels are built to keep resident.
constexpr int kMinBlocks = 4;

struct Rows {
  int n_rows, n_shards, rows_per_shard, width, block;
  int64_t bucket_stride, signal_stride;
  int group_log2;  // register paths: rows go to groups of 1 << group_log2
  int acc_bytes;   // one accumulator, rounded up to 16 bytes
  int n_acc;       // accumulators per row group: 1 or 2
  int out_vec;     // write rows back with 16-byte stores
};

struct OrOp {
  using T = uint8_t;  // signal, accumulator (a flag byte) and out element
  static constexpr bool kOr = true;
};

struct SumOp {
  using T = float;
  static constexpr bool kOr = false;
};

struct RowRef {
  int64_t slots;   // offset of the row's first slot in src/dst/mask
  int64_t signal;  // offset of the row's shard in the signal
};

__device__ __forceinline__ RowRef row_ref(int row, const Rows& g) {
  const int d = row / g.rows_per_shard;
  const int r = row - d * g.rows_per_shard;
  return {d * g.bucket_stride + static_cast<int64_t>(r) * g.width,
          d * g.signal_stride};
}

// Four consecutive slots; `n` of them lie inside the row.
struct Chunk {
  int4 src, dst;
  uint32_t mask;  // one byte per slot
  int n;
};

__device__ __forceinline__ int lane_of(const int4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

__device__ __forceinline__ bool live(uint32_t mask, int j) {
  return (mask >> (8 * j)) & 0xffu;
}

// Loads chunk i of a row whose slots start at src/dst/mask.
template <Path P>
__device__ __forceinline__ void load_chunk(Chunk& c,
                                           const int32_t* __restrict__ src,
                                           const int32_t* __restrict__ dst,
                                           const uint8_t* __restrict__ mask,
                                           int i, int width) {
  if constexpr (P == kVector) {
    c.mask = __ldcs(reinterpret_cast<const unsigned int*>(mask) + i);
    c.src = __ldcs(reinterpret_cast<const int4*>(src) + i);
    c.dst = __ldcs(reinterpret_cast<const int4*>(dst) + i);
    c.n = 4;
  } else if constexpr (P == kSparse) {  // the mask only; see load_live
    c.mask = __ldcs(reinterpret_cast<const unsigned int*>(mask) + i);
    c.n = 4;
  } else {
    const int w0 = 4 * i;
    c.n = min(4, width - w0);
    int s[4] = {0, 0, 0, 0}, d[4] = {0, 0, 0, 0};
    uint32_t m = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j < c.n) {
        s[j] = __ldcs(src + w0 + j);
        d[j] = __ldcs(dst + w0 + j);
        m |= static_cast<uint32_t>(__ldcs(mask + w0 + j) != 0) << (8 * j);
      }
    }
    c.src = make_int4(s[0], s[1], s[2], s[3]);
    c.dst = make_int4(d[0], d[1], d[2], d[3]);
    c.mask = m;
  }
}

// kSparse, second step: src/local_dst of a chunk that has a live slot.
__device__ __forceinline__ void load_live(Chunk& c,
                                          const int32_t* __restrict__ src,
                                          const int32_t* __restrict__ dst,
                                          int i) {
  if (c.mask != 0u) {
    c.src = __ldcs(reinterpret_cast<const int4*>(src) + i);
    c.dst = __ldcs(reinterpret_cast<const int4*>(dst) + i);
  } else {
    c.src = c.dst = make_int4(0, 0, 0, 0);
  }
}

// A thread's chunks first, first + step, ... (B of them) of one row.
template <int B>
struct Batch {
  Chunk c[B];
};

// Issues every load of a batch: src/local_dst/mask of each chunk in the
// row (kSparse: the masks, then src/local_dst of chunks with a live slot).
template <Path P, int B>
__device__ __forceinline__ void load_batch(Batch<B>& b,
                                           const int32_t* __restrict__ src,
                                           const int32_t* __restrict__ dst,
                                           const uint8_t* __restrict__ mask,
                                           int width, int n_chunks, int first,
                                           int step) {
#pragma unroll
  for (int k = 0; k < B; ++k) {
    const int i = first + k * step;
    b.c[k].mask = 0u;
    b.c[k].n = 0;
    b.c[k].src = b.c[k].dst = make_int4(0, 0, 0, 0);
    if (i < n_chunks) load_chunk<P>(b.c[k], src, dst, mask, i, width);
  }
  if constexpr (P == kSparse) {
#pragma unroll
    for (int k = 0; k < B; ++k) {
      const int i = first + k * step;
      if (i < n_chunks) load_live(b.c[k], src, dst, i);
    }
  }
}

// The signal gathers of a batch, independent of each other.
template <class Op, int B>
__device__ __forceinline__ void gather_batch(
    const typename Op::T* __restrict__ signal, const Batch<B>& b,
    typename Op::T (&v)[B][4]) {
#pragma unroll
  for (int k = 0; k < B; ++k) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if constexpr (Op::kOr) {
        v[k][j] = live(b.c[k].mask, j) ? __ldg(signal + lane_of(b.c[k].src, j))
                                       : uint8_t(0);
      } else {
        // signal * mask, as the reference computes it: a masked slot adds
        // a zero (skipped: +-0 never changes an accumulator that starts at
        // +0), but a non-finite signal behind it still adds NaN.
        v[k][j] = j < b.c[k].n ? __ldg(signal + lane_of(b.c[k].src, j)) *
                                     (live(b.c[k].mask, j) ? 1.0f : 0.0f)
                               : 0.0f;
      }
    }
  }
}

// The shared-memory updates of a batch: flags for OR; for the sum, f32
// atomics (a compare-and-swap loop in shared memory on this card).
template <class Op, int B>
__device__ __forceinline__ void scatter_batch(const Batch<B>& b,
                                              const typename Op::T (&v)[B][4],
                                              typename Op::T* acc) {
#pragma unroll
  for (int k = 0; k < B; ++k) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if constexpr (Op::kOr) {
        if (v[k][j]) acc[lane_of(b.c[k].dst, j)] = 1;
      } else {
        if (v[k][j] != 0.0f) atomicAdd(&acc[lane_of(b.c[k].dst, j)], v[k][j]);
      }
    }
  }
}

// Reduces chunks first, first + step, ... < n_chunks of one row into acc,
// batch_of(P) chunks at a time: loads, then gathers, then updates.
template <class Op, Path P>
__device__ __forceinline__ void reduce_row(
    const typename Op::T* __restrict__ signal,
    const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
    const uint8_t* __restrict__ mask, int width, int n_chunks, int first,
    int step, typename Op::T* acc) {
  constexpr int B = batch_of(P);
  for (int base = first; base < n_chunks; base += B * step) {
    Batch<B> b;
    load_batch<P, B>(b, src, dst, mask, width, n_chunks, base, step);
    typename Op::T v[B][4];
    gather_batch<Op, B>(signal, b, v);
    scatter_batch<Op, B>(b, v, acc);
  }
}

// Writes one row's accumulator to out_row and zeroes it; thread `lane` of
// `threads`.
template <typename T>
__device__ __forceinline__ void write_back(T* acc, T* __restrict__ out_row,
                                           const Rows& g, int lane,
                                           int threads) {
  if (g.out_vec) {
    const int n = g.block * static_cast<int>(sizeof(T)) / 16;
    uint4* a = reinterpret_cast<uint4*>(acc);
    uint4* o = reinterpret_cast<uint4*>(out_row);
    for (int i = lane; i < n; i += threads) {
      o[i] = a[i];
      a[i] = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    for (int b = lane; b < g.block; b += threads) {
      out_row[b] = acc[b];
      acc[b] = T(0);
    }
  }
}

__device__ __forceinline__ void zero_shared(unsigned char* p, int bytes) {
  for (int i = threadIdx.x; i < bytes / 16; i += blockDim.x) {
    reinterpret_cast<uint4*>(p)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
}

__device__ __forceinline__ void group_sync(int group, int threads) {
  // Named barrier 1 + group; barrier 0 stays __syncthreads'.
  asm volatile("bar.sync %0, %1;" ::"r"(group + 1), "r"(threads) : "memory");
}

// ---------------------------------------------------------------- the rows

// Rows of worker `worker` of `n_workers`: each block holds
// kThreads >> group_log2 row groups, each with its own accumulators.
// Every thread of the block calls this (it holds barriers).
template <class Op, Path P>
__device__ void run_rows(const typename Op::T* __restrict__ signal,
                         const int32_t* __restrict__ src,
                         const int32_t* __restrict__ dst,
                         const uint8_t* __restrict__ mask,
                         typename Op::T* __restrict__ out, const Rows& g,
                         int worker, int n_workers, unsigned char* smem) {
  using T = typename Op::T;
  const int threads = 1 << g.group_log2;
  const int groups = kThreads >> g.group_log2;
  const int group = threadIdx.x >> g.group_log2;
  const int lane = threadIdx.x & (threads - 1);
  unsigned char* mine = smem + group * g.n_acc * g.acc_bytes;
  zero_shared(smem, groups * g.n_acc * g.acc_bytes);
  __syncthreads();
  const int n_chunks = (g.width + 3) / 4;
  int local = 0;
  for (int row = worker * groups + group; row < g.n_rows;
       row += n_workers * groups, ++local) {
    T* acc = reinterpret_cast<T*>(mine + (local & (g.n_acc - 1)) *
                                             g.acc_bytes);
    const RowRef at = row_ref(row, g);
    reduce_row<Op, P>(signal + at.signal, src + at.slots, dst + at.slots,
                      mask + at.slots, g.width, n_chunks, lane, threads, acc);
    group_sync(group, threads);
    write_back<T>(acc, out + static_cast<int64_t>(row) * g.block, g, lane,
                  threads);
    if (g.n_acc == 1) group_sync(group, threads);
  }
}

// ------------------------------------------------------------------- host

inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// The path a geometry takes (see the head of this file).
inline Path choose_path(bool is_or, const void* src, const void* dst,
                        const void* mask, int width, int64_t bucket_stride) {
  const bool vec = width % 4 == 0 && bucket_stride % 4 == 0 &&
                   aligned(src, 16) && aligned(dst, 16) && aligned(mask, 4);
  if (!vec) return kScalar;
  if (is_or && width > kWideWidth) return kSparse;
  return kVector;
}

// The launch geometry of `path`: row groups, accumulators and the dynamic
// shared memory a block takes (at most kAccBudget).
inline Rows plan_rows(Path path, int elem_bytes, int n_shards,
                      int rows_per_shard, int width, int block,
                      int64_t bucket_stride, int64_t signal_stride,
                      const void* out, size_t* smem) {
  Rows g{};
  g.n_rows = n_shards * rows_per_shard;
  g.n_shards = n_shards;
  g.rows_per_shard = rows_per_shard;
  g.width = width;
  g.block = block;
  g.bucket_stride = bucket_stride;
  g.signal_stride = signal_stride;
  const int row_bytes = block * elem_bytes;
  g.acc_bytes = (row_bytes + 15) / 16 * 16;
  g.out_vec = row_bytes % 16 == 0 && aligned(out, 16);
  // Smallest row group (>= one warp) in which no thread takes more than
  // two chunks (batch 1) or one batch of four (batch 4) of a row, larger
  // while the groups' accumulators do not fit.
  const int per_thread = batch_of(path) == 1 ? 2 : 4;
  const int n_chunks = (width + 3) / 4;
  int threads = 32;
  while (threads < kThreads && threads * per_thread < n_chunks) threads *= 2;
  while (threads < kThreads &&
         (kThreads / threads) * g.acc_bytes * 2 > kAccBudget) {
    threads *= 2;
  }
  int log2 = 0;
  while ((1 << log2) < threads) ++log2;
  g.group_log2 = log2;
  const int groups = kThreads / threads;
  g.n_acc = groups * g.acc_bytes * 2 <= kAccBudget ? 2 : 1;
  *smem = static_cast<size_t>(groups) * g.n_acc * g.acc_bytes;
  return g;
}

// Calls launch(std::integral_constant<Path, P>()) for the kernel of
// `path` (SumOp has no kSparse kernel: choose_path never gives it one).
template <class Op, class Launch>
int dispatch(Path path, Launch&& launch) {
  switch (path) {
    case kSparse:
      if constexpr (Op::kOr) {
        return launch(std::integral_constant<Path, kSparse>());
      } else {
        return launch(std::integral_constant<Path, kVector>());
      }
    case kScalar:
      return launch(std::integral_constant<Path, kScalar>());
    default:
      return launch(std::integral_constant<Path, kVector>());
  }
}

inline int rows_per_block(const Rows& g) {
  return kThreads >> g.group_log2;
}

// The card's SM count, read once per device.
inline cudaError_t sm_count(int device, int* sms) {
  static std::atomic<int> cached[64];
  const bool slot = device >= 0 && device < 64;
  if (slot && (*sms = cached[device].load()) > 0) return cudaSuccess;
  const cudaError_t err =
      cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess && slot) cached[device].store(*sms);
  return err;
}

// Blocks of one kernel that fit on the card at once (SM count x blocks per
// SM at a launch's dynamic shared memory): the persistent grid. Each launch
// function keeps one of these as a function-local static, so each kernel
// instantiation has its own; it remembers the last kSlots (device, smem)
// pairs asked for, each packed with its answer into one atomic word
// (smem: bits 0-31, device: 32-47, blocks: 48-63; zero is empty).
class Residency {
 public:
  cudaError_t blocks(const void* kernel, size_t smem, int device,
                     int* blocks) {
    const uint64_t key = static_cast<uint64_t>(smem) |
                         static_cast<uint64_t>(device & 0xffff) << 32;
    for (auto& slot : slots_) {
      const uint64_t v = slot.load(std::memory_order_relaxed);
      if ((v >> 48) != 0 && (v & kKeyBits) == key) {
        *blocks = static_cast<int>(v >> 48);
        return cudaSuccess;
      }
    }
    cudaError_t err;
    if (smem > 48 * 1024) {  // opt in to more than the default 48 KB
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kAccBudget);
      if (err != cudaSuccess) return err;
    }
    int sms = 0, per_sm = 0;
    err = sm_count(device, &sms);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
    if (err != cudaSuccess) return err;
    *blocks = sms * (per_sm > 0 ? per_sm : 1);
    const unsigned next = next_.fetch_add(1, std::memory_order_relaxed);
    slots_[next % kSlots].store(
        key | static_cast<uint64_t>(*blocks & 0xffff) << 48,
        std::memory_order_relaxed);
    return cudaSuccess;
  }

 private:
  static constexpr int kSlots = 4;
  static constexpr uint64_t kKeyBits = (uint64_t{1} << 48) - 1;
  std::atomic<uint64_t> slots_[kSlots] = {};
  std::atomic<unsigned> next_{0};
};

// Row workers (blocks) of a launch: as many as fit at once, and no more
// than the rows need.
inline int row_workers(const Rows& g, int resident) {
  const int per = rows_per_block(g);
  const int need = (g.n_rows + per - 1) / per;
  return need < resident ? need : resident;
}

}  // namespace p2p
