// Row sums of f32 terms in XLA's CPU order of adds, for Hopper (sm_90a).
//
// Not the counterpart of a TPU kernel: the JAX package's `gather` and
// `skew` sums (jnp.sum over a row of gathered terms) and its 1-D sums are
// XLA reduces, and the port must add in their order to give their bits
// (ops/rowsum.py). That order, for a row of w terms:
//
//   w == 1:  the term itself (no add: a -0 stays -0);
//   w <= 32: left to right from +0;
//   w >  32: padded with p = -w mod 32 zeros to whole windows of 32,
//            p / 2 in front and the rest behind (XLA's reduce-window
//            padding), each window summed left to right from +0, and the
//            window sums reduced the same way (recursively).
//
// A sum that starts from +0 is never -0, and adding a zero to it leaves
// its bits, so a kernel may skip the padding or add it as zeros alike.
// Every add is __fadd_rn (and the gather entry's mask product __fmul_rn),
// so nvcc cannot contract a product and a sum into one fma and the bits
// stay XLA's. The plain version takes one
// torch launch per column of a window.
//
// What bounds it: each term is one 4-byte read (the gather entry: a 4-byte
// index, a mask byte and a 4-byte gather) and one add, so memory does;
// random gathers (the BA shape's indices span 100,096 nodes) cost a
// 32-byte L2 sector each, which the bytes bound does not count. The first
// design summed a row of <= 32 terms in one thread whose loop had a few
// loads in flight, and a row of 33 to 1,024 with one lane a window that
// waited on each of its 32 strided loads: 51% of the bound at w = 17 and
// 13% at w = 128. This one:
//
//   * Narrow rows (<= 32 terms, the 1M table's 17), a thread a row
//     (narrow_kernel): the index and mask loads of kChunk terms go out
//     together, then their gathers, then the adds, so a thread has
//     kChunk gathers in flight instead of a few. Neighbouring threads'
//     rows are adjacent, so L1 serves a warp's strided loads from the
//     lines it already holds. (Tiles of such rows staged through shared
//     memory, as wide rows are below, measured 6-18% slower than even the
//     first design at w = 17 at five geometries: the extra trips through
//     shared memory and the block's barriers cost more than coalescing
//     saves where L1 already coalesces.)
//   * Wide rows (33 to 1,024 terms) in tiles (tile_kernel): a block owns
//     tiles of consecutive rows (ops/rowsum.py::tile_rows). A tile's
//     indices and mask bytes are one contiguous span each, copied to
//     shared memory by 16-byte cp.async of the aligned chunks that hold it
//     (zero-filled past the table's end; plain loads only for a chunk
//     before the table's start, where a view's base is not aligned).
//     Blocks are persistent (SMs x resident blocks), tile j + 1's spans
//     copy while tile j gathers and adds, and the launch shrinks the tiles
//     so that every block takes the same number. Each thread issues all
//     its kTermsPerThread gathers before it stores a product; products go
//     to shared memory with each window padded to 33 words, so a thread
//     that walks a window hits no bank conflict. Then one thread adds a
//     window, and one thread a row's window sums.
//   * The dense entry's rows of <= 1,024 terms (the recorder's 1-D sums,
//     one row of 32 or 1,024 lanes) are one trip to memory and a chain of
//     dependent adds: a warp a row loads the row once, coalesced, turns it
//     through shared memory so that lane k holds window k, and adds
//     (warp_kernel). A row of no terms gives +0 there (the gather entry's:
//     in narrow_kernel).
//   * Rows of more than 1,024 terms (the ring's shard totals, [8, 125008]
//     and [8, 12512]), both entries: one warp a level-1 window, the 1,024
//     terms of 32 windows (span_kernel). The levels' item counts and front
//     zeros come from the host (ops/rowsum.py::wide_plan). The warp loads
//     its span as warp_kernel loads a row (load j of lane l: padded
//     position 32 j + l), turns it so that lane k holds window k, adds each
//     window and then the lanes' sums in order, and stores the level-1
//     window sum. The last warp of a row to finish (an arrival counter a
//     row: each warp's store, then an acq_rel atomic add, 0.1-0.4 us
//     less than __threadfence and atomicInc on the H100; the last arrival
//     resets the count for the next launch) sums the row's n <= 1,024
//     window sums as warp_kernel sums a row of n terms. Who arrives last
//     changes nothing: the window sums are read in index order. A row of
//     more than 32^4 = 1,048,576 terms has more than 1,024 window sums:
//     the pass stores them, and the next launch takes them as a dense
//     row, until at most 1,024 are left. The first design gave such a row
//     one thread, a chain of w dependent adds and uncoalesced loads:
//     15.9 ms at [8, 125008] on the H100, eight threads of the card at
//     work; this one takes ~11 us there: the launch floor and two latency
//     chains (the span's loads and adds; the arrival and the top, ~1.6
//     us).
//
// Plain C interface for ctypes; each entry returns the launch's CUDA error
// code (cudaErrorInvalidValue, before any launch, for a tile geometry or a
// plan that does not fit the width).

#include <cstdint>

#include <cuda/atomic>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// Enough blocks to fill 132 SMs many times over; more rows loop.
constexpr int64_t kMaxBlocks = 132 * 32;
constexpr int kWindow = 32;
// A warp's level-1 window: 32 windows of 32 terms.
constexpr int kSpan = kWindow * kWindow;
// Terms of a narrow row whose loads narrow_kernel has in flight at once.
constexpr int kChunk = 12;

// The tile kernel's geometry (mirrored in ops/rowsum.py): rows of 33 to
// 1,024 terms.
constexpr int kTileThreads = 256;
constexpr int kTileTerms = 2048;
constexpr int kTermsPerThread = kTileTerms / kTileThreads;
constexpr int kSlots = 2112;   // padded product words: 64 windows of 33
constexpr int kSumSlots = 128;  // window sums
constexpr int kPadStride = kWindow + 1;
// A span plus the partial 16-byte chunks at its two ends.
constexpr int kIdxBytes = 4 * kTileTerms + 32;
constexpr int kMaskBytes = kTileTerms + 32;
constexpr int kMaxDevices = 64;

// A masked-out term is x * 0 (+-0, or NaN for an infinite x), as the plain
// product.
__device__ __forceinline__ float masked(float x, bool live) {
  return live ? x : __fmul_rn(x, 0.0f);
}

// Term (r, c) of a dense [rows, w] table.
struct Dense {
  const float* __restrict__ vals;
  int64_t w;
  __device__ __forceinline__ float operator()(int64_t r, int64_t c) const {
    return vals[r * w + c];
  }
};

// Term (r, c) of a gathered row: signal[idx] * f32(mask).
struct Gathered {
  const float* __restrict__ signal;
  const int32_t* __restrict__ idx;
  const bool* __restrict__ mask;
  int64_t w;
  __device__ __forceinline__ float operator()(int64_t r, int64_t c) const {
    const int64_t i = r * w + c;
    return masked(signal[idx[i]], mask[i]);
  }
};

// The gather entry's rows of 1 to 32 terms, a thread a row: the index and
// mask loads of kChunk terms, then their gathers, all in flight together
// before their adds.
__global__ void __launch_bounds__(kThreads)
    narrow_kernel(const float* __restrict__ signal,
                  const int32_t* __restrict__ idx,
                  const bool* __restrict__ mask, int64_t rows, int w,
                  float* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       r < rows; r += stride) {
    const int32_t* ir = idx + r * w;
    const bool* mr = mask + r * w;
    float acc = 0.0f;
    for (int j0 = 0; j0 < w; j0 += kChunk) {
      int32_t id[kChunk];
      bool live[kChunk];
      float x[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (j0 + j < w) {
          id[j] = ir[j0 + j];
          live[j] = mr[j0 + j];
        }
      }
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
        if (j0 + j < w) x[j] = __ldg(signal + id[j]);
      if (w == 1) {
        acc = masked(x[0], live[0]);
        break;
      }
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
        if (j0 + j < w) acc = __fadd_rn(acc, masked(x[j], live[j]));
    }
    out[r] = acc;
  }
}

// Copies the 16 bytes at gmem (16-byte aligned), or its first `bytes`
// and zeros after them, to smem (16-byte aligned) asynchronously.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           unsigned bytes = 16) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most the newest `kPending` groups of this thread's copies
// are in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ int misalign(const void* p) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15);
}

// Bytes [src, src + n) of the array [first, last) to dst + misalign(src),
// so that src's aligned chunks land on aligned shared words, by cp.async
// of the whole 16-byte chunks that hold them. A chunk's bytes outside the
// span but inside the array (the neighbouring tiles') come along, unused;
// at the array's end the copy stops at `last` and fills zeros. Only a
// chunk that starts before `first` (a view whose base is not 16-byte
// aligned, its first tile) is read byte by byte, its loads all issued
// before its stores.
__device__ __forceinline__ void stage_span(unsigned char* dst,
                                           const unsigned char* src, int n,
                                           const unsigned char* first,
                                           const unsigned char* last) {
  const int head = misalign(src);
  const unsigned char* base = src - head;
  for (int lo = threadIdx.x * 16; lo < head + n; lo += blockDim.x * 16) {
    const unsigned char* chunk = base + lo;
    if (chunk >= first) {
      cp_async16(dst + lo, chunk,
                 chunk + 16 <= last ? 16u
                                    : static_cast<unsigned>(last - chunk));
      continue;
    }
    unsigned char b[16];
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (chunk + i >= first && chunk + i < last) b[i] = __ldg(chunk + i);
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (chunk + i >= first && chunk + i < last) dst[lo + i] = b[i];
  }
}

struct alignas(16) Stage {
  unsigned char idx[kIdxBytes];
  unsigned char mask[kMaskBytes];
};

// The gather entry's rows of 33 to 1,024 terms, a tile of `tile_rows` rows
// at a time (see the file comment). Tile j of the block is blockIdx.x + j
// gridDim.x; tile j + 1's spans copy while tile j gathers and adds.
__global__ void __launch_bounds__(kTileThreads)
    tile_kernel(const float* __restrict__ signal,
                const unsigned char* __restrict__ idx,
                const unsigned char* __restrict__ mask, int64_t rows, int w,
                int tile_rows, float* __restrict__ out) {
  __shared__ Stage stage[2];
  __shared__ float prod[kSlots];
  __shared__ float wsum[kSumSlots];

  const int64_t tiles = (rows + tile_rows - 1) / tile_rows;
  const int64_t mine =
      tiles > blockIdx.x ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int n = (w + kWindow - 1) / kWindow;
  // The row's zeros: `front` before its first term, the rest after its
  // last.
  const int front = (n * kWindow - w) / 2;
  const int end = front + w - (n - 1) * kWindow;
  const int sum_stride = n | 1;
  // Term threadIdx.x + i * kTileThreads of a tile is row r_i, column c_i:
  // (r_0, c_0) once, then steps of kTileThreads = step_r rows + step_c.
  const int r0 = threadIdx.x / w, c0 = threadIdx.x - r0 * w;
  const int step_r = kTileThreads / w, step_c = kTileThreads - step_r * w;
  const int64_t size = rows * w;

  // Tile j's first row, and its rows (the last tile's may be fewer).
  auto first_row = [&](int64_t j) {
    return (blockIdx.x + j * gridDim.x) * tile_rows;
  };
  auto rows_of = [&](int64_t j) {
    const int64_t left = rows - first_row(j);
    return left < tile_rows ? static_cast<int>(left) : tile_rows;
  };
  // Tile j's index and mask spans into stage[j % 2].
  auto copy = [&](int64_t j) {
    if (j < mine) {
      const int64_t at = first_row(j) * w;
      const int count = rows_of(j) * w;
      Stage& st = stage[j % 2];
      stage_span(st.idx, idx + 4 * at, 4 * count, idx, idx + 4 * size);
      stage_span(st.mask, mask + at, count, mask, mask + size);
    }
    cp_async_commit();
  };

  copy(0);
  for (int64_t j = 0; j < mine; ++j) {
    copy(j + 1);
    cp_async_wait<1>();
    __syncthreads();

    const int64_t row0 = first_row(j);
    const int tile_n = rows_of(j);
    const int count = tile_n * w;
    const int32_t* si = reinterpret_cast<const int32_t*>(
        stage[j % 2].idx + misalign(idx + 4 * row0 * w));
    const unsigned char* sm = stage[j % 2].mask + misalign(mask + row0 * w);

    // Products: every gather of this thread in flight before any store,
    // each into its term's padded slot.
    float x[kTermsPerThread];
#pragma unroll
    for (int i = 0; i < kTermsPerThread; ++i) {
      const int t = threadIdx.x + i * kTileThreads;
      x[i] = t < count ? __ldg(signal + si[t]) : 0.0f;
    }
    int r = r0, c = c0;
#pragma unroll
    for (int i = 0; i < kTermsPerThread; ++i) {
      const int t = threadIdx.x + i * kTileThreads;
      if (t < count) {
        const int q = c + front;
        prod[(r * n + q / kWindow) * kPadStride + q % kWindow] =
            masked(x[i], sm[t] != 0);
      }
      r += step_r;
      c += step_c;
      if (c >= w) {
        c -= w;
        ++r;
      }
    }
    __syncthreads();

    // The adds, in XLA's order: a thread a window, then a thread a row.
    for (int u = threadIdx.x; u < tile_n * n; u += kTileThreads) {
      const float* p = prod + u * kPadStride;
      const int k = u % n, from = k == 0 ? front : 0;
      const int to = k == n - 1 ? end : kWindow;
      float acc = 0.0f;
#pragma unroll
      for (int s = 0; s < kWindow; ++s)
        if (s >= from && s < to) acc = __fadd_rn(acc, p[s]);
      wsum[(u / n) * sum_stride + k] = acc;
    }
    __syncthreads();
    for (int row = threadIdx.x; row < tile_n; row += kTileThreads) {
      const float* sums = wsum + row * sum_stride;
      float acc = 0.0f;
      for (int k = 0; k < n; ++k) acc = __fadd_rn(acc, sums[k]);
      out[row0 + row] = acc;
    }
    // Tile j's stage and products are refilled next pass (its copy of
    // tile j + 2, its products): every thread is done with them first.
    __syncthreads();
  }
}

// A padded window's 32 slots, added left to right from +0. All its shared
// loads go out before the first add, so the chain waits on one load, not
// on each (the dense [1, 1024] sum: 0.16-0.24 us less).
__device__ __forceinline__ float window_sum(const float* p) {
  float v[kWindow];
#pragma unroll
  for (int s = 0; s < kWindow; ++s) v[s] = p[s];
  float acc = 0.0f;
#pragma unroll
  for (int s = 0; s < kWindow; ++s) acc = __fadd_rn(acc, v[s]);
  return acc;
}

// Lanes 0 .. count - 1's x, added left to right from +0 (every lane gets
// the sum); the shuffles all go out before the first add.
__device__ __forceinline__ float lane_sum(float x, int count) {
  float y[kWindow];
#pragma unroll
  for (int k = 0; k < kWindow; ++k) y[k] = __shfl_sync(0xffffffffu, x, k);
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < kWindow; ++k)
    if (k < count) acc = __fadd_rn(acc, y[k]);
  return acc;
}

// Items first .. first + 32 windows - 1 of a row of w items, zeros
// outside [0, w), summed by one warp: load j of lane l is item first +
// 32 j + l (coalesced, all in flight), turned through the warp's padded
// shared tile t so that lane k holds window k; each lane adds its window
// left to right from +0, then the lanes add the window sums in order
// through shuffles. Every lane gets the sum.
template <class Item>
__device__ __forceinline__ float span_sum(const Item& item, int64_t first,
                                          int64_t w, int windows, float* t,
                                          int lane) {
  float x[kWindow];
#pragma unroll
  for (int j = 0; j < kWindow; ++j) {
    const int64_t c = first + j * kWindow + lane;
    x[j] = j < windows && c >= 0 && c < w ? item(c) : 0.0f;
  }
#pragma unroll
  for (int j = 0; j < kWindow; ++j)
    if (j < windows) t[j * kPadStride + lane] = x[j];
  __syncwarp();
  const float window =
      lane < windows ? window_sum(t + lane * kPadStride) : 0.0f;
  __syncwarp();
  return lane_sum(window, windows);
}

// A row of w <= 1,024 items in XLA's order, by one warp (every lane gets
// the sum), as warp_kernel sums a row: one item is itself; <= 32 items,
// lane l loads item l and the lanes add them left to right through
// shuffles; wider rows are padded with zeros as the file comment says
// (window 0's leading zeros leave +0 as it is) and summed by span_sum.
template <class Item>
__device__ __forceinline__ float warp_row_sum(const Item& item, int64_t w,
                                              float* t, int lane) {
  if (w <= kWindow) {
    const float x = lane < w ? item(lane) : 0.0f;
    return w == 1 ? __shfl_sync(0xffffffffu, x, 0) : lane_sum(x, w);
  }
  const int n = static_cast<int>((w + kWindow - 1) / kWindow);
  return span_sum(item, -((n * kWindow - w) / 2), w, n, t, lane);
}

// The dense entry's rows of 0 to 1,024 terms, one warp a row. Rows of <=
// 32 terms: lane l loads term l, and the lanes add them left to right
// through shuffles. Wider rows: the warp loads the row padded with zeros
// as the file comment says, coalesced (load j: padded position 32 j +
// lane), and turns it through its padded shared tile so that lane k holds
// window k; each lane adds its window left to right from +0 (window 0's
// leading zeros leave +0 as it is), then the lanes add the window sums in
// order through shuffles. (The span kernel's top does the same through
// warp_row_sum; this kernel keeps its own int arithmetic: the shared
// template took 80 registers against 48 and 0.4-0.5 us more a launch on
// the H100.)
__global__ void __launch_bounds__(kThreads)
    warp_kernel(const float* __restrict__ vals, int64_t rows, int w,
                float* __restrict__ out) {
  constexpr int kWarps = kThreads / kWindow;
  __shared__ float turn[kWarps][kWindow * kPadStride];
  const int lane = threadIdx.x % kWindow;
  float* t = turn[threadIdx.x / kWindow];
  const int n = (w + kWindow - 1) / kWindow;
  const int front = (n * kWindow - w) / 2;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * kWarps +
                   threadIdx.x / kWindow;
       r < rows; r += static_cast<int64_t>(gridDim.x) * kWarps) {
    const float* row = vals + r * w;
    float acc;
    if (w <= kWindow) {
      const float x = lane < w ? row[lane] : 0.0f;
      acc = w == 1 ? __shfl_sync(0xffffffffu, x, 0) : lane_sum(x, w);
    } else {
      float x[kWindow];
#pragma unroll
      for (int j = 0; j < kWindow; ++j) {
        const int col = j * kWindow + lane - front;
        x[j] = j < n && col >= 0 && col < w ? row[col] : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < kWindow; ++j)
        if (j < n) t[j * kPadStride + lane] = x[j];
      __syncwarp();
      const float window = lane < n ? window_sum(t + lane * kPadStride)
                                    : 0.0f;
      __syncwarp();
      acc = lane_sum(window, n);
    }
    if (lane == 0) out[r] = acc;
  }
}

// One pass over rows of w > 1,024 items whose level-0 windows start after
// f0 zeros and level-1 windows after f1: warp g sums row g / n2's level-1
// window m = g % n2, the real items 32 (32 m - f1) - f0 + [0, 1,024), and
// stores it to part[g]. With `out`, n2 <= 1,024 and the pass is the last:
// the row's last warp to arrive (count[r], which it leaves at 0) sums the
// row's n2 window sums in index order into out[r]. Without, the next pass
// takes part as a dense [rows, n2] table.
template <class Load>
__global__ void __launch_bounds__(kThreads)
    span_kernel(Load load, int64_t rows, int64_t w, int f0, int f1,
                int64_t n2, float* part, unsigned* __restrict__ count,
                float* __restrict__ out) {
  constexpr int kWarps = kThreads / kWindow;
  __shared__ float turn[kWarps][kWindow * kPadStride];
  const int lane = threadIdx.x % kWindow;
  float* t = turn[threadIdx.x / kWindow];
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * kWarps +
                   threadIdx.x / kWindow;
       g < rows * n2; g += static_cast<int64_t>(gridDim.x) * kWarps) {
    const int64_t r = g / n2, m = g % n2;
    const float acc = span_sum([&](int64_t c) { return load(r, c); },
                               kWindow * (kWindow * m - f1) - f0, w, kWindow,
                               t, lane);
    unsigned ticket = 0;
    if (lane == 0) {
      part[g] = acc;
      if (out != nullptr) {
        // Release: the store is seen before the count; acquire: the last
        // arrival sees every other warp's store. The last one resets the
        // count for the next launch.
        cuda::atomic_ref<unsigned, cuda::thread_scope_device> arrivals(
            count[r]);
        ticket = arrivals.fetch_add(1u, cuda::memory_order_acq_rel);
        if (ticket == n2 - 1) arrivals.store(0u, cuda::memory_order_relaxed);
      }
    }
    if (out == nullptr ||
        __shfl_sync(0xffffffffu, ticket, 0) != static_cast<unsigned>(n2 - 1))
      continue;
    // The last warp of row r: lane 0's acquire orders the lanes' reads
    // after the barrier; they read L2, past L1.
    __syncwarp();
    const float* sums = part + r * n2;
    const float total = warp_row_sum(
        [&](int64_t c) { return __ldcg(sums + c); }, n2, t, lane);
    if (lane == 0) out[r] = total;
  }
}

int blocks_for(int64_t threads) {
  int64_t blocks = (threads + kThreads - 1) / kThreads;
  return static_cast<int>(blocks > kMaxBlocks ? kMaxBlocks : blocks);
}

// Blocks of the tile kernel that fill the card once: SMs x resident
// blocks per SM, per device.
int persistent_blocks(int device, cudaError_t* err) {
  static int cached[kMaxDevices];
  if (device >= 0 && device < kMaxDevices && cached[device] > 0)
    return cached[device];
  int sms = 0, per_sm = 0;
  *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (*err != cudaSuccess) return 0;
  *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tile_kernel,
                                                       kTileThreads, 0);
  if (*err != cudaSuccess) return 0;
  const int blocks = sms * (per_sm > 0 ? per_sm : 1);
  if (device >= 0 && device < kMaxDevices) cached[device] = blocks;
  return blocks;
}

// Whether `tile_rows` rows of w terms fit the tile kernel's buffers.
bool tile_fits(int64_t w, int64_t tile_rows) {
  if (w <= kWindow || w > kWindow * kWindow || tile_rows < 1) return false;
  const int64_t n = (w + kWindow - 1) / kWindow;
  return tile_rows * w <= kTileTerms && tile_rows * n * kPadStride <= kSlots &&
         tile_rows * (n | 1) <= kSumSlots;
}

// Rows of more than 1,024 terms take the span passes.
bool wide(int64_t w) { return w > kSpan; }

// The span passes of a row of plan[0] > 1,024 terms: plan holds each
// level's item count and front zeros (plan[2 l], plan[2 l + 1], l <
// levels), then the top's item count (ops/rowsum.py::wide_plan). A pass
// takes two levels and stores its window sums to `work` (rows x their
// count, each pass's after the last's), where the next pass, or the last
// pass's last warp of a row, reads them. One launch a pass.
template <class Load>
cudaError_t span_passes(Load load, int64_t rows, int64_t w,
                        const int64_t* plan, int levels, float* work,
                        unsigned* count, float* out, cudaStream_t s) {
  if (plan == nullptr || levels < 2 || plan[0] != w)
    return cudaErrorInvalidValue;
  auto items = [&](int l) { return plan[2 * (l < levels ? l : levels)]; };
  const float* prev = nullptr;
  for (int l = 0; items(l) > kSpan; l += 2) {
    const int64_t n2 = items(l + 2);
    const bool last = n2 <= kSpan;
    const int blocks = blocks_for(rows * n2 * kWindow);
    const int f0 = static_cast<int>(plan[2 * l + 1]);
    const int f1 = static_cast<int>(plan[2 * l + 3]);
    if (prev == nullptr) {
      span_kernel<<<blocks, kThreads, 0, s>>>(load, rows, items(l), f0, f1,
                                              n2, work, count,
                                              last ? out : nullptr);
    } else {
      span_kernel<<<blocks, kThreads, 0, s>>>(Dense{prev, items(l)}, rows,
                                              items(l), f0, f1, n2, work,
                                              count, last ? out : nullptr);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || last) return err;
    prev = work;
    work += rows * n2;
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// `plan`, `levels`, `work` and `count` serve rows of more than 1,024
// terms (span_passes; ignored otherwise): `work` holds the passes' window
// sums, `count` one zero a row, which the launch leaves at zero.
int p2p_row_sum_f32(const float* vals, int64_t rows, int64_t width,
                    const int64_t* plan, int levels, float* work,
                    unsigned* count, float* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wide(width))
    return static_cast<int>(span_passes(Dense{vals, width}, rows, width,
                                        plan, levels, work, count, out, s));
  warp_kernel<<<blocks_for(rows * kWindow), kThreads, 0, s>>>(
      vals, rows, static_cast<int>(width), out);
  return static_cast<int>(cudaGetLastError());
}

int p2p_gather_row_sum_f32(const float* signal, const int32_t* idx,
                           const bool* mask, int64_t rows, int64_t width,
                           int64_t tile_rows, const int64_t* plan,
                           int levels, float* work, unsigned* count,
                           float* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wide(width))
    return static_cast<int>(span_passes(Gathered{signal, idx, mask, width},
                                        rows, width, plan, levels, work,
                                        count, out, s));
  if (width <= kWindow) {
    narrow_kernel<<<blocks_for(rows), kThreads, 0, s>>>(
        signal, idx, mask, rows, static_cast<int>(width), out);
    return static_cast<int>(cudaGetLastError());
  }
  if (!tile_fits(width, tile_rows))
    return static_cast<int>(cudaErrorInvalidValue);
  const int most = persistent_blocks(device, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  int64_t tiles = (rows + tile_rows - 1) / tile_rows;
  if (tiles > most) {
    // Even passes: the fewest rows a tile that leave every block the same
    // number of tiles (the last block's last tile short), so that no block
    // runs a pass alone at the end.
    const int64_t passes = (tiles + most - 1) / most;
    tile_rows = (rows + most * passes - 1) / (most * passes);
    tiles = (rows + tile_rows - 1) / tile_rows;
  }
  tile_kernel<<<static_cast<int>(tiles < most ? tiles : most), kTileThreads,
                0, s>>>(signal, reinterpret_cast<const unsigned char*>(idx),
                     reinterpret_cast<const unsigned char*>(mask), rows,
                     static_cast<int>(width), static_cast<int>(tile_rows),
                     out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
