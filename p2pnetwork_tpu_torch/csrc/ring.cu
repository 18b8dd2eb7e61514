// Ring halo hop (kernel B2) and fused ring step (kernel B3) for Hopper
// (sm_90a), on one card.
//
// Replaces p2pnetwork_tpu/ops/pallas_ring.py::_ring_halo_copy_kernel (B2)
// and ::_ring_halo_segsum_kernel (B3). On the TPU each shard of the ring is
// a chip and a hop is a DMA to the neighbouring chip. Here all S shards are
// resident on one card, stacked on a leading axis, so a hop is a
// device-local copy with a rotated shard index:
//
//   forward:  out[d] = x[(d - 1) mod S]     (shard d receives d - 1's block)
//   reverse:  out[d] = x[(d + 1) mod S]
//
// B2 is that copy alone; B3 runs it in the same launch as B1's segment sum
// of every shard's bucket (segsum.cuh), reading the resident block while
// the copy writes the next one into a separate buffer.
//
// What bounds them on an H100. B2 reads and writes each byte once: 2 MB
// for the bool [8, 125008] frontier, 0.6 us at 3.35 TB/s, so what is left
// is launch latency and one DRAM round trip. The first design sized its
// grid for one shard's units (31 blocks on 132 SMs for the bool frontier)
// and made every thread walk the S shards in turn, one 16-byte load and
// store per shard, so the copy took ~10 us, level with torch.roll (H100
// 80GB HBM3, 700 W; chip_smoke.py, PERF.md). Now the
// grid covers all S x units of the payload, shard and offset computed from
// the global index: one tile of kThreads x U units per block, each thread
// issuing its U loads before its stores, with U (1, 2 or 4) chosen so that
// the grid has several blocks per SM. The unit is 16 bytes where a shard's
// block and both buffers allow it, else 4 or 1 (vec_bytes).
//
// B3 is bound by B1's bucket bytes. Its first `n_copy` blocks copy tiles
// of U = 4 units (n_copy derived from the payload), the rest are the
// persistent row workers of segsum.cuh; the row path follows the bucket
// geometry as in B1 (the ring mxu buckets [8, 245, 4864], 13% live, take
// kSparse for OR and kVector for the sum).
//
// Plain C interface for ctypes; each entry returns a CUDA error code.

#include "segsum.cuh"

namespace {

// Tile `tile` of the hop: units j = tile * kThreads * U + k * kThreads +
// threadIdx.x of the [S, per_shard] payload; out unit j reads shard
// (d + shift) mod S of its own offset. shift = S - 1 is the forward hop,
// 1 the reverse.
template <typename V, int U>
__device__ __forceinline__ void ring_copy_tile(const V* __restrict__ src,
                                               V* __restrict__ dst,
                                               int64_t per_shard,
                                               int n_shards, int shift,
                                               int64_t tile) {
  const int64_t total = per_shard * n_shards;
  const int64_t first = tile * (p2p::kThreads * U) + threadIdx.x;
  V v[U];
#pragma unroll
  for (int k = 0; k < U; ++k) {
    const int64_t j = first + k * p2p::kThreads;
    if (j < total) {
      const int64_t d = j / per_shard;
      int64_t s = d + shift;
      if (s >= n_shards) s -= n_shards;
      v[k] = src[j + (s - d) * per_shard];
    }
  }
#pragma unroll
  for (int k = 0; k < U; ++k) {
    const int64_t j = first + k * p2p::kThreads;
    if (j < total) dst[j] = v[k];
  }
}

template <typename V, int U>
__global__ void __launch_bounds__(p2p::kThreads)
    ring_shift_kernel(const V* __restrict__ src, V* __restrict__ dst,
                      int64_t per_shard, int n_shards, int shift) {
  ring_copy_tile<V, U>(src, dst, per_shard, n_shards, shift, blockIdx.x);
}

// B3's copy tiles: U = 4 units of `unit` bytes (16, 4 or 1).
constexpr int kCopyUnits = 4;

template <class Op, p2p::Path P>
__global__ void __launch_bounds__(p2p::kThreads, p2p::kMinBlocks)
    ring_segsum_kernel(const typename Op::T* __restrict__ rot,
                       typename Op::T* __restrict__ rot_next,
                       int64_t per_shard_units, int unit, int n_copy,
                       const int32_t* __restrict__ src,
                       const int32_t* __restrict__ local_dst,
                       const uint8_t* __restrict__ mask,
                       typename Op::T* __restrict__ out, p2p::Rows g) {
  extern __shared__ __align__(16) unsigned char smem[];
  if (static_cast<int>(blockIdx.x) < n_copy) {
    const int shift = g.n_shards - 1;
    switch (unit) {
      case 16:
        ring_copy_tile<uint4, kCopyUnits>(
            reinterpret_cast<const uint4*>(rot),
            reinterpret_cast<uint4*>(rot_next), per_shard_units, g.n_shards,
            shift, blockIdx.x);
        break;
      case 4:
        ring_copy_tile<uint32_t, kCopyUnits>(
            reinterpret_cast<const uint32_t*>(rot),
            reinterpret_cast<uint32_t*>(rot_next), per_shard_units,
            g.n_shards, shift, blockIdx.x);
        break;
      default:
        ring_copy_tile<uint8_t, kCopyUnits>(
            reinterpret_cast<const uint8_t*>(rot),
            reinterpret_cast<uint8_t*>(rot_next), per_shard_units,
            g.n_shards, shift, blockIdx.x);
    }
    return;
  }
  p2p::run_rows<Op, P>(rot, src, local_dst, mask, out, g, blockIdx.x - n_copy,
                       gridDim.x - n_copy, smem);
}

// Widest copy unit (16, 4 or 1 bytes) that divides a shard's block and
// keeps both buffers aligned.
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

template <typename V>
int launch_shift(const void* src, void* dst, int64_t shard_bytes,
                 int n_shards, int shift, int device, cudaStream_t stream) {
  const int64_t per = shard_bytes / static_cast<int64_t>(sizeof(V));
  const int64_t units = per * n_shards;
  // The most units per thread that still leaves 4 blocks per SM.
  int sms = 0;
  const cudaError_t err = p2p::sm_count(device, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t want = 4 * static_cast<int64_t>(sms);
  const auto s = static_cast<const V*>(src);
  const auto d = static_cast<V*>(dst);
  if (tiles(units, 4) >= want) {
    ring_shift_kernel<V, 4><<<tiles(units, 4), p2p::kThreads, 0, stream>>>(
        s, d, per, n_shards, shift);
  } else if (tiles(units, 2) >= want) {
    ring_shift_kernel<V, 2><<<tiles(units, 2), p2p::kThreads, 0, stream>>>(
        s, d, per, n_shards, shift);
  } else {
    ring_shift_kernel<V, 1><<<tiles(units, 1), p2p::kThreads, 0, stream>>>(
        s, d, per, n_shards, shift);
  }
  return static_cast<int>(cudaGetLastError());
}

template <class Op, p2p::Path P>
int launch_segsum(const void* rot, void* rot_next, int64_t per_shard_units,
                  int unit, const void* src, const void* local_dst,
                  const void* mask, void* out, const p2p::Rows& g,
                  size_t smem, int device, cudaStream_t stream) {
  using T = typename Op::T;
  static p2p::Residency residency;  // one per kernel instantiation
  int resident = 0;
  const cudaError_t err = residency.blocks(
      reinterpret_cast<const void*>(ring_segsum_kernel<Op, P>), smem, device,
      &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_copy =
      static_cast<int>(tiles(per_shard_units * g.n_shards, kCopyUnits));
  const int grid = n_copy + p2p::row_workers(g, resident);
  ring_segsum_kernel<Op, P><<<grid, p2p::kThreads, smem, stream>>>(
      static_cast<const T*>(rot), static_cast<T*>(rot_next), per_shard_units,
      unit, n_copy, static_cast<const int32_t*>(src),
      static_cast<const int32_t*>(local_dst),
      static_cast<const uint8_t*>(mask), static_cast<T*>(out), g);
  return static_cast<int>(cudaGetLastError());
}

template <class Op>
int ring_segsum(const void* rot, void* rot_next, int64_t signal_stride,
                const void* src, const void* local_dst, const void* mask,
                void* out, int n_shards, int rows_per_shard, int width,
                int block, int64_t bucket_stride, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t shard_bytes =
      signal_stride * static_cast<int64_t>(sizeof(typename Op::T));
  const int unit = vec_bytes(rot, rot_next, shard_bytes);
  const int64_t units = shard_bytes / unit;
  const p2p::Path path = p2p::choose_path(Op::kOr, src, local_dst, mask,
                                          width, bucket_stride);
  size_t smem = 0;
  const p2p::Rows g = p2p::plan_rows(
      path, sizeof(typename Op::T), n_shards, rows_per_shard, width, block,
      bucket_stride, signal_stride, out, &smem);
  return p2p::dispatch<Op>(path, [&](auto p) {
    return launch_segsum<Op, decltype(p)::value>(rot, rot_next, units, unit,
                                                 src, local_dst, mask, out, g,
                                                 smem, device, s);
  });
}

}  // namespace

extern "C" {

int p2p_ring_shift(const void* src, void* dst, int n_shards,
                   int64_t shard_bytes, int reverse, int device,
                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int shift = reverse ? 1 : n_shards - 1;
  switch (vec_bytes(src, dst, shard_bytes)) {
    case 16:
      return launch_shift<uint4>(src, dst, shard_bytes, n_shards, shift,
                                 device, s);
    case 4:
      return launch_shift<uint32_t>(src, dst, shard_bytes, n_shards, shift,
                                    device, s);
    default:
      return launch_shift<uint8_t>(src, dst, shard_bytes, n_shards, shift,
                                   device, s);
  }
}

int p2p_ring_segsum_or(const void* rot, void* rot_next,
                       int64_t signal_stride, const void* src,
                       const void* local_dst, const void* mask, void* out,
                       int n_shards, int rows_per_shard, int width, int block,
                       int64_t bucket_stride, int device, void* stream) {
  return ring_segsum<p2p::OrOp>(rot, rot_next, signal_stride, src, local_dst,
                                mask, out, n_shards, rows_per_shard, width,
                                block, bucket_stride, device, stream);
}

int p2p_ring_segsum_sum(const void* rot, void* rot_next,
                        int64_t signal_stride, const void* src,
                        const void* local_dst, const void* mask, void* out,
                        int n_shards, int rows_per_shard, int width,
                        int block, int64_t bucket_stride, int device,
                        void* stream) {
  return ring_segsum<p2p::SumOp>(rot, rot_next, signal_stride, src,
                                 local_dst, mask, out, n_shards,
                                 rows_per_shard, width, block, bucket_stride,
                                 device, stream);
}

}  // extern "C"
