// Ring halo hop and fused ring step for Hopper (sm_90a), on one card.
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
// Both are bound by device-memory bytes: B2 reads and writes each byte once
// (2 MB for the bool [8, 125008] frontier, ~0.6 us at 3.35 TB/s, so launch
// latency dominates); B3 adds B1's bucket bytes, which dominate. The copy
// moves 16 bytes per thread when a shard's block is a multiple of 16 bytes
// and both buffers are 16-byte aligned, else 4 or 1.
//
// Grid of B3: the first n_copy blocks copy (scheduled first, so the hop
// runs beside the row reductions), the other n_shards * rows_per_shard
// blocks each reduce one bucket row.
//
// Plain C interface for ctypes; each entry returns cudaGetLastError().

#include "segsum.cuh"

namespace {

// Copy every shard's block to its ring neighbour; this block is worker
// `worker` of `n_workers`, each striding over every shard's elements.
// shift = S - 1 gives the forward hop, 1 the reverse.
template <typename V>
__device__ __forceinline__ void ring_copy(const V* __restrict__ src,
                                          V* __restrict__ dst,
                                          int64_t per_shard, int n_shards,
                                          int shift, int worker,
                                          int n_workers) {
  const int64_t first = static_cast<int64_t>(worker) * blockDim.x +
                        threadIdx.x;
  const int64_t step = static_cast<int64_t>(n_workers) * blockDim.x;
  for (int d = 0; d < n_shards; ++d) {
    int s = d + shift;
    if (s >= n_shards) s -= n_shards;
    const V* from = src + s * per_shard;
    V* to = dst + d * per_shard;
    for (int64_t i = first; i < per_shard; i += step) to[i] = from[i];
  }
}

template <typename V>
__global__ void ring_shift_kernel(const V* __restrict__ src,
                                  V* __restrict__ dst, int64_t per_shard,
                                  int n_shards, int shift) {
  ring_copy<V>(src, dst, per_shard, n_shards, shift, blockIdx.x, gridDim.x);
}

template <typename V>
__global__ void ring_segsum_or_kernel(
    const uint8_t* __restrict__ rot, uint8_t* __restrict__ rot_next,
    int64_t per_shard_vecs, int n_copy, const int32_t* __restrict__ src,
    const int32_t* __restrict__ local_dst, const uint8_t* __restrict__ mask,
    uint8_t* __restrict__ out, int n_shards, int rows_per_shard, int width,
    int block, int64_t bucket_stride, int64_t signal_stride) {
  extern __shared__ uint32_t flags[];
  if (static_cast<int>(blockIdx.x) < n_copy) {
    ring_copy<V>(reinterpret_cast<const V*>(rot),
                 reinterpret_cast<V*>(rot_next), per_shard_vecs, n_shards,
                 n_shards - 1, blockIdx.x, n_copy);
    return;
  }
  const int row = blockIdx.x - n_copy;
  const p2p::RowRef at = p2p::row_ref(row, rows_per_shard, width,
                                      bucket_stride, signal_stride);
  p2p::segsum_or_row(rot + at.signal, src + at.slots, local_dst + at.slots,
                     mask + at.slots, out + static_cast<int64_t>(row) * block,
                     width, block, flags);
}

template <typename V>
__global__ void ring_segsum_sum_kernel(
    const float* __restrict__ rot, float* __restrict__ rot_next,
    int64_t per_shard_vecs, int n_copy, const int32_t* __restrict__ src,
    const int32_t* __restrict__ local_dst, const uint8_t* __restrict__ mask,
    float* __restrict__ out, int n_shards, int rows_per_shard, int width,
    int block, int64_t bucket_stride, int64_t signal_stride) {
  extern __shared__ float acc[];
  if (static_cast<int>(blockIdx.x) < n_copy) {
    ring_copy<V>(reinterpret_cast<const V*>(rot),
                 reinterpret_cast<V*>(rot_next), per_shard_vecs, n_shards,
                 n_shards - 1, blockIdx.x, n_copy);
    return;
  }
  const int row = blockIdx.x - n_copy;
  const p2p::RowRef at = p2p::row_ref(row, rows_per_shard, width,
                                      bucket_stride, signal_stride);
  p2p::segsum_sum_row(rot + at.signal, src + at.slots, local_dst + at.slots,
                      mask + at.slots, out + static_cast<int64_t>(row) * block,
                      width, block, acc);
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

// Copy blocks for a payload of `vecs` units per shard: enough that each
// thread moves about one unit of every shard, at most 1024.
int copy_blocks(int64_t vecs) {
  const int64_t n = (vecs + p2p::kThreads - 1) / p2p::kThreads;
  return static_cast<int>(n < 1 ? 1 : (n > 1024 ? 1024 : n));
}

template <typename V>
void launch_shift(const void* src, void* dst, int64_t shard_bytes,
                  int n_shards, int shift, cudaStream_t stream) {
  const int64_t vecs = shard_bytes / static_cast<int64_t>(sizeof(V));
  ring_shift_kernel<V><<<copy_blocks(vecs), p2p::kThreads, 0, stream>>>(
      static_cast<const V*>(src), static_cast<V*>(dst), vecs, n_shards,
      shift);
}

template <typename T, typename V>
void launch_segsum(const void* rot, void* rot_next, int64_t signal_stride,
                   const void* src, const void* local_dst, const void* mask,
                   void* out, int n_shards, int rows_per_shard, int width,
                   int block, int64_t bucket_stride, cudaStream_t stream) {
  const int64_t vecs =
      signal_stride * static_cast<int64_t>(sizeof(T)) /
      static_cast<int64_t>(sizeof(V));
  const int n_copy = copy_blocks(vecs);
  const int grid = n_copy + n_shards * rows_per_shard;
  const size_t smem = static_cast<size_t>(block) * 4;
  if constexpr (sizeof(T) == 1) {
    ring_segsum_or_kernel<V><<<grid, p2p::kThreads, smem, stream>>>(
        static_cast<const uint8_t*>(rot), static_cast<uint8_t*>(rot_next),
        vecs, n_copy, static_cast<const int32_t*>(src),
        static_cast<const int32_t*>(local_dst),
        static_cast<const uint8_t*>(mask), static_cast<uint8_t*>(out),
        n_shards, rows_per_shard, width, block, bucket_stride, signal_stride);
  } else {
    ring_segsum_sum_kernel<V><<<grid, p2p::kThreads, smem, stream>>>(
        static_cast<const float*>(rot), static_cast<float*>(rot_next), vecs,
        n_copy, static_cast<const int32_t*>(src),
        static_cast<const int32_t*>(local_dst),
        static_cast<const uint8_t*>(mask), static_cast<float*>(out),
        n_shards, rows_per_shard, width, block, bucket_stride, signal_stride);
  }
}

template <typename T>
int ring_segsum(const void* rot, void* rot_next, int64_t signal_stride,
                const void* src, const void* local_dst, const void* mask,
                void* out, int n_shards, int rows_per_shard, int width,
                int block, int64_t bucket_stride, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t shard_bytes = signal_stride * static_cast<int64_t>(sizeof(T));
  switch (vec_bytes(rot, rot_next, shard_bytes)) {
    case 16:
      launch_segsum<T, uint4>(rot, rot_next, signal_stride, src, local_dst,
                              mask, out, n_shards, rows_per_shard, width,
                              block, bucket_stride, s);
      break;
    case 4:
      launch_segsum<T, uint32_t>(rot, rot_next, signal_stride, src,
                                 local_dst, mask, out, n_shards,
                                 rows_per_shard, width, block, bucket_stride,
                                 s);
      break;
    default:
      launch_segsum<T, uint8_t>(rot, rot_next, signal_stride, src, local_dst,
                                mask, out, n_shards, rows_per_shard, width,
                                block, bucket_stride, s);
  }
  return static_cast<int>(cudaGetLastError());
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
      launch_shift<uint4>(src, dst, shard_bytes, n_shards, shift, s);
      break;
    case 4:
      launch_shift<uint32_t>(src, dst, shard_bytes, n_shards, shift, s);
      break;
    default:
      launch_shift<uint8_t>(src, dst, shard_bytes, n_shards, shift, s);
  }
  return static_cast<int>(cudaGetLastError());
}

int p2p_ring_segsum_or(const void* rot, void* rot_next,
                       int64_t signal_stride, const void* src,
                       const void* local_dst, const void* mask, void* out,
                       int n_shards, int rows_per_shard, int width, int block,
                       int64_t bucket_stride, int device, void* stream) {
  return ring_segsum<uint8_t>(rot, rot_next, signal_stride, src, local_dst,
                              mask, out, n_shards, rows_per_shard, width,
                              block, bucket_stride, device, stream);
}

int p2p_ring_segsum_sum(const void* rot, void* rot_next,
                        int64_t signal_stride, const void* src,
                        const void* local_dst, const void* mask, void* out,
                        int n_shards, int rows_per_shard, int width,
                        int block, int64_t bucket_stride, int device,
                        void* stream) {
  return ring_segsum<float>(rot, rot_next, signal_stride, src, local_dst,
                            mask, out, n_shards, rows_per_shard, width,
                            block, bucket_stride, device, stream);
}

}  // extern "C"
