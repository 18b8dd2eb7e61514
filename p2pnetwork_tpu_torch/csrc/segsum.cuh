// Device code shared by the blocked segment sum (segsum.cu, kernel B1) and
// the fused ring step (ring.cu, kernel B3).
//
// A launch reduces n_shards * rows_per_shard rows. Row `row` belongs to
// shard d = row / rows_per_shard; its W slots start at
// d * bucket_stride + (row % rows_per_shard) * width, so a bucket that is a
// strided slice of a larger array (the ring's [S, S, NB, W] layout, step t
// taken as [:, t]) is read in place; it reads the signal of its own shard,
// signal + d * signal_stride. One shard with signal_stride 0 is the plain
// single-device layout.
//
// Each row reduces into a block-wide accumulator in shared memory and
// writes it out once. Every thread of the block must call these functions
// (they hold __syncthreads).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace p2p {

constexpr int kThreads = 256;

struct RowRef {
  int64_t slots;   // offset of the row's first slot in src/dst/mask
  int64_t signal;  // offset of the row's shard in the signal
};

__device__ __forceinline__ RowRef row_ref(int row, int rows_per_shard,
                                          int width, int64_t bucket_stride,
                                          int64_t signal_stride) {
  const int d = row / rows_per_shard;
  const int r = row - d * rows_per_shard;
  return {d * bucket_stride + static_cast<int64_t>(r) * width,
          d * signal_stride};
}

// out_row[b] = any(signal[src[w]] && mask[w] for w with dst[w] == b).
// Flags are idempotent, so the result is bit-exact.
__device__ __forceinline__ void segsum_or_row(
    const uint8_t* __restrict__ signal, const int32_t* __restrict__ src,
    const int32_t* __restrict__ dst, const uint8_t* __restrict__ mask,
    uint8_t* __restrict__ out_row, int width, int block, uint32_t* flags) {
  for (int b = threadIdx.x; b < block; b += blockDim.x) flags[b] = 0u;
  __syncthreads();
  for (int w = threadIdx.x; w < width; w += blockDim.x) {
    if (mask[w] && signal[src[w]]) flags[dst[w]] = 1u;
  }
  __syncthreads();
  for (int b = threadIdx.x; b < block; b += blockDim.x) {
    out_row[b] = flags[b] != 0u;
  }
}

// out_row[b] = sum(signal[src[w]] * mask[w] for w with dst[w] == b), f32
// shared-memory atomics in an order that varies from run to run.
__device__ __forceinline__ void segsum_sum_row(
    const float* __restrict__ signal, const int32_t* __restrict__ src,
    const int32_t* __restrict__ dst, const uint8_t* __restrict__ mask,
    float* __restrict__ out_row, int width, int block, float* acc) {
  for (int b = threadIdx.x; b < block; b += blockDim.x) acc[b] = 0.0f;
  __syncthreads();
  for (int w = threadIdx.x; w < width; w += blockDim.x) {
    // signal * mask, as the reference computes it: a masked slot adds a
    // zero (skipped: +-0 never changes an accumulator that starts at +0),
    // but a non-finite signal behind a masked slot still adds NaN.
    const float v = signal[src[w]] * (mask[w] ? 1.0f : 0.0f);
    if (v != 0.0f) atomicAdd(&acc[dst[w]], v);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < block; b += blockDim.x) out_row[b] = acc[b];
}

}  // namespace p2p
