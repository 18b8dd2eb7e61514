// Blocked segment sum for Hopper (sm_90a).
//
// Replaces p2pnetwork_tpu/ops/pallas_edge.py::_segsum_kernel. For every
// node-block row n of the blocked layout (ops/blocked.py):
//
//   out[n, b] = sum_w signal[src[n, w]] * mask[n, w] * (local_dst[n, w] == b)
//
// The TPU kernel turned this into a one-hot matrix product for the MXU,
// after XLA gathered signal[src] * mask into HBM. Here it is what it is: a
// gather and a scatter within one row. The work is ~1 operation per 9 bytes
// read (src i32 + local_dst i32 + mask u8 per slot), so the kernel is bound
// by device-memory bytes, and the design moves only those: the gather of
// signal is fused in (signal is small and stays in L2), no one-hot exists,
// and each row reduces into a block-wide accumulator in shared memory
// (2 KB at block = 512), written out once.
//
// One thread block per row; its threads stride over the row's W slots with
// coalesced loads (segsum.cuh). The OR entry writes flags (idempotent,
// bit-exact). The sum entry adds with shared-memory atomics, whose order
// varies from run to run: exact on integer-valued signals below 2^24,
// otherwise held to rtol = atol = 1e-5 against the plain version
// (ops/segsum.py).
//
// The ring (parallel/sharded.py) runs the same rows on all S shards of a
// stacked [S, B] signal in one launch: n_shards, rows_per_shard and the two
// strides place each row (segsum.cuh). One shard with signal_stride 0 is
// the single-device call.
//
// Plain C interface for ctypes; each entry returns cudaGetLastError().

#include "segsum.cuh"

namespace {

__global__ void segsum_or_kernel(const uint8_t* __restrict__ signal,
                                 const int32_t* __restrict__ src,
                                 const int32_t* __restrict__ local_dst,
                                 const uint8_t* __restrict__ mask,
                                 uint8_t* __restrict__ out, int rows_per_shard,
                                 int width, int block, int64_t bucket_stride,
                                 int64_t signal_stride) {
  extern __shared__ uint32_t flags[];
  const p2p::RowRef at = p2p::row_ref(blockIdx.x, rows_per_shard, width,
                                      bucket_stride, signal_stride);
  p2p::segsum_or_row(signal + at.signal, src + at.slots,
                     local_dst + at.slots, mask + at.slots,
                     out + static_cast<int64_t>(blockIdx.x) * block, width,
                     block, flags);
}

__global__ void segsum_sum_kernel(const float* __restrict__ signal,
                                  const int32_t* __restrict__ src,
                                  const int32_t* __restrict__ local_dst,
                                  const uint8_t* __restrict__ mask,
                                  float* __restrict__ out, int rows_per_shard,
                                  int width, int block, int64_t bucket_stride,
                                  int64_t signal_stride) {
  extern __shared__ float acc[];
  const p2p::RowRef at = p2p::row_ref(blockIdx.x, rows_per_shard, width,
                                      bucket_stride, signal_stride);
  p2p::segsum_sum_row(signal + at.signal, src + at.slots,
                      local_dst + at.slots, mask + at.slots,
                      out + static_cast<int64_t>(blockIdx.x) * block, width,
                      block, acc);
}

}  // namespace

extern "C" {

int p2p_segsum_or(const void* signal, const void* src, const void* local_dst,
                  const void* mask, void* out, int n_shards,
                  int rows_per_shard, int width, int block,
                  int64_t bucket_stride, int64_t signal_stride, int device,
                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  segsum_or_kernel<<<n_shards * rows_per_shard, p2p::kThreads,
                     block * sizeof(uint32_t),
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(signal), static_cast<const int32_t*>(src),
      static_cast<const int32_t*>(local_dst),
      static_cast<const uint8_t*>(mask), static_cast<uint8_t*>(out),
      rows_per_shard, width, block, bucket_stride, signal_stride);
  return static_cast<int>(cudaGetLastError());
}

int p2p_segsum_sum(const void* signal, const void* src, const void* local_dst,
                   const void* mask, void* out, int n_shards,
                   int rows_per_shard, int width, int block,
                   int64_t bucket_stride, int64_t signal_stride, int device,
                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  segsum_sum_kernel<<<n_shards * rows_per_shard, p2p::kThreads,
                      block * sizeof(float),
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(signal), static_cast<const int32_t*>(src),
      static_cast<const int32_t*>(local_dst),
      static_cast<const uint8_t*>(mask), static_cast<float*>(out),
      rows_per_shard, width, block, bucket_stride, signal_stride);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
