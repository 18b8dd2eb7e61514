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
// coalesced loads. The OR entry writes flags (idempotent, bit-exact). The
// sum entry adds with shared-memory atomics, whose order varies from run to
// run: exact on integer-valued signals below 2^24, otherwise held to
// rtol = atol = 1e-5 against the plain version (ops/segsum.py).
//
// Plain C interface for ctypes; each entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void segsum_or_kernel(const uint8_t* __restrict__ signal,
                                 const int32_t* __restrict__ src,
                                 const int32_t* __restrict__ local_dst,
                                 const uint8_t* __restrict__ mask,
                                 uint8_t* __restrict__ out,
                                 int width, int block) {
  extern __shared__ uint32_t flags[];
  for (int b = threadIdx.x; b < block; b += blockDim.x) flags[b] = 0u;
  __syncthreads();
  const int64_t base = static_cast<int64_t>(blockIdx.x) * width;
  for (int w = threadIdx.x; w < width; w += blockDim.x) {
    if (mask[base + w] && signal[src[base + w]]) {
      flags[local_dst[base + w]] = 1u;
    }
  }
  __syncthreads();
  uint8_t* row = out + static_cast<int64_t>(blockIdx.x) * block;
  for (int b = threadIdx.x; b < block; b += blockDim.x) {
    row[b] = flags[b] != 0u;
  }
}

__global__ void segsum_sum_kernel(const float* __restrict__ signal,
                                  const int32_t* __restrict__ src,
                                  const int32_t* __restrict__ local_dst,
                                  const uint8_t* __restrict__ mask,
                                  float* __restrict__ out,
                                  int width, int block) {
  extern __shared__ float acc[];
  for (int b = threadIdx.x; b < block; b += blockDim.x) acc[b] = 0.0f;
  __syncthreads();
  const int64_t base = static_cast<int64_t>(blockIdx.x) * width;
  for (int w = threadIdx.x; w < width; w += blockDim.x) {
    // signal * mask, as the reference computes it: a masked slot adds a
    // zero (skipped: +-0 never changes an accumulator that starts at +0),
    // but a non-finite signal behind a masked slot still adds NaN.
    const float v = signal[src[base + w]] * (mask[base + w] ? 1.0f : 0.0f);
    if (v != 0.0f) atomicAdd(&acc[local_dst[base + w]], v);
  }
  __syncthreads();
  float* row = out + static_cast<int64_t>(blockIdx.x) * block;
  for (int b = threadIdx.x; b < block; b += blockDim.x) row[b] = acc[b];
}

}  // namespace

extern "C" {

int p2p_segsum_or(const void* signal, const void* src, const void* local_dst,
                  const void* mask, void* out, int n_rows, int width,
                  int block, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  segsum_or_kernel<<<n_rows, kThreads, block * sizeof(uint32_t),
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(signal), static_cast<const int32_t*>(src),
      static_cast<const int32_t*>(local_dst),
      static_cast<const uint8_t*>(mask), static_cast<uint8_t*>(out), width,
      block);
  return static_cast<int>(cudaGetLastError());
}

int p2p_segsum_sum(const void* signal, const void* src, const void* local_dst,
                   const void* mask, void* out, int n_rows, int width,
                   int block, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  segsum_sum_kernel<<<n_rows, kThreads, block * sizeof(float),
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(signal), static_cast<const int32_t*>(src),
      static_cast<const int32_t*>(local_dst),
      static_cast<const uint8_t*>(mask), static_cast<float*>(out), width,
      block);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
