// Blocked segment sum (kernel B1) for Hopper (sm_90a).
//
// Replaces p2pnetwork_tpu/ops/pallas_edge.py::_segsum_kernel. For every
// node-block row n of the blocked layout (ops/blocked.py):
//
//   out[n, b] = sum_w signal[src[n, w]] * mask[n, w] * (local_dst[n, w] == b)
//
// The TPU kernel turned this into a one-hot matrix product for the MXU,
// after XLA gathered signal[src] * mask into HBM. Here it is what it is: a
// gather and a scatter within one row. The work is ~1 operation per 9 bytes
// read (src i32 + local_dst i32 + mask u8 per slot), far below the card's
// compute balance, so memory bounds it, and the design moves only the
// bytes it must: the gather of signal is fused in (signal is small and
// stays in L2), no one-hot exists, and each row reduces into an
// accumulator of `block` elements in shared memory, written out once.
//
// The first design ran one 256-thread block per row (7,813 blocks on the
// blocked layout), each thread taking its ~5.5 slots one after another
// through a chain of scalar loads (mask, then src, then signal[src], then
// dst): 98 us against a 27.5 us byte bound (H100 80GB HBM3, 700 W;
// chip_smoke.py, PERF.md). The row engine (segsum.cuh)
// issues each chunk's loads as vectors before any use, on a persistent
// grid, with several rows per block where rows are narrow. What bounds
// the blocked layout on this card is the throughput of its ~10M random
// signal gathers through L2, and for the sum a compare-and-swap loop per
// shared-memory f32 atomic; a bulk-copy (TMA) pipeline that hides DRAM
// latency was built, timed, found slower and removed (segsum.cuh says
// which geometry takes which path, and what was tried).
//
// The OR entry writes flags (idempotent, bit-exact). The sum entry adds
// with shared-memory atomics, whose order varies from run to run: exact on
// integer-valued signals below 2^24, otherwise held to rtol = atol = 1e-5
// against the plain version (ops/segsum.py).
//
// The ring (parallel/sharded.py) runs the same rows on all S shards of a
// stacked [S, B] signal in one launch: n_shards, rows_per_shard and the two
// strides place each row (segsum.cuh). One shard with signal_stride 0 is
// the single-device call.
//
// Plain C interface for ctypes; each entry returns a CUDA error code (that
// of the launch, or of the occupancy query before the first launch of a
// kernel).

#include "segsum.cuh"

namespace {

template <class Op, p2p::Path P>
__global__ void __launch_bounds__(p2p::kThreads, p2p::kMinBlocks)
    segsum_kernel(const typename Op::T* __restrict__ signal,
                  const int32_t* __restrict__ src,
                  const int32_t* __restrict__ local_dst,
                  const uint8_t* __restrict__ mask,
                  typename Op::T* __restrict__ out, p2p::Rows g) {
  extern __shared__ __align__(16) unsigned char smem[];
  p2p::run_rows<Op, P>(signal, src, local_dst, mask, out, g, blockIdx.x,
                       gridDim.x, smem);
}

template <class Op, p2p::Path P>
int launch(const void* signal, const void* src, const void* local_dst,
           const void* mask, void* out, const p2p::Rows& g, size_t smem,
           int device, cudaStream_t stream) {
  using T = typename Op::T;
  static p2p::Residency residency;  // one per kernel instantiation
  int resident = 0;
  const cudaError_t err = residency.blocks(
      reinterpret_cast<const void*>(segsum_kernel<Op, P>), smem, device,
      &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = p2p::row_workers(g, resident);
  segsum_kernel<Op, P><<<grid, p2p::kThreads, smem, stream>>>(
      static_cast<const T*>(signal), static_cast<const int32_t*>(src),
      static_cast<const int32_t*>(local_dst),
      static_cast<const uint8_t*>(mask), static_cast<T*>(out), g);
  return static_cast<int>(cudaGetLastError());
}

template <class Op>
int segsum(const void* signal, const void* src, const void* local_dst,
           const void* mask, void* out, int n_shards, int rows_per_shard,
           int width, int block, int64_t bucket_stride,
           int64_t signal_stride, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const p2p::Path path = p2p::choose_path(Op::kOr, src, local_dst, mask,
                                          width, bucket_stride);
  size_t smem = 0;
  const p2p::Rows g = p2p::plan_rows(
      path, sizeof(typename Op::T), n_shards, rows_per_shard, width, block,
      bucket_stride, signal_stride, out, &smem);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return p2p::dispatch<Op>(path, [&](auto p) {
    return launch<Op, decltype(p)::value>(signal, src, local_dst, mask, out,
                                          g, smem, device, s);
  });
}

}  // namespace

extern "C" {

int p2p_segsum_or(const void* signal, const void* src, const void* local_dst,
                  const void* mask, void* out, int n_shards,
                  int rows_per_shard, int width, int block,
                  int64_t bucket_stride, int64_t signal_stride, int device,
                  void* stream) {
  return segsum<p2p::OrOp>(signal, src, local_dst, mask, out, n_shards,
                           rows_per_shard, width, block, bucket_stride,
                           signal_stride, device, stream);
}

int p2p_segsum_sum(const void* signal, const void* src, const void* local_dst,
                   const void* mask, void* out, int n_shards,
                   int rows_per_shard, int width, int block,
                   int64_t bucket_stride, int64_t signal_stride, int device,
                   void* stream) {
  return segsum<p2p::SumOp>(signal, src, local_dst, mask, out, n_shards,
                            rows_per_shard, width, block, bucket_stride,
                            signal_stride, device, stream);
}

}  // extern "C"
