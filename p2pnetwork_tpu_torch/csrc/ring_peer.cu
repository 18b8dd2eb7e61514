// Ring halo hop (kernel B2) and fused ring step (kernel B3) across ranks,
// for Hopper (sm_90a): the ring's shards split over processes, each rank
// holding n_local consecutive shards stacked on one card.
//
// Replaces p2pnetwork_tpu/ops/pallas_ring.py::_ring_halo_copy_kernel (B2)
// and ::_ring_halo_segsum_kernel (B3) where a hop crosses ranks. On the TPU
// a hop is an async remote copy from one chip's VMEM to the next chip's,
// with a send and a receive semaphore. Here the rank's local shards move by
// a device-local copy (shard d to d + 1, forward), and its boundary shard
// (the last, forward; the first, reverse) is written straight into the
// next (previous) rank's receive slot through a CUDA IPC mapping of that
// rank's memory: the same store reaches a peer card over NVLink or a peer
// process on the same card.
//
// The semaphores become flags in the receiver's memory (ops/ring.py,
// PeerChannel, allocates and maps them):
//   - two slots a direction, by step parity, so a sender may run one step
//     ahead of its receiver;
//   - arrival: the put kernel's last block to finish (an arrival counter)
//     stores the step's sequence number to the receiver's flag with a
//     system-scope release, after every block's stores and a system fence;
//   - landing: the receiver's stream waits until its flag shows the step
//     (cuStreamWaitValue32: the GPU's front end polls the flag, no kernel
//     spins, so ranks whose contexts time-slice one card still progress),
//     then the land kernel copies the slot into its row of the result
//     (loads that bypass L1: the slot was written by another context) and
//     its last block stores the step to the sender's acknowledgement flag;
//   - reuse: before the put of step seq the sender's stream waits until the
//     receiver has acknowledged step seq - 2, the last one that used the
//     same slot.
// Every wait is on the stream: a call returns at once, and a hop's order
// against the ring's other launches is the stream's.
//
// What bounds them on an H100. The put reads each byte of the rank's
// stack once and writes it once (locally or into the peer slot), the land
// reads and writes one shard: for the bool [4, 125008] stack 1.25 MB,
// ~0.37 us at 3.35 TB/s, so what a hop costs is its two launches, the two
// stream waits and, with ranks on one card, the contexts' time slices:
// there a hop took ~0.29 ms at 2 ranks and ~1.1 ms at 8, and ~0.24 ms
// with 16-byte shards (H100 80GB HBM3, 700 W; chip_smoke.py phase 4v,
// PERF.md), the hand-over between the ranks' contexts. The copies take
// 16-byte units where every buffer and the shard's bytes allow
// it (else 4 or 1), U of them a thread, the grid covering the payload.
// B3's form keeps ring.cu's structure: its first n_copy blocks are the put
// (only they count for the arrival), the rest the row workers of B1's
// segment sum (segsum.cuh), with kExtent rows where extents are given.
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

// B3 across ranks: n_copy put blocks (U = 4 units of `unit` bytes), then
// the row workers of path P (`extent` read only on kExtent).
constexpr int kCopyUnits = 4;

__device__ __forceinline__ void put_units(const void* src, void* dst,
                                          void* peer, int64_t per_units,
                                          int unit, int n_local,
                                          int64_t tile) {
  switch (unit) {
    case 16:
      put_tile<uint4, kCopyUnits>(static_cast<const uint4*>(src),
                                  static_cast<uint4*>(dst),
                                  static_cast<uint4*>(peer), per_units,
                                  n_local, 0, tile);
      break;
    case 4:
      put_tile<uint32_t, kCopyUnits>(static_cast<const uint32_t*>(src),
                                     static_cast<uint32_t*>(dst),
                                     static_cast<uint32_t*>(peer), per_units,
                                     n_local, 0, tile);
      break;
    default:
      put_tile<uint8_t, kCopyUnits>(static_cast<const uint8_t*>(src),
                                    static_cast<uint8_t*>(dst),
                                    static_cast<uint8_t*>(peer), per_units,
                                    n_local, 0, tile);
  }
}

template <class Op, p2p::Path P>
__global__ void __launch_bounds__(p2p::kThreads, p2p::kMinBlocks)
    ring_put_segsum_kernel(const typename Op::T* __restrict__ rot,
                           typename Op::T* __restrict__ rot_next, void* peer,
                           int64_t per_units, int unit, int n_copy,
                           Signal sig, const int32_t* __restrict__ src,
                           const int32_t* __restrict__ local_dst,
                           const uint8_t* __restrict__ mask,
                           const int32_t* __restrict__ extent,
                           typename Op::T* __restrict__ out, p2p::Rows g) {
  extern __shared__ __align__(16) unsigned char smem[];
  if (static_cast<int>(blockIdx.x) < n_copy) {
    put_units(rot, rot_next, peer, per_units, unit, g.n_shards, blockIdx.x);
    arrive(sig);
    return;
  }
  p2p::run_rows<Op, P>(rot, src, local_dst, mask, out, g, blockIdx.x - n_copy,
                       gridDim.x - n_copy, smem);
}

template <class Op>
__global__ void __launch_bounds__(p2p::kThreads, p2p::kExtentMinBlocks)
    ring_put_segsum_runs_kernel(const typename Op::T* __restrict__ rot,
                                typename Op::T* __restrict__ rot_next,
                                void* peer, int64_t per_units, int unit,
                                int n_copy, Signal sig,
                                const int32_t* __restrict__ src,
                                const int32_t* __restrict__ local_dst,
                                const uint8_t* __restrict__ mask,
                                const int32_t* __restrict__ extent,
                                typename Op::T* __restrict__ out,
                                p2p::Rows g) {
  extern __shared__ __align__(16) unsigned char smem[];
  if (static_cast<int>(blockIdx.x) < n_copy) {
    put_units(rot, rot_next, peer, per_units, unit, g.n_shards, blockIdx.x);
    arrive(sig);
    return;
  }
  p2p::run_rows_extent<Op>(rot, src, local_dst, mask, extent, out, g,
                           blockIdx.x - n_copy, gridDim.x - n_copy, smem);
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

// The land of a fused step: forward, into row 0.
int land_forward(void* own_slot, void* rot_next, int64_t shard_bytes,
                 int unit, const Signal& land, cudaStream_t s) {
  Signal l = land;
  switch (unit) {
    case 16:
      l.blocks = static_cast<uint32_t>(tiles(shard_bytes / 16, 1));
      ring_land_kernel<uint4, 1><<<l.blocks, p2p::kThreads, 0, s>>>(
          static_cast<const uint4*>(own_slot),
          static_cast<uint4*>(rot_next), shard_bytes / 16, l);
      break;
    case 4:
      l.blocks = static_cast<uint32_t>(tiles(shard_bytes / 4, 1));
      ring_land_kernel<uint32_t, 1><<<l.blocks, p2p::kThreads, 0, s>>>(
          static_cast<const uint32_t*>(own_slot),
          static_cast<uint32_t*>(rot_next), shard_bytes / 4, l);
      break;
    default:
      l.blocks = static_cast<uint32_t>(tiles(shard_bytes, 1));
      ring_land_kernel<uint8_t, 1><<<l.blocks, p2p::kThreads, 0, s>>>(
          static_cast<const uint8_t*>(own_slot),
          static_cast<uint8_t*>(rot_next), shard_bytes, l);
  }
  return static_cast<int>(cudaGetLastError());
}

template <class Op, p2p::Path P>
constexpr auto put_segsum_kernel_of() {
  if constexpr (P == p2p::kExtent) {
    return ring_put_segsum_runs_kernel<Op>;
  } else {
    return ring_put_segsum_kernel<Op, P>;
  }
}

template <class Op, p2p::Path P>
int launch_put_segsum(const void* rot, void* rot_next, void* peer_slot,
                      int64_t per_units, int unit, const Signal& put,
                      const void* src, const void* local_dst,
                      const void* mask, const void* extent, void* out,
                      const p2p::Rows& g, size_t smem, int device,
                      cudaStream_t stream) {
  using T = typename Op::T;
  const auto kernel = put_segsum_kernel_of<Op, P>();
  static p2p::Residency residency;  // one per kernel instantiation
  int resident = 0;
  const cudaError_t err = residency.blocks(
      reinterpret_cast<const void*>(kernel), smem, device, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_copy =
      static_cast<int>(tiles(per_units * g.n_shards, kCopyUnits));
  Signal p = put;
  p.blocks = static_cast<uint32_t>(n_copy);
  const int grid = n_copy + p2p::row_workers(g, resident);
  kernel<<<grid, p2p::kThreads, smem, stream>>>(
      static_cast<const T*>(rot), static_cast<T*>(rot_next), peer_slot,
      per_units, unit, n_copy, p, static_cast<const int32_t*>(src),
      static_cast<const int32_t*>(local_dst),
      static_cast<const uint8_t*>(mask), static_cast<const int32_t*>(extent),
      static_cast<T*>(out), g);
  return static_cast<int>(cudaGetLastError());
}

// B3 across ranks: wait for the slot, the fused launch (the put in its
// copy blocks, B1's rows in the rest), wait for the arrival, land.
template <class Op>
int ring_put_segsum(const void* rot, void* rot_next, int64_t signal_stride,
                    const void* src, const void* local_dst, const void* mask,
                    const void* extent, int64_t extent_stride, void* out,
                    int n_local, int rows_per_shard, int width, int block,
                    int64_t bucket_stride, uint32_t seq, void* own,
                    void* down, void* up, int64_t slot_bytes, int device,
                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int elem = sizeof(typename Op::T);
  const int64_t shard_bytes = signal_stride * static_cast<int64_t>(elem);
  const int unit = vec_bytes(rot, rot_next, shard_bytes);
  if (seq > 2) {
    const int rc = wait_value(s, word(own, kAckFlag), seq - 2);
    if (rc != 0) return rc;
  }
  const Signal put{word(own, kPutCount), word(down, kRecvFlag), seq, 0};
  void* peer_slot = slot(down, 0, seq, slot_bytes);
  const p2p::Path path =
      extent != nullptr && p2p::choose_extent(src, local_dst, mask, width,
                                              bucket_stride, block, elem)
          ? p2p::kExtent
          : p2p::choose_path(Op::kOr, src, local_dst, mask, width,
                             bucket_stride);
  size_t smem = 0;
  p2p::Rows g =
      p2p::plan_rows(path, elem, n_local, rows_per_shard, width, block,
                     bucket_stride, signal_stride, out, &smem);
  g.extent_stride = extent_stride;
  auto launch = [&](auto p) {
    return launch_put_segsum<Op, decltype(p)::value>(
        rot, rot_next, peer_slot, shard_bytes / unit, unit, put, src,
        local_dst, mask, extent, out, g, smem, device, s);
  };
  int rc = path == p2p::kExtent
               ? launch(std::integral_constant<p2p::Path, p2p::kExtent>())
               : p2p::dispatch<Op>(path, launch);
  if (rc != 0) return rc;
  rc = wait_value(s, word(own, kRecvFlag), seq);
  if (rc != 0) return rc;
  const Signal land{word(own, kLandCount), word(up, kAckFlag), seq, 0};
  return land_forward(slot(own, 0, seq, slot_bytes), rot_next, shard_bytes,
                      unit, land, s);
}

}  // namespace

extern "C" {

// This rank's receive area, zeroed, and its IPC handle (64 bytes).
int p2p_peer_alloc(int64_t slot_bytes, int device, void** area,
                   char* handle) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t bytes = static_cast<size_t>(kHeaderBytes + 4 * slot_bytes);
  err = cudaMalloc(area, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemset(*area, 0, bytes);
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

int p2p_ring_put_segsum_or(const void* rot, void* rot_next,
                           int64_t signal_stride, const void* src,
                           const void* local_dst, const void* mask,
                           const void* extent, int64_t extent_stride,
                           void* out, int n_local, int rows_per_shard,
                           int width, int block, int64_t bucket_stride,
                           uint32_t seq, void* own, void* down, void* up,
                           int64_t slot_bytes, int device, void* stream) {
  return ring_put_segsum<p2p::OrOp>(
      rot, rot_next, signal_stride, src, local_dst, mask, extent,
      extent_stride, out, n_local, rows_per_shard, width, block,
      bucket_stride, seq, own, down, up, slot_bytes, device, stream);
}

int p2p_ring_put_segsum_sum(const void* rot, void* rot_next,
                            int64_t signal_stride, const void* src,
                            const void* local_dst, const void* mask,
                            const void* extent, int64_t extent_stride,
                            void* out, int n_local, int rows_per_shard,
                            int width, int block, int64_t bucket_stride,
                            uint32_t seq, void* own, void* down, void* up,
                            int64_t slot_bytes, int device, void* stream) {
  return ring_put_segsum<p2p::SumOp>(
      rot, rot_next, signal_stride, src, local_dst, mask, extent,
      extent_stride, out, n_local, rows_per_shard, width, block,
      bucket_stride, seq, own, down, up, slot_bytes, device, stream);
}

}  // extern "C"
