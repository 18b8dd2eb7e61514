// Random bits by threefry2x32 for Hopper (sm_90a).
//
// Not the counterpart of a TPU kernel: the JAX package's random numbers
// come from jax.random, whose threefry2x32 XLA fuses into one pass. The
// port draws the same bits (prng.py) and needs that pass as a kernel, or
// every draw is ~150 elementwise torch launches (ops/threefry.py).
//
// For each counter c of a launch (c = offset + e, e < n, all with the same
// high word: ops/threefry.py splits a draw at multiples of 2^32):
//
//   (x0, x1) = threefry2x32((k0, k1), (c >> 32, c & 0xffffffff))
//   bits[e]  = x0 ^ x1
//
// which is jax 0.9.0's _threefry_random_bits_partitionable
// (jax/_src/prng.py). The uniform entry applies jax's f32 epilogue
// (random.py::_uniform) before the store: the top 23 bits as a mantissa in
// [1, 2), minus 1, then fma(f, scale, minval) (XLA contracts the multiply
// and the add on the CPU, so the reference rounds once), then
// max(minval, .).
//
// What bounds it: integer work, against one 4-byte store per counter. The
// 20 rotations (one funnel shift each) and 21 xors run only on the ALU
// pipe, 64 lanes per SM per clock; the adds may run there (IADD3) or, as
// IMADs, on the FMA pipe's 64 integer lanes. The first design paid an
// int64 grid-stride index per counter, left 53 of its loop's 75
// instructions on the ALU pipe, and ran a 1M draw as 3,907 short blocks in
// ~3.7 waves: 28% of the ALU pipe's bound, under a launch floor that is
// more than half of its time. This one:
//
//   * hashes kPerThread consecutive counters a thread as interleaved
//     independent chains, and stores them with one 16-byte store (scalar
//     threads take the < 4 counters before the first aligned group and
//     after the last);
//   * in that loop, adds by mad.lo.u32 with a multiplier `one` that the
//     launch passes as 1, so that ptxas cannot fold it into an IADD3:
//     every add is an IMAD, and only the rotations, xors and loop control
//     reach the ALU pipe (41.75 a counter). That costs 4 adds a counter
//     that three-input IADD3s would fold, and the FMA pipe's integer
//     lanes do not run fully beside the ALU's, so it gains ~3% on the 1M
//     draw, not the 9% of the ALU counts (an IMAD.HI for the uniform's
//     shift-or lost more than it gained, so that stays a LEA.HI);
//   * keeps counters 32-bit: the high word and the first low word are
//     launch arguments, so x0's seed is one value for the whole launch;
//   * launches one persistent wave: SMs x resident blocks, fewer when the
//     draw needs fewer;
//   * takes a counter a thread, with ptxas's own adds, for a draw that one
//     wave of such threads holds (the walk's 4,096 restarts, gossip's
//     100,096): there each thread's chain is the critical path, and four
//     chains a thread or IMAD adds (a longer latency than IADD3's) only
//     lengthen it.
//
// Plain C interface for ctypes; each entry returns the launch's CUDA error
// code.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// Counters a thread hashes per pass (ops/threefry.py COUNTERS_PER_THREAD).
constexpr int kPerThread = 4;
constexpr int kMaxDevices = 64;

// x + y. With kMad, as x * one + y (`one` is 1, unknown to the
// compiler): an IMAD, which ptxas cannot fold into a three-input IADD3.
template <bool kMad>
__device__ __forceinline__ uint32_t add(uint32_t x, uint32_t y,
                                        uint32_t one) {
  if constexpr (!kMad) return x + y;
  uint32_t r;
  asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(x), "r"(one), "r"(y));
  return r;
}

struct Key {
  uint32_t k0, k1, k2, one;
};

template <bool kMad, int N>
__device__ __forceinline__ void mix(uint32_t (&x0)[N], uint32_t (&x1)[N],
                                    int r, uint32_t one) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    x0[i] = add<kMad>(x1[i], x0[i], one);
    x1[i] = __funnelshift_l(x1[i], x1[i], r) ^ x0[i];
  }
}

template <bool kMad, int N>
__device__ __forceinline__ void inject(uint32_t (&x0)[N], uint32_t (&x1)[N],
                                       uint32_t a, uint32_t b, uint32_t one) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    x0[i] = add<kMad>(x0[i], a, one);
    x1[i] = add<kMad>(x1[i], b, one);
  }
}

// bits = x0 ^ x1 of threefry2x32 for N chains seeded (x0, x1) = (hi + k0,
// lo + k1).
template <bool kMad, int N>
__device__ __forceinline__ void threefry(uint32_t (&x0)[N],
                                         uint32_t (&x1)[N], const Key& k,
                                         uint32_t (&bits)[N]) {
  const uint32_t one = k.one;
  mix<kMad>(x0, x1, 13, one); mix<kMad>(x0, x1, 15, one);
  mix<kMad>(x0, x1, 26, one); mix<kMad>(x0, x1, 6, one);
  inject<kMad>(x0, x1, k.k1, k.k2 + 1u, one);
  mix<kMad>(x0, x1, 17, one); mix<kMad>(x0, x1, 29, one);
  mix<kMad>(x0, x1, 16, one); mix<kMad>(x0, x1, 24, one);
  inject<kMad>(x0, x1, k.k2, k.k0 + 2u, one);
  mix<kMad>(x0, x1, 13, one); mix<kMad>(x0, x1, 15, one);
  mix<kMad>(x0, x1, 26, one); mix<kMad>(x0, x1, 6, one);
  inject<kMad>(x0, x1, k.k0, k.k1 + 3u, one);
  mix<kMad>(x0, x1, 17, one); mix<kMad>(x0, x1, 29, one);
  mix<kMad>(x0, x1, 16, one); mix<kMad>(x0, x1, 24, one);
  inject<kMad>(x0, x1, k.k1, k.k2 + 4u, one);
  mix<kMad>(x0, x1, 13, one); mix<kMad>(x0, x1, 15, one);
  mix<kMad>(x0, x1, 26, one); mix<kMad>(x0, x1, 6, one);
  inject<kMad>(x0, x1, k.k2, k.k0 + 5u, one);
#pragma unroll
  for (int i = 0; i < N; ++i) bits[i] = x0[i] ^ x1[i];
}

// jax's f32 uniform of 32 random bits (see the file comment).
__device__ __forceinline__ float uniform(uint32_t bits, float minval,
                                         float scale) {
  const float f = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  return fmaxf(minval, __fmaf_rn(f, scale, minval));
}

// Counters lo + e of high word hi into out[e], e < head + kPer * groups +
// tail: kPer a thread from e = head, the head and tail (kPer = 4 only; out
// + head is 16-byte aligned and a pass stores one vector) one a thread.
template <bool kUniform, int kPer>
__global__ void __launch_bounds__(kThreads)
    threefry_kernel(uint32_t k0, uint32_t k1, uint32_t hi, uint32_t lo,
                    uint32_t head, uint32_t groups, uint32_t tail,
                    float minval, float scale, uint32_t one,
                    void* __restrict__ out) {
  static_assert(kPer == 1 || kPer == 4, "a scalar or a 16-byte store");
  // The adds as IMADs where the loop's throughput counts (kPer = 4); a
  // counter a thread is bound by its chain's latency, where ptxas's own
  // mix of IADD3 and IMAD.IADD is shorter.
  constexpr bool kMad = kPer > 1;
  const Key k{k0, k1, k0 ^ k1 ^ 0x1BD11BDAu, one};
  const uint32_t seed0 = hi + k0;
  // x1's seed of element e is lo + k1 + e.
  const uint32_t seed1 = lo + k1;
  const uint32_t per = one * kPer;
  const uint32_t gid = blockIdx.x * blockDim.x + threadIdx.x;
  const uint32_t stride = gridDim.x * blockDim.x;
#pragma unroll 1
  for (uint32_t g = gid; g < groups; g += stride) {
    uint32_t x0[kPer], x1[kPer], bits[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      x0[i] = seed0;
      // lo + k1 + head + kPer g + i
      x1[i] = kMad ? add<true>(g, seed1 + head + i, per)
                   : g * kPer + (seed1 + head + i);
    }
    threefry<kMad>(x0, x1, k, bits);
    const size_t at = head + static_cast<size_t>(g) * kPer;
    if constexpr (kPer == 1) {
      if constexpr (kUniform) {
        static_cast<float*>(out)[at] = uniform(bits[0], minval, scale);
      } else {
        static_cast<uint32_t*>(out)[at] = bits[0];
      }
    } else if constexpr (kUniform) {
      float4 v;
      v.x = uniform(bits[0], minval, scale);
      v.y = uniform(bits[1], minval, scale);
      v.z = uniform(bits[2], minval, scale);
      v.w = uniform(bits[3], minval, scale);
      *reinterpret_cast<float4*>(static_cast<float*>(out) + at) = v;
    } else {
      *reinterpret_cast<uint4*>(static_cast<uint32_t*>(out) + at) =
          make_uint4(bits[0], bits[1], bits[2], bits[3]);
    }
  }
  if constexpr (kPer == 1) return;
  // The head's and the tail's counters, one a thread.
#pragma unroll
  for (int part = 0; part < 2; ++part) {
    const uint32_t count = part == 0 ? head : tail;
    if (gid >= count) continue;
    const uint32_t e = (part == 0 ? 0u : head + groups * kPer) + gid;
    uint32_t x0[1] = {seed0}, x1[1] = {seed1 + e}, bits[1];
    threefry<false>(x0, x1, k, bits);
    if constexpr (kUniform) {
      static_cast<float*>(out)[e] = uniform(bits[0], minval, scale);
    } else {
      static_cast<uint32_t*>(out)[e] = bits[0];
    }
  }
}

// SMs and resident blocks per SM of threefry_kernel<kUniform, kPer>, per
// device.
template <bool kUniform, int kPer>
cudaError_t residency(int device, int* sms, int* per_sm) {
  static int cached[kMaxDevices][2];
  const bool cache = device >= 0 && device < kMaxDevices;
  if (cache && cached[device][0] > 0) {
    *sms = cached[device][0];
    *per_sm = cached[device][1];
    return cudaSuccess;
  }
  cudaError_t err =
      cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, threefry_kernel<kUniform, kPer>, kThreads, 0);
  if (err != cudaSuccess) return err;
  if (*per_sm < 1) *per_sm = 1;
  if (cache) {
    cached[device][1] = *per_sm;
    cached[device][0] = *sms;
  }
  return cudaSuccess;
}

// n counters from `offset` (whose low word plus n stays within 2^32) into
// out[0, n). A draw that one wave of a counter a thread holds takes that
// (each thread's chain is short, and a small draw leaves SMs idle); a
// larger one kPerThread a thread in one persistent wave.
template <bool kUniform>
int launch(uint32_t k0, uint32_t k1, uint64_t offset, int64_t n,
           float minval, float scale, void* out, int device, void* stream) {
  const uint32_t lo = static_cast<uint32_t>(offset);
  if (n < 1 || static_cast<uint64_t>(lo) + static_cast<uint64_t>(n) >
                   (uint64_t{1} << 32))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0, per_sm = 0;
  err = residency<kUniform, 1>(device, &sms, &per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t hi = static_cast<uint32_t>(offset >> 32);
  if (n <= static_cast<int64_t>(sms) * per_sm * kThreads) {
    threefry_kernel<kUniform, 1>
        <<<static_cast<unsigned>((n + kThreads - 1) / kThreads), kThreads, 0,
           s>>>(k0, k1, hi, lo, 0u, static_cast<uint32_t>(n), 0u, minval,
                scale, 1u, out);
    return static_cast<int>(cudaGetLastError());
  }
  err = residency<kUniform, kPerThread>(device, &sms, &per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Elements before out's first 16-byte boundary (out is 4-byte aligned).
  const int64_t head =
      ((16 - (reinterpret_cast<uintptr_t>(out) & 15)) & 15) / 4;
  const int64_t groups = (n - head) / kPerThread;
  const int64_t tail = n - head - groups * kPerThread;
  const int64_t wave = static_cast<int64_t>(sms) * per_sm;
  int64_t blocks = (groups + kThreads - 1) / kThreads;
  if (blocks > wave) blocks = wave;
  threefry_kernel<kUniform, kPerThread>
      <<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(k0, k1, hi, lo, static_cast<uint32_t>(head),
              static_cast<uint32_t>(groups), static_cast<uint32_t>(tail),
              minval, scale, 1u, out);
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel: chip_smoke.py and tools/kernel_times.py time it as the
// launch floor under their timing, the part of a short kernel's time that
// no design of its body removes.
__global__ void noop_kernel() {}

}  // namespace

extern "C" {

int p2p_threefry_bits(uint32_t k0, uint32_t k1, uint64_t offset, int64_t n,
                      void* out, int device, void* stream) {
  return launch<false>(k0, k1, offset, n, 0.0f, 1.0f, out, device, stream);
}

int p2p_threefry_uniform(uint32_t k0, uint32_t k1, uint64_t offset,
                         int64_t n, float minval, float scale, void* out,
                         int device, void* stream) {
  return launch<true>(k0, k1, offset, n, minval, scale, out, device, stream);
}

int p2p_noop(int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  noop_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
