// Random bits by threefry2x32 for Hopper (sm_90a).
//
// Not the counterpart of a TPU kernel: the JAX package's random numbers
// come from jax.random, whose threefry2x32 XLA fuses into one pass. The
// port draws the same bits (prng.py) and needs that pass as a kernel, or
// every draw is ~150 elementwise torch launches (ops/threefry.py).
//
// One thread per counter index i (a grid-stride loop past the grid):
//
//   (x0, x1) = threefry2x32((k0, k1), (i >> 32, i & 0xffffffff))
//   bits[i]  = x0 ^ x1
//
// which is jax 0.9.0's _threefry_random_bits_partitionable
// (jax/_src/prng.py). The uniform entry applies jax's f32 epilogue
// (random.py::_uniform) before the store: the top 23 bits as a mantissa in
// [1, 2), minus 1, then fma(f, scale, minval) (XLA contracts the multiply
// and the add on the CPU, so the reference rounds once), then
// max(minval, .).
//
// What bounds it: 68 integer instructions per counter (20 rounds of add,
// rotate, xor; the key-injection adds, most folded into three-input adds)
// against one 4-byte store. The 41 rotations and xors run only on the ALU
// pipe, 64 lanes per SM per clock, so that pipe bounds it, not memory.
// Rotations are one funnel shift each. The key words arrive as kernel
// arguments; nothing is read from memory.
//
// Plain C interface for ctypes; each entry returns the launch's CUDA error
// code.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// Enough blocks to fill 132 SMs many times over; larger draws loop.
constexpr int64_t kMaxBlocks = 132 * 32;

__device__ __forceinline__ void mix(uint32_t& x0, uint32_t& x1, int r) {
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, r) ^ x0;
}

__device__ __forceinline__ uint32_t threefry_xor(uint32_t k0, uint32_t k1,
                                                 uint32_t k2, uint32_t hi,
                                                 uint32_t lo) {
  uint32_t x0 = hi + k0, x1 = lo + k1;
  mix(x0, x1, 13); mix(x0, x1, 15); mix(x0, x1, 26); mix(x0, x1, 6);
  x0 += k1; x1 += k2 + 1u;
  mix(x0, x1, 17); mix(x0, x1, 29); mix(x0, x1, 16); mix(x0, x1, 24);
  x0 += k2; x1 += k0 + 2u;
  mix(x0, x1, 13); mix(x0, x1, 15); mix(x0, x1, 26); mix(x0, x1, 6);
  x0 += k0; x1 += k1 + 3u;
  mix(x0, x1, 17); mix(x0, x1, 29); mix(x0, x1, 16); mix(x0, x1, 24);
  x0 += k1; x1 += k2 + 4u;
  mix(x0, x1, 13); mix(x0, x1, 15); mix(x0, x1, 26); mix(x0, x1, 6);
  x0 += k2; x1 += k0 + 5u;
  return x0 ^ x1;
}

template <bool kUniform>
__global__ void __launch_bounds__(kThreads)
    threefry_kernel(uint32_t k0, uint32_t k1, int64_t n, float minval,
                    float scale, void* __restrict__ out) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride) {
    const uint32_t bits = threefry_xor(
        k0, k1, k2, static_cast<uint32_t>(static_cast<uint64_t>(i) >> 32),
        static_cast<uint32_t>(i));
    if constexpr (kUniform) {
      const float f = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
      static_cast<float*>(out)[i] = fmaxf(minval, __fmaf_rn(f, scale, minval));
    } else {
      static_cast<uint32_t*>(out)[i] = bits;
    }
  }
}

template <bool kUniform>
int launch(uint32_t k0, uint32_t k1, int64_t n, float minval, float scale,
           void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  threefry_kernel<kUniform>
      <<<static_cast<int>(blocks), kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(k0, k1, n, minval, scale, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int p2p_threefry_bits(uint32_t k0, uint32_t k1, int64_t n, void* out,
                      int device, void* stream) {
  return launch<false>(k0, k1, n, 0.0f, 1.0f, out, device, stream);
}

int p2p_threefry_uniform(uint32_t k0, uint32_t k1, int64_t n, float minval,
                         float scale, void* out, int device, void* stream) {
  return launch<true>(k0, k1, n, minval, scale, out, device, stream);
}

}  // extern "C"
