// Row sums of f32 terms in XLA's CPU order of adds, for Hopper (sm_90a).
//
// Not the counterpart of a TPU kernel: the JAX package's `gather` and
// `skew` sums (jnp.sum over a row of gathered terms) and its 1-D sums are
// XLA reduces, and the port must add in their order to give their bits
// (ops/rowsum.py). That order, for a row of w terms:
//
//   w == 1:  the term itself (no add: a -0 stays -0);
//   w <= 32: left to right from +0;
//   w >  32: front-padded with zeros to whole windows of 32, each window
//            summed left to right from +0, and the window sums reduced
//            the same way (recursively).
//
// A zero added to an accumulator that is still +0 leaves it +0, so the
// padding is skipped, not added. Rows of <= 32 terms (and of more than
// 1,024) are summed by one thread each; rows of 33 to 1,024 by one lane a
// window and shuffles for the window sums (window_kernel), so a wide row's
// chain of dependent adds is 32 + ceil(w / 32) long, not w. Every add is
// __fadd_rn (and the gather entry's mask product __fmul_rn), so nvcc
// cannot contract a product and a sum into one fma and the bits stay
// XLA's. The plain version takes one torch launch per column of a window.
//
// What bounds it: each term is one 4-byte read (the gather entry: a 4-byte
// index, a mask byte and a 4-byte gather) and one add, so memory does.
//
// Plain C interface for ctypes; each entry returns the launch's CUDA error
// code.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// Enough blocks to fill 132 SMs many times over; more rows loop.
constexpr int64_t kMaxBlocks = 132 * 32;
constexpr int64_t kWindow = 32;
// Windowed levels a row may need: 32^7 terms, more than an int64 index
// of a real table reaches.
constexpr int kMaxLevels = 7;

// The sum of term(0) .. term(w - 1) in XLA's order (see the file comment),
// by one thread.
template <class Term>
__device__ __forceinline__ float ordered_sum(int64_t w, const Term& term) {
  if (w == 1) return term(0);
  if (w <= kWindow) {
    float acc = 0.0f;
    for (int64_t j = 0; j < w; ++j) acc = __fadd_rn(acc, term(j));
    return acc;
  }
  // Level l's items sit at pos[l] of its padded sequence; a completed
  // window carries its sum up one level. The top level has <= 32 items and
  // is summed whole.
  int64_t pos[kMaxLevels];
  float acc[kMaxLevels + 1];
  int levels = 0;
  for (int64_t n = w; n > kWindow; ++levels) {
    pos[levels] = (kWindow - n % kWindow) % kWindow;
    n = (n + pos[levels]) / kWindow;
  }
  for (int l = 0; l <= levels; ++l) acc[l] = 0.0f;
  for (int64_t j = 0; j < w; ++j) {
    float x = term(j);
    for (int l = 0;; ++l) {
      acc[l] = __fadd_rn(acc[l], x);
      if (l == levels || pos[l]++ % kWindow != kWindow - 1) break;
      x = acc[l];
      acc[l] = 0.0f;
    }
  }
  return acc[levels];
}

// Term (r, c) of a dense [rows, w] table.
struct Dense {
  const float* __restrict__ vals;
  int64_t w;
  __device__ __forceinline__ float operator()(int64_t r, int64_t c) const {
    return vals[r * w + c];
  }
};

// Term (r, c) of a gathered row: signal[idx] * f32(mask). A masked-out
// term is x * 0 (+-0, or NaN for an infinite x), as the plain product.
struct Gathered {
  const float* __restrict__ signal;
  const int32_t* __restrict__ idx;
  const bool* __restrict__ mask;
  int64_t w;
  __device__ __forceinline__ float operator()(int64_t r, int64_t c) const {
    const int64_t i = r * w + c;
    const float x = signal[idx[i]];
    return mask[i] ? x : __fmul_rn(x, 0.0f);
  }
};

// One thread a row: rows of <= 32 terms, and rows of more than 1,024.
template <class Load>
__global__ void __launch_bounds__(kThreads)
    row_kernel(Load load, int64_t rows, int64_t w, float* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       r < rows; r += stride) {
    out[r] = ordered_sum(w, [&](int64_t c) { return load(r, c); });
  }
}

// Rows of 33 to 1,024 terms, the two-level order: n = ceil(w / 32) windows
// a row, one lane a window, 32 / n rows a warp. Each lane adds its window
// from +0 (the front padding is window 0's head); then every lane of a row
// adds the row's n window sums in order from +0 through shuffles, and the
// lane of window 0 stores the sum. The dependent chain is 32 + n adds, not
// w.
template <class Load>
__global__ void __launch_bounds__(kThreads)
    window_kernel(Load load, int64_t rows, int64_t w,
                  float* __restrict__ out) {
  const int n = static_cast<int>((w + kWindow - 1) / kWindow);
  const int64_t pad = n * kWindow - w;
  const int per_warp = kWindow / n;
  const int lane = threadIdx.x % kWindow;
  const int sub = lane / n, k = lane % n;
  const bool active = sub < per_warp;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / kWindow;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kThreads / kWindow;
  for (int64_t base = warp * per_warp; base < rows;
       base += warps * per_warp) {
    const int64_t r = base + sub;
    float window = 0.0f;
    if (active && r < rows) {
      const int64_t hi = k * kWindow - pad + kWindow;
      for (int64_t c = k == 0 ? 0 : hi - kWindow; c < hi; ++c)
        window = __fadd_rn(window, load(r, c));
    }
    float sum = 0.0f;
    for (int j = 0; j < n; ++j)
      sum = __fadd_rn(sum, __shfl_sync(0xffffffffu, window, sub * n + j));
    if (active && k == 0 && r < rows) out[r] = sum;
  }
}

int blocks_for(int64_t threads) {
  int64_t blocks = (threads + kThreads - 1) / kThreads;
  return static_cast<int>(blocks > kMaxBlocks ? kMaxBlocks : blocks);
}

template <class Load>
int launch(const Load& load, int64_t rows, int64_t w, float* out, int device,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w > kWindow && w <= kWindow * kWindow) {
    const int64_t per_warp = kWindow / ((w + kWindow - 1) / kWindow);
    const int64_t warps = (rows + per_warp - 1) / per_warp;
    window_kernel<<<blocks_for(warps * kWindow), kThreads, 0, s>>>(
        load, rows, w, out);
  } else {
    row_kernel<<<blocks_for(rows), kThreads, 0, s>>>(load, rows, w, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int p2p_row_sum_f32(const float* vals, int64_t rows, int64_t width,
                    float* out, int device, void* stream) {
  return launch(Dense{vals, width}, rows, width, out, device, stream);
}

int p2p_gather_row_sum_f32(const float* signal, const int32_t* idx,
                           const bool* mask, int64_t rows, int64_t width,
                           float* out, int device, void* stream) {
  return launch(Gathered{signal, idx, mask, width}, rows, width, out, device,
                stream);
}

}  // extern "C"
