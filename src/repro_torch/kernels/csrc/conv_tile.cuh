// Device code shared by the conv kernels: the shape of one launch
// (ConvShape), the float32 tap sum in the plain path's order (tap_add,
// tap_sum), the asynchronous copies to shared memory (cp.async), and
// allow_smem.  Kernel A (spiking_conv.cu) sums its taps with tap_add;
// kernels B and C (spiking_conv_lif.cu, through mma_tile.cuh) take tap_sum
// for a (block, step) whose input is not all 0 and 1.
//
// The tap order.  The plain path (core/snn_layers.py:conv2d on an analog
// input, then + bias) multiplies each input value by its weight, rounds,
// and adds the product to the running sum, rounds again: taps (dy, dx)
// row-major, input channels ci inside each tap, the first product being
// the sum's start, and the bias added last.  tap_add repeats exactly that
// with __fmul_rn and __fadd_rn, which nvcc never contracts into an FMA (it
// does contract a*b+c under its default --fmad=true).  A sum starts from
// -0.0f, the identity of IEEE addition (-0 + p == p for every p, -0
// included), so adding the first product gives the product itself.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace snn {

struct ConvShape {
  int H, W, Cin, Cout, R, pad_lo, E_h, E_w, BR;
  __host__ __device__ int w_pad() const { return E_w + R - 1; }
  __host__ __device__ int halo_rows() const { return BR + R - 1; }
  __host__ __device__ int cin_p() const { return Cin | 1; }
};

// The start of a tap sum (see the tap order above).
constexpr float kSumStart = -0.0f;

// acc + x * w, rounded twice, as the plain path rounds it.
__device__ __forceinline__ float tap_add(float acc, float x, float w) {
  return __fadd_rn(acc, __fmul_rn(x, w));
}

// The float32 tap sum of one output (y, x, channel co) of one (H, W, Cin)
// image, read from device memory, in the plain path's order (taps (dy, dx),
// then ci; zero outside the image), without the bias.  w is
// (R, R, Cin, Cout).
__device__ __forceinline__ float tap_sum(const float* __restrict__ img,
                                         const float* __restrict__ w,
                                         ConvShape s, int y, int x, int co) {
  float acc = kSumStart;
  for (int dy = 0; dy < s.R; ++dy) {
    const int iy = y + dy - s.pad_lo;
    for (int dx = 0; dx < s.R; ++dx) {
      const int ix = x + dx - s.pad_lo;
      const bool inside = iy >= 0 && iy < s.H && ix >= 0 && ix < s.W;
      const float* xp = img + ((size_t)iy * s.W + ix) * s.Cin;
      const float* wp = w + (size_t)(dy * s.R + dx) * s.Cin * s.Cout + co;
      for (int ci = 0; ci < s.Cin; ++ci)
        acc = tap_add(acc, inside ? __ldg(xp + ci) : 0.f,
                      __ldg(wp + (size_t)ci * s.Cout));
    }
  }
  return acc;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy 16 (or 4) bytes from device to shared memory asynchronously; with
// valid false the destination is filled with zeros and nothing is read.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The coordinates (row, col, q) of the units one thread visits in a
// (rows, cols, q4) array, unit u = u0, u0 + stride, ...: the divisions are
// made once, and each step adds the stride with carries.
struct Walk {
  int row, col, q, drow, dcol, dq, cols, q4;
  __device__ Walk(int u0, int stride, int cols_, int q4_)
      : cols(cols_), q4(q4_) {
    q = u0 % q4;
    col = u0 / q4 % cols;
    row = u0 / q4 / cols;
    dq = stride % q4;
    dcol = stride / q4 % cols;
    drow = stride / q4 / cols;
  }
  __device__ __forceinline__ void next() {
    q += dq;
    int carry = q >= q4;
    q -= carry * q4;
    col += dcol + carry;
    carry = col >= cols;
    col -= carry * cols;
    row += drow + carry;
  }
};

// Raise the block's dynamic shared-memory limit above the 48 KB default
// when the tile needs it.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace snn
