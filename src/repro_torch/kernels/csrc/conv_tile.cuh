// Device code of kernel A (spiking_conv.cu), the SIMT conv tile: the
// thread-block decomposition, the shared-memory staging of one row-block's
// halo and of the block's weight tile, and the fixed-order tap
// accumulation.  Shared with the tensor-core kernels (mma_tile.cuh): the
// shape (ConvShape), allow_smem, and tap_sum, the float32 path that kernels
// B and C take for a (block, step) whose input is not all 0 and 1.
//
// Decomposition.  One thread block per (image n, output row-block i, Cout
// tile g): grid (N, ceil(E_h / BR), ceil(Cout / CT)).  Thread t owns output
// pixel (i*BR + t / E_w, t % E_w) and the CT consecutive output channels
// [g*CT, g*CT + CT), masked at Cout.  Rows past E_h (the ragged last
// row-block) and channels past Cout are masked; the padding (APRC full or
// SAME) is never materialised: staging reads zero outside the input.
//
// Shared memory, in floats (the host mirrors this in plan_tiles):
//   ws  R*R*Cin*CT                      weights of the tile, [tap][ci][c]
//   xs  (BR+R-1) * W_pad * CinP          halo rows, [row][col][ci]
// with W_pad = E_w + R - 1 and CinP = Cin | 1: an odd pixel stride, so the
// 32 threads of a warp, which read one channel of 32 neighbouring pixels,
// hit 32 different banks.
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

template <int CT>
__host__ __device__ inline size_t smem_floats(const ConvShape& s) {
  return (size_t)s.R * s.R * s.Cin * CT +
         (size_t)s.halo_rows() * s.w_pad() * s.cin_p();
}

// Copy the block's Cout tile of the (R, R, Cin, Cout) weights into
// ws[(tap*Cin + ci)*CT + c], zero past Cout.
template <int CT>
__device__ __forceinline__ void stage_weights(float* ws,
                                              const float* __restrict__ w,
                                              ConvShape s, int c0) {
  const int n = s.R * s.R * s.Cin * CT;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int c = i % CT, k = i / CT, co = c0 + c;
    ws[i] = co < s.Cout ? w[(size_t)k * s.Cout + co] : 0.f;
  }
}

// Copy the halo rows feeding output row-block i of one (H, W, Cin) image
// into xs, zero outside the image.  Returns, to every thread of the block,
// the number of threads that staged a nonzero value: 0 exactly when the
// block's receptive field holds no spike (the skip test; nonzeros, not a
// value sum, so an analog frame is never skipped).  It is also the barrier
// after the staging.
__device__ __forceinline__ int stage_halo(float* xs,
                                          const float* __restrict__ img,
                                          ConvShape s, int i) {
  const int w_pad = s.w_pad(), cin_p = s.cin_p();
  const int n = s.halo_rows() * w_pad * s.Cin;
  const int row0 = i * s.BR - s.pad_lo;
  int nonzero = 0;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const int ci = k % s.Cin, pix = k / s.Cin;
    const int iy = row0 + pix / w_pad, ix = pix % w_pad - s.pad_lo;
    float v = 0.f;
    if (iy >= 0 && iy < s.H && ix >= 0 && ix < s.W)
      v = img[((size_t)iy * s.W + ix) * s.Cin + ci];
    xs[pix * cin_p + ci] = v;
    nonzero |= (v != 0.f);
  }
  return __syncthreads_count(nonzero);
}

// acc[c] += sum over taps (dy, dx) and input channels ci, in that fixed
// order, of x_pad[ly+dy, lx+dx, ci] * w[dy, dx, ci, c0+c].  The input
// value is read once and reused for the CT channels; the weights are read
// as float4 broadcasts (every thread of the block reads the same address).
template <int CT>
__device__ __forceinline__ void accumulate(float (&acc)[CT], const float* xs,
                                           const float* ws, ConvShape s,
                                           int ly, int lx) {
  static_assert(CT % 4 == 0, "cout tile must be a multiple of 4");
  const int w_pad = s.w_pad(), cin_p = s.cin_p();
  for (int dy = 0; dy < s.R; ++dy) {
    for (int dx = 0; dx < s.R; ++dx) {
      const float* xp = xs + ((ly + dy) * w_pad + (lx + dx)) * cin_p;
      const float4* wp =
          reinterpret_cast<const float4*>(ws + (dy * s.R + dx) * s.Cin * CT);
      for (int ci = 0; ci < s.Cin; ++ci) {
        const float xv = xp[ci];
#pragma unroll
        for (int q = 0; q < CT / 4; ++q) {
          const float4 wv = wp[ci * (CT / 4) + q];
          acc[4 * q + 0] = fmaf(xv, wv.x, acc[4 * q + 0]);
          acc[4 * q + 1] = fmaf(xv, wv.y, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(xv, wv.z, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(xv, wv.w, acc[4 * q + 3]);
        }
      }
    }
  }
}

// The float32 tap sum of one output (y, x, channel co) of one (H, W, Cin)
// image, read from device memory: the taps (dy, dx) and input channels ci
// in accumulate's order, one fmaf each, zero outside the image, so it
// gives accumulate's bits.  w is (R, R, Cin, Cout).
__device__ __forceinline__ float tap_sum(const float* __restrict__ img,
                                const float* __restrict__ w, ConvShape s,
                                int y, int x, int co) {
  float acc = 0.f;
  for (int dy = 0; dy < s.R; ++dy) {
    const int iy = y + dy - s.pad_lo;
    for (int dx = 0; dx < s.R; ++dx) {
      const int ix = x + dx - s.pad_lo;
      const bool inside = iy >= 0 && iy < s.H && ix >= 0 && ix < s.W;
      const float* xp = img + ((size_t)iy * s.W + ix) * s.Cin;
      const float* wp = w + (size_t)(dy * s.R + dx) * s.Cin * s.Cout + co;
      for (int ci = 0; ci < s.Cin; ++ci)
        acc = fmaf(inside ? __ldg(xp + ci) : 0.f,
                   __ldg(wp + (size_t)ci * s.Cout), acc);
    }
  }
  return acc;
}

// Write the CT values of one output pixel (channels c0.., masked at Cout):
// four float4 stores per 16 channels when the whole tile is in range and
// aligned, scalar stores otherwise.
template <int CT>
__device__ __forceinline__ void store_tile(float* dst, const float (&val)[CT],
                                           int c0, int Cout) {
  if (c0 + CT <= Cout && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
#pragma unroll
    for (int q = 0; q < CT / 4; ++q)
      reinterpret_cast<float4*>(dst)[q] =
          make_float4(val[4 * q], val[4 * q + 1], val[4 * q + 2],
                      val[4 * q + 3]);
  } else {
#pragma unroll
    for (int c = 0; c < CT; ++c)
      if (c0 + c < Cout) dst[c] = val[c];
  }
}

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
