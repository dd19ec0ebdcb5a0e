// Input gradient of the spiking conv for Hopper (sm_90a): dx from the
// cotangent g of the conv output dV.
//
// Replaces the TPU kernel repro/kernels/spiking_conv.py:
// conv_grad_input_pallas (kernel body _make_grad_input_kernel).  The
// transpose of the forward conv (pads lo, hi) is itself a conv of g with the
// flipped, channel-swapped taps
//   wt[dy, dx, co, ci] = w[R-1-dy, R-1-dx, ci, co]
// under pads (R-1-lo, R-1-hi): none for APRC's full conv (a VALID conv),
// swapped for SAME.  No bias, and nothing is carried over T: the caller
// folds T x batch into N.
//
// So the kernel is the forward's implicit GEMM (conv_tile.cuh) with the
// roles swapped: the halo stages g with pad_lo' = R-1-lo, and the weight
// tile is staged from the forward (R, R, Cin, Cout) weights read as
// w[R-1-dy, R-1-dx, co, ci], with the block's channel tile running over the
// forward's Cin.  A block whose staged cotangent is all zero writes zeros
// without the taps (its dx is exactly zero).  Sums run in one fixed order
// per output, with no atomics.
//
// On the main path it runs the backward of snn-mnist layers 2 and 1
// (N = T * B = 8 * 256, float32, NHWC):
//   layer 2  g (2048, 34, 34, 8)  -> dx (2048, 32, 32, 32)
//   layer 1  g (2048, 32, 32, 32) -> dx (2048, 30, 30, 16)
// What bounds it on the H100 (each input byte read once, each output byte
// written once, FLOPs of all taps): layer 2 344 MB and 9.66 GFLOP, layer 1
// 386 MB and 16.99 GFLOP, so 0.10 against 0.14 ms and 0.12 against 0.25 ms:
// both bound by float32 arithmetic, as the forward is, and fed the same
// way: each thread owns one output pixel and CT channels, reuses each
// staged cotangent value from a register for its CT channels, and reads
// the weights as float4 broadcasts.  Layer 1's tile (E_w = 30, Cin' = 32,
// CT = 16) needs 60 KB of shared memory, over the 48 KB default, so the
// launch raises the block's limit (allow_smem).
#include "conv_tile.cuh"

namespace {

// Copy the block's tile of the transposed taps into
// ws[(tap*Cin + ci)*CT + c] = w[R*R-1-tap][c0+c][ci], zero past Cout.  In
// the backward's terms (s): Cin is the forward's Cout (the summed axis)
// and Cout the forward's Cin (the output axis); w is the forward's
// (R, R, s.Cout, s.Cin) array.
template <int CT>
__device__ __forceinline__ void stage_transposed_weights(
    float* ws, const float* __restrict__ w, snn::ConvShape s, int c0) {
  const int taps = s.R * s.R, n = taps * s.Cin * CT;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int c = i % CT, k = i / CT, ci = k % s.Cin, tap = k / s.Cin;
    const int co = c0 + c;
    ws[i] = co < s.Cout
                ? w[((size_t)(taps - 1 - tap) * s.Cout + co) * s.Cin + ci]
                : 0.f;
  }
}

template <int CT>
__global__ void __launch_bounds__(512)
conv_grad_input_kernel(const float* __restrict__ g,
                       const float* __restrict__ w, float* __restrict__ dx,
                       snn::ConvShape s) {
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);
  float* xs = ws + (size_t)s.R * s.R * s.Cin * CT;
  const int n = blockIdx.x, i = blockIdx.y, c0 = blockIdx.z * CT;

  stage_transposed_weights<CT>(ws, w, s, c0);
  const int nonzero =
      snn::stage_halo(xs, g + (size_t)n * s.H * s.W * s.Cin, s, i);

  const int ly = threadIdx.x / s.E_w, lx = threadIdx.x % s.E_w;
  const int y = i * s.BR + ly;
  if (ly >= s.BR || y >= s.E_h) return;

  float acc[CT];
#pragma unroll
  for (int c = 0; c < CT; ++c) acc[c] = 0.f;
  if (nonzero) snn::accumulate<CT>(acc, xs, ws, s, ly, lx);
  snn::store_tile<CT>(dx + (((size_t)n * s.E_h + y) * s.E_w + lx) * s.Cout + c0,
                      acc, c0, s.Cout);
}

template <int CT>
int launch(const float* g, const float* w, float* dx, int N,
           const snn::ConvShape& s, cudaStream_t stream) {
  const size_t smem = snn::smem_floats<CT>(s) * sizeof(float);
  cudaError_t err = snn::allow_smem(conv_grad_input_kernel<CT>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(N, (s.E_h + s.BR - 1) / s.BR, (s.Cout + CT - 1) / CT);
  const int threads = (s.BR * s.E_w + 31) / 32 * 32;
  conv_grad_input_kernel<CT><<<grid, threads, smem, stream>>>(g, w, dx, s);
  return (int)cudaGetLastError();
}

}  // namespace

// The backward conv in its own terms: g (N, H, W, Cin) is the forward's
// output cotangent (H, W, Cin = the forward's E_h, E_w, Cout), w the
// forward's (R, R, Cout, Cin) weights, dx (N, E_h, E_w, Cout) the forward
// input's gradient, pad_lo = R-1-lo of the forward.  float32, contiguous,
// on the stream's device.  Returns a cudaError_t.
extern "C" int conv_grad_input_launch(const float* g, const float* w,
                                      float* dx, int N, int H, int W, int Cin,
                                      int Cout, int R, int pad_lo, int E_h,
                                      int E_w, int block_rows, int cout_tile,
                                      void* stream) {
  const snn::ConvShape s{H, W, Cin, Cout, R, pad_lo, E_h, E_w, block_rows};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (cout_tile) {
    case 4: return launch<4>(g, w, dx, N, s, st);
    case 8: return launch<8>(g, w, dx, N, s, st);
    case 16: return launch<16>(g, w, dx, N, s, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
