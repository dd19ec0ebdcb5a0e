// Spike-driven convolution for Hopper (sm_90a): dV = conv(x, w) + bias.
//
// Replaces the TPU kernel repro/kernels/spiking_conv.py:spiking_conv_pallas
// (kernel body _make_kernel).  On the main path it is the hoisted first
// layer of snn-mnist: x (B, 28, 28, 1) analog frames, w (3, 3, 1, 16),
// dV (B, 30, 30, 16), all float32, NHWC x RRIO, APRC full padding.
//
// What bounds it on the H100 at that shape (per frame; each input byte read
// once, each output byte written once): 3.1 KB in, 57.6 KB out, 0.26 MFLOP
// of taps at most.  At 3.35 TB/s and 67 TFLOP/s (float32, no tensor cores)
// that is 18 ns of memory against 4 ns of arithmetic per frame: the kernel
// is bound by writing dV.  So the design spends nothing on the arithmetic
// and keeps the write dense: each thread owns one output pixel and CT
// consecutive channels and writes them as float4 stores, so a warp's stores
// cover whole contiguous spans of dV; the input and the weights are read
// from global memory once per block into shared memory (conv_tile.cuh).
//
// A block whose halo rows hold no nonzero input writes the bias only (the
// skip of the TPU kernel's counts table, taken here per block).  Sums run in
// one fixed order per output, with no atomics.
#include "conv_tile.cuh"

namespace {

template <int CT>
__global__ void __launch_bounds__(512)
spiking_conv_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ b, float* __restrict__ out,
                    snn::ConvShape s) {
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);
  float* xs = ws + (size_t)s.R * s.R * s.Cin * CT;
  const int n = blockIdx.x, i = blockIdx.y, c0 = blockIdx.z * CT;

  snn::stage_weights<CT>(ws, w, s, c0);
  const int nonzero =
      snn::stage_halo(xs, x + (size_t)n * s.H * s.W * s.Cin, s, i);

  const int ly = threadIdx.x / s.E_w, lx = threadIdx.x % s.E_w;
  const int y = i * s.BR + ly;
  if (ly >= s.BR || y >= s.E_h) return;

  float acc[CT];
#pragma unroll
  for (int c = 0; c < CT; ++c) acc[c] = 0.f;
  if (nonzero) snn::accumulate<CT>(acc, xs, ws, s, ly, lx);
#pragma unroll
  for (int c = 0; c < CT; ++c) acc[c] += c0 + c < s.Cout ? b[c0 + c] : 0.f;
  snn::store_tile<CT>(out + (((size_t)n * s.E_h + y) * s.E_w + lx) * s.Cout + c0,
                      acc, c0, s.Cout);
}

template <int CT>
int launch(const float* x, const float* w, const float* b, float* out, int N,
           const snn::ConvShape& s, cudaStream_t stream) {
  const size_t smem = snn::smem_floats<CT>(s) * sizeof(float);
  cudaError_t err = snn::allow_smem(spiking_conv_kernel<CT>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(N, (s.E_h + s.BR - 1) / s.BR, (s.Cout + CT - 1) / CT);
  const int threads = (s.BR * s.E_w + 31) / 32 * 32;
  spiking_conv_kernel<CT><<<grid, threads, smem, stream>>>(x, w, b, out, s);
  return (int)cudaGetLastError();
}

}  // namespace

// x (N, H, W, Cin), w (R, R, Cin, Cout), b (Cout,) -> out (N, E_h, E_w, Cout);
// float32, contiguous, on the stream's device.  Returns a cudaError_t.
extern "C" int spiking_conv_launch(const float* x, const float* w,
                                   const float* b, float* out, int N, int H,
                                   int W, int Cin, int Cout, int R, int pad_lo,
                                   int E_h, int E_w, int block_rows,
                                   int cout_tile, void* stream) {
  const snn::ConvShape s{H, W, Cin, Cout, R, pad_lo, E_h, E_w, block_rows};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (cout_tile) {
    case 4: return launch<4>(x, w, b, out, N, s, st);
    case 8: return launch<8>(x, w, b, out, N, s, st);
    case 16: return launch<16>(x, w, b, out, N, s, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
