// Reverse-time surrogate BPTT of a fused conv+LIF layer for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/spiking_conv_lif.py:lif_bwd_pallas
// (kernel body _make_bwd_kernel).  From c = g_v, for t = T-1 ... 0:
//   lam_t = c + (g_s[t] - v_th * c) * sg(u_t - v_th);   c = lam_t
// and dv0 = c at the end.  sg is the surrogate derivative of
// core/surrogate.py (fast_sigmoid, triangle or arctan, scaled by alpha),
// chosen at compile time.  lam_t is the cotangent of the synaptic current
// dV_t, which the conv backward (conv_grad_input.cu, and the weight
// gradient in torch ops) consumes.
//
// On the main path it runs the backward of snn-mnist layers 1 and 2 (T = 8,
// float32): u, g_s, lam (8, B, 32, 32, 32) and (8, B, 34, 34, 8).
// What bounds it on the H100: it reads u and g_s and writes lam (12 bytes
// per element and step) plus g_v and dv0 once, for about 10 float
// operations per element and step: about 0.8 operations per byte, against
// the 20 per byte (67 TFLOP/s over 3.35 TB/s) where arithmetic would start
// to bound it.  So it is bound by memory, and the design is the one that
// moves each byte once, coalesced: one thread owns one (b, y, x, c) element
// and walks t backwards with c in a register, and neighbouring threads own
// neighbouring channels, so every load and store of a warp is one
// contiguous 128-byte span.
//
// The arithmetic is plain IEEE float32, one rounding per operation in the
// order of the plain version (kernels/ref.py:lif_bwd_ref), with no fused
// multiply-add (the _rn intrinsics forbid the contraction) and x * x where
// the plain version squares: the kernel gives the plain version's bits.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

enum Kind { kFastSigmoid = 0, kTriangle = 1, kArctan = 2 };

template <int KIND>
__device__ __forceinline__ float surrogate(float v, float alpha) {
  if (KIND == kFastSigmoid) {            // 1 / (1 + alpha*|v|)^2
    const float a = __fadd_rn(1.f, __fmul_rn(alpha, fabsf(v)));
    return __fdiv_rn(1.f, __fmul_rn(a, a));
  } else if (KIND == kTriangle) {        // max(0, 1 - alpha*|v|)
    return fmaxf(0.f, __fsub_rn(1.f, __fmul_rn(alpha, fabsf(v))));
  } else {                               // 1 / (1 + (alpha*v)^2)
    const float a = __fmul_rn(alpha, v);
    return __fdiv_rn(1.f, __fadd_rn(1.f, __fmul_rn(a, a)));
  }
}

template <int KIND>
__global__ void __launch_bounds__(256)
lif_bwd_kernel(const float* __restrict__ u, const float* __restrict__ g_s,
               const float* __restrict__ g_v, float* __restrict__ lam,
               float* __restrict__ dv0, int T, size_t M, float v_th,
               float alpha) {
  const size_t m = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  float c = g_v[m];
  for (int t = T - 1; t >= 0; --t) {
    const size_t k = (size_t)t * M + m;
    const float sg = surrogate<KIND>(__fsub_rn(u[k], v_th), alpha);
    c = __fadd_rn(c, __fmul_rn(__fsub_rn(g_s[k], __fmul_rn(v_th, c)), sg));
    lam[k] = c;
  }
  dv0[m] = c;
}

template <int KIND>
int launch(const float* u, const float* g_s, const float* g_v, float* lam,
           float* dv0, int T, size_t M, float v_th, float alpha,
           cudaStream_t stream) {
  const int threads = 256;
  const size_t blocks = (M + threads - 1) / threads;
  lif_bwd_kernel<KIND><<<(unsigned)blocks, threads, 0, stream>>>(
      u, g_s, g_v, lam, dv0, T, M, v_th, alpha);
  return (int)cudaGetLastError();
}

}  // namespace

// u, g_s (T, M), g_v (M) -> lam (T, M), dv0 (M), where M is the number of
// elements of one step (B * E_h * E_w * Cout); float32, contiguous, on the
// stream's device.  kind: 0 fast_sigmoid, 1 triangle, 2 arctan.  Returns a
// cudaError_t.
extern "C" int lif_bwd_launch(const float* u, const float* g_s,
                              const float* g_v, float* lam, float* dv0,
                              int T, long long M, int kind, float v_th,
                              float alpha, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t m = (size_t)M;
  switch (kind) {
    case kFastSigmoid:
      return launch<kFastSigmoid>(u, g_s, g_v, lam, dv0, T, m, v_th, alpha,
                                  st);
    case kTriangle:
      return launch<kTriangle>(u, g_s, g_v, lam, dv0, T, m, v_th, alpha, st);
    case kArctan:
      return launch<kArctan>(u, g_s, g_v, lam, dv0, T, m, v_th, alpha, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
