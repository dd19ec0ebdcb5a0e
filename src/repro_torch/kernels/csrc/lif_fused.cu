// Fused LIF step over an elementwise tensor for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/lif.py:lif_fused_pallas (kernel body
// lif_fused_kernel).  Per element, in float32 whatever the storage type:
//   vf = v + z;   s = vf >= v_th;   v' = vf - v_th * s
// and both v' and s are stored in v's type (float32 or bfloat16), as the
// TPU kernel does.  It is the building block for callers that stream one
// timestep at a time; the layer-level fusion that keeps the membrane on
// chip over all T is spiking_conv_lif.cu.
//
// What bounds it on the H100: two reads and two writes per element (16
// bytes in float32, 8 in bfloat16) for four float operations, about 0.25
// operations per byte against the 20 per byte (67 TFLOP/s over 3.35 TB/s)
// where arithmetic would start to bound it.  So it is bound by memory, and
// the design moves each byte once, coalesced: a grid-stride loop, one
// element per thread and step, neighbouring threads on neighbouring
// elements.  Vector loads are later work.
//
// The arithmetic is the plain version's (kernels/ref.py:lif_fused_ref), one
// rounding per operation with the _rn intrinsics (no contraction), and
// v_th * s is exact for s in {0, 1}: the kernel gives the plain version's
// bits, and the float-to-bfloat16 stores round to nearest even as
// PyTorch's conversion does.
#include <algorithm>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

__device__ __forceinline__ float load(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, size_t i, float x) { p[i] = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, size_t i, float x) {
  p[i] = __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(256)
lif_fused_kernel(const T* __restrict__ v, const T* __restrict__ z,
                 T* __restrict__ v_out, T* __restrict__ s_out, size_t n,
                 float v_th) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float vf = __fadd_rn(load(v, i), load(z, i));
    const float s = vf >= v_th ? 1.f : 0.f;
    store(v_out, i, __fsub_rn(vf, __fmul_rn(v_th, s)));
    store(s_out, i, s);
  }
}

template <typename T>
int launch(const void* v, const void* z, void* v_out, void* s_out, size_t n,
           float v_th, cudaStream_t stream) {
  const int threads = 256;
  // enough blocks to fill 132 SMs many times over; the loop covers the rest
  const size_t blocks = std::min<size_t>((n + threads - 1) / threads, 132 * 64);
  lif_fused_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(v), static_cast<const T*>(z),
      static_cast<T*>(v_out), static_cast<T*>(s_out), n, v_th);
  return (int)cudaGetLastError();
}

}  // namespace

// v, z -> v_out, s_out, n elements each, contiguous, on the stream's
// device, all of one type: dtype 0 float32, 1 bfloat16.  Returns a
// cudaError_t.
extern "C" int lif_fused_launch(const void* v, const void* z, void* v_out,
                                void* s_out, long long n, int dtype,
                                float v_th, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(v, z, v_out, s_out, (size_t)n, v_th, st);
    case 1:
      return launch<__nv_bfloat16>(v, z, v_out, s_out, (size_t)n, v_th, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
