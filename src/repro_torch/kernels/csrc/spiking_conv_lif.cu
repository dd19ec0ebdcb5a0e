// Fused spiking conv + LIF over all T timesteps for Hopper (sm_90a).
//
// Replaces two TPU kernels of repro/kernels/spiking_conv_lif.py, both
// _fused_call with the kernel body _make_kernel: spiking_conv_lif_pallas
// (save_u=False, the inference primal; SAVE_U=false here) and
// spiking_conv_lif_fwd_pallas (save_u=True, the training forward;
// SAVE_U=true).  For each t: dV_t = conv(x[t], w) + bias, bias only where
// the block's receptive inputs hold no spike; then u = v + dV_t;
// s = u >= v_th; v = u - v_th * s.  The membrane lives in registers from v0
// to v_final.  With SAVE_U the kernel also stores the pre-reset membrane u
// of every step: the residual of the surrogate backward (lif_bwd.cu).
//
// On the main path it runs snn-mnist layers 1 and 2 (T = 8, float32, NHWC,
// APRC full padding):
//   layer 1  x (8, B, 30, 30, 16) -> s (8, B, 32, 32, 32), v (B, 32, 32, 32)
//   layer 2  x (8, B, 32, 32, 32) -> s (8, B, 34, 34, 8),  v (B, 34, 34, 8)
// and, with SAVE_U, u of the shape of s.
// What bounds it on the H100 (per frame; each input byte read once, each
// output byte written once; FLOPs of all taps, before skips):
//   layer 1  1.77 MB moved, 75.5 MFLOP: 0.53 us of memory at 3.35 TB/s
//            against 1.13 us of float32 arithmetic at 67 TFLOP/s
//   layer 2  1.42 MB moved, 42.6 MFLOP: 0.42 us against 0.64 us
// (SAVE_U adds 1.05 and 0.30 MB of u per frame: 0.84 and 0.51 us of
// memory, still under the arithmetic), so both layers are bound by
// arithmetic unless the skip removes more than about half of the taps.
// The design keeps the arithmetic on the float32
// FMA pipes and feeds them from shared memory: each thread owns one output
// pixel and CT consecutive channels, reads each staged input value once and
// reuses it from a register for its CT channels, and reads the weights as
// float4 broadcasts, so the FMAs outnumber shared-memory loads about 4:1.
// The membrane never leaves registers between timesteps, so the only
// traffic per step is the staged halo and the spike store (and u's).
// (The tensor cores are for a later version: the spikes are exact in any
// format, but the weights and sums are not.)
//
// The block stages each timestep's halo rows, takes the skip from a count
// of nonzero inputs over them (conv_tile.cuh), and sums the R*R*Cin taps in
// one fixed order per output, with no atomics, so a split of T into chunks
// that thread v_final into v0 gives the same bits as one call.
#include "conv_tile.cuh"

namespace {

template <int CT, bool SAVE_U>
__global__ void __launch_bounds__(512)
spiking_conv_lif_kernel(const float* __restrict__ x,
                        const float* __restrict__ v0,
                        const float* __restrict__ w,
                        const float* __restrict__ b, float* __restrict__ s_out,
                        float* __restrict__ v_out, float* __restrict__ u_out,
                        int T, int N, snn::ConvShape s, float v_th) {
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);
  float* xs = ws + (size_t)s.R * s.R * s.Cin * CT;
  const int n = blockIdx.x, i = blockIdx.y, c0 = blockIdx.z * CT;

  const int ly = threadIdx.x / s.E_w, lx = threadIdx.x % s.E_w;
  const int y = i * s.BR + ly;
  // idle threads (past the row-block or past E_h) still stage and reach
  // every barrier; they only skip the arithmetic and the stores
  const bool active = ly < s.BR && y < s.E_h;
  const size_t pix = ((size_t)n * s.E_h + y) * s.E_w + lx;
  const size_t frame = (size_t)N * s.E_h * s.E_w * s.Cout;

  float v[CT];
#pragma unroll
  for (int c = 0; c < CT; ++c)
    v[c] = active && c0 + c < s.Cout ? v0[pix * s.Cout + c0 + c] : 0.f;

  snn::stage_weights<CT>(ws, w, s, c0);
  for (int t = 0; t < T; ++t) {
    if (t > 0) __syncthreads();   // every read of step t-1's halo is done
    const int nonzero = snn::stage_halo(
        xs, x + ((size_t)t * N + n) * s.H * s.W * s.Cin, s, i);
    if (!active) continue;
    float acc[CT];
#pragma unroll
    for (int c = 0; c < CT; ++c) acc[c] = 0.f;
    if (nonzero) snn::accumulate<CT>(acc, xs, ws, s, ly, lx);
    float u[CT];
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      const float bias = c0 + c < s.Cout ? __ldg(b + c0 + c) : 0.f;
      u[c] = v[c] + (acc[c] + bias);               // integrate dV
      acc[c] = u[c] >= v_th ? 1.f : 0.f;           // fire: acc holds s_t
      v[c] = u[c] - v_th * acc[c];                 // reset by subtraction
    }
    const size_t at = (size_t)t * frame + pix * s.Cout + c0;
    if (SAVE_U) snn::store_tile<CT>(u_out + at, u, c0, s.Cout);
    snn::store_tile<CT>(s_out + at, acc, c0, s.Cout);
  }
  if (active) snn::store_tile<CT>(v_out + pix * s.Cout + c0, v, c0, s.Cout);
}

template <int CT, bool SAVE_U>
int launch(const float* x, const float* v0, const float* w, const float* b,
           float* s_out, float* v_out, float* u_out, int T, int N,
           const snn::ConvShape& s, float v_th, cudaStream_t stream) {
  const size_t smem = snn::smem_floats<CT>(s) * sizeof(float);
  cudaError_t err =
      snn::allow_smem(spiking_conv_lif_kernel<CT, SAVE_U>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(N, (s.E_h + s.BR - 1) / s.BR, (s.Cout + CT - 1) / CT);
  const int threads = (s.BR * s.E_w + 31) / 32 * 32;
  spiking_conv_lif_kernel<CT, SAVE_U><<<grid, threads, smem, stream>>>(
      x, v0, w, b, s_out, v_out, u_out, T, N, s, v_th);
  return (int)cudaGetLastError();
}

template <bool SAVE_U>
int dispatch(const float* x, const float* v0, const float* w, const float* b,
             float* s_out, float* v_out, float* u_out, int T, int N,
             const snn::ConvShape& s, int cout_tile, float v_th,
             cudaStream_t st) {
  switch (cout_tile) {
    case 4:
      return launch<4, SAVE_U>(x, v0, w, b, s_out, v_out, u_out, T, N, s,
                               v_th, st);
    case 8:
      return launch<8, SAVE_U>(x, v0, w, b, s_out, v_out, u_out, T, N, s,
                               v_th, st);
    case 16:
      return launch<16, SAVE_U>(x, v0, w, b, s_out, v_out, u_out, T, N, s,
                                v_th, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x (T, N, H, W, Cin), v0 (N, E_h, E_w, Cout), w (R, R, Cin, Cout),
// b (Cout,) -> s (T, N, E_h, E_w, Cout), v (N, E_h, E_w, Cout); float32,
// contiguous, on the stream's device.  Returns a cudaError_t.
extern "C" int spiking_conv_lif_launch(const float* x, const float* v0,
                                       const float* w, const float* b,
                                       float* s_out, float* v_out, int T,
                                       int N, int H, int W, int Cin, int Cout,
                                       int R, int pad_lo, int E_h, int E_w,
                                       int block_rows, int cout_tile,
                                       float v_th, void* stream) {
  const snn::ConvShape s{H, W, Cin, Cout, R, pad_lo, E_h, E_w, block_rows};
  return dispatch<false>(x, v0, w, b, s_out, v_out, nullptr, T, N, s,
                         cout_tile, v_th, static_cast<cudaStream_t>(stream));
}

// The training forward: as spiking_conv_lif_launch, plus the pre-reset
// membrane u (T, N, E_h, E_w, Cout).
extern "C" int spiking_conv_lif_fwd_launch(
    const float* x, const float* v0, const float* w, const float* b,
    float* s_out, float* v_out, float* u_out, int T, int N, int H, int W,
    int Cin, int Cout, int R, int pad_lo, int E_h, int E_w, int block_rows,
    int cout_tile, float v_th, void* stream) {
  const snn::ConvShape s{H, W, Cin, Cout, R, pad_lo, E_h, E_w, block_rows};
  return dispatch<true>(x, v0, w, b, s_out, v_out, u_out, T, N, s,
                        cout_tile, v_th, static_cast<cudaStream_t>(stream));
}
