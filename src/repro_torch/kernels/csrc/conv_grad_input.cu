// Input gradient of the spiking conv for Hopper (sm_90a), on the tensor
// cores: dx from the cotangent g of the conv output dV.
//
// Replaces the TPU kernel repro/kernels/spiking_conv.py:
// conv_grad_input_pallas (its pl.pallas_call, line 294; kernel body
// _make_grad_input_kernel).  The transpose of the forward conv (pads lo, hi)
// is itself a conv of g with the flipped, channel-swapped taps
//   wt[dy, dx, co, ci] = w[R-1-dy, R-1-dx, ci, co]
// under pads (R-1-lo, R-1-hi): none for APRC's full conv (a VALID conv),
// swapped for SAME.  No bias, and nothing is carried over T: the caller
// folds T x batch into N.
//
// On the main path it runs the backward of snn-mnist layers 2 and 1
// (N = T * B = 8 * 256, float32, NHWC):
//   layer 2  g (2048, 34, 34, 8)  -> dx (2048, 32, 32, 32)
//   layer 1  g (2048, 32, 32, 32) -> dx (2048, 30, 30, 16)
//
// The operand split (3xTF32).  g is a float32 cotangent, not a spike, so
// both operands split into TF32 parts, a = a_hi + a_lo with
// a_hi = tf32(a), a_lo = tf32(a - a_hi) (cvt.rna.tf32.f32's rounding,
// 11 + 11 significant bits), and each k8 step issues three m16n8k8 MMAs,
// a_lo*b_hi, a_hi*b_lo, a_hi*b_hi (the dropped a_lo*b_lo is below 2^-22 of
// a product), into one float32 accumulator: about float32 accuracy.  The
// weights are split once, while they are staged.  The cotangent is split in
// registers right after ldmatrix, so the halo is staged once, in float32;
// to_tf32 rounds by integer operations, since cvt issues at a quarter of
// their rate and bound this loop.
//
// What bounds it on the H100 (chip_smoke.py's data; each input byte read
// once, each output byte written once; the three split products of every
// transposed tap of a row-block with a nonzero cotangent):
//   layer 2  344.2 MB: 0.103 ms at 3.35 TB/s;  3 x 9.66 GFLOP: 0.059 ms at
//            495 TFLOP/s TF32
//   layer 1  386.4 MB: 0.115 ms;  3 x 16.99 GFLOP: 0.103 ms
// so both are bound by their bytes.
//
// Design (mma_tile.cuh has the GEMM view): the A operand is read by
// ldmatrix straight from the float32 halo shifted by each tap, no im2col
// copy; all of a layer's <= 32 input channels are one block's N, so there
// is no channel-tile axis, and each warp's B fragments feed its two m-tiles
// (measured on the card, its three mma.sync per k8 step take most of its
// time, more than its bytes); the blocks are persistent, as many as fit the
// card, each staging the split weights once and walking (image, row-block)
// tiles, so the weights are not staged again for every tile; a tile's halo
// arrives by cp.async, every copy of it in flight at once.  A tile whose
// staged cotangent is all zero writes zeros without the taps (its dx is
// exactly zero).  Each output's sum runs in one fixed order inside one
// block (taps, k steps, then lo*hi, hi*lo, hi*hi), with no atomics.
#include "mma_tile.cuh"

namespace {

using snn::ConvShape;
using Dims = snn::MmaDims<false>;

// Copy the block's group of the transposed taps into two TF32 planes
// ws[((plane * taps + tap) * nc + c) * cs + k] = split of
// w[R*R-1-tap][c0+c][k], zero past Cin and Cout.  In the backward's terms
// (s): Cin is the forward's Cout (the summed axis) and Cout the forward's
// Cin (the output axis); w is the forward's (R, R, s.Cout, s.Cin) array.
__device__ __forceinline__ void stage_transposed_weights(
    uint32_t* ws, const float* __restrict__ w, const ConvShape& s,
    const Dims& d, int c0) {
  const int n = d.taps * d.kp * d.nc;
  const size_t plane = (size_t)d.taps * d.nc * d.cs;
  for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
    const int k = idx % d.kp, c = idx / d.kp % d.nc, tap = idx / d.kp / d.nc;
    const int co = c0 + c;
    const float wv =
        (k < s.Cin && co < s.Cout)
            ? __ldg(w + ((size_t)(d.taps - 1 - tap) * s.Cout + co) * s.Cin + k)
            : 0.f;
    const uint32_t hi = snn::to_tf32(wv);
    const size_t at = ((size_t)tap * d.nc + c) * d.cs + k;
    ws[at] = hi;
    ws[plane + at] = snn::to_tf32(wv - __uint_as_float(hi));
  }
}

// Whether this thread finds a nonzero value in its share of the staged
// halo (pad channels included: they hold zeros).
__device__ __forceinline__ bool any_nonzero(const float* hs, const Dims& d) {
  bool nonzero = false;
  const float4* h4 = reinterpret_cast<const float4*>(hs);
  for (size_t k = threadIdx.x; k < d.halo_elems() / 4; k += blockDim.x) {
    const float4 v = h4[k];
    nonzero |= v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f;
  }
  return nonzero;
}

// The fragments of one (tap, k step): A of each of the warp's m-tiles (the
// cotangent, float32, split after the load), B of each n-tile in the two
// TF32 weight planes.
template <int NT>
struct Frags {
  uint32_t a[snn::kMmaTiles][4], b[2][NT][2];
};

template <int NT>
__device__ __forceinline__ void load_frags(
    Frags<NT>& f, const snn::TapWalk& tw, const ConvShape& s, const Dims& d,
    uint32_t hs_base, uint32_t ws_base,
    const uint32_t (&a_off)[snn::kMmaTiles], int warp) {
  const int tap = tw.dy * s.R + tw.dx;
  const uint32_t a_at = hs_base +
                        (uint32_t)((tw.dy * s.w_pad() + tw.dx) * d.cs) * 4 +
                        tw.kk * 32;
  const uint32_t b_at =
      ws_base + (uint32_t)(tap * d.nc * d.cs) * 4 + tw.kk * 32;
  const uint32_t plane_bytes = (uint32_t)(d.taps * d.nc * d.cs) * 4;
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      snn::ldsm_x2(b_at + p * plane_bytes + (uint32_t)(nt * 8 * d.cs) * 4,
                   f.b[p][nt]);
#pragma unroll
  for (int mi = 0; mi < snn::kMmaTiles; ++mi)
    if (warp + snn::kMmaWarps * mi < d.m_tiles)
      snn::ldsm_x4(a_at + a_off[mi], f.a[mi]);
}

template <int NT>
__global__ void __launch_bounds__(snn::kMmaThreads, 2)
conv_grad_input_kernel(const float* __restrict__ g,
                       const float* __restrict__ w, float* __restrict__ dx,
                       int N, ConvShape s) {
  constexpr int MT = snn::kMmaTiles;
  const Dims d(s, 8 * NT);
  extern __shared__ float4 smem4[];
  uint32_t* ws = reinterpret_cast<uint32_t*>(smem4);
  float* hs = reinterpret_cast<float*>(ws + d.weight_elems());
  const int c0 = blockIdx.z * d.nc;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int blocks = (s.E_h + s.BR - 1) / s.BR;

  // the pad channels of the halo are never written again
  for (size_t k = threadIdx.x; k < d.halo_elems(); k += blockDim.x)
    hs[k] = 0.f;
  stage_transposed_weights(ws, w, s, d, c0);

  uint32_t a_off[MT];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
    a_off[mi] = snn::a_row_offset<false>(s, d.m, d.cs,
                                         warp + snn::kMmaWarps * mi, lane);
  const uint32_t hs_base = snn::smem_u32(hs);
  const uint32_t ws_base =
      snn::smem_u32(ws) + snn::b_row_offset<false>(d.cs, lane);
  const int ksteps = d.kp / 8;

  for (int tile = blockIdx.x; tile < N * blocks; tile += gridDim.x) {
    const int n = tile / blocks, i = tile % blocks;
    __syncthreads();   // every warp is done with the previous tile's halo
    snn::issue_halo(hs, d.cs, g + (size_t)n * s.H * s.W * s.Cin, s, i);
    snn::cp_async_wait_all();
    __syncthreads();
    const int nonzero = __syncthreads_or(any_nonzero(hs, d));

    float acc[MT][NT][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[mi][nt][j] = 0.f;

    if (nonzero && warp < d.m_tiles) {
      // the taps and k steps in their fixed order; per fragment the A
      // split into TF32 hi and lo, then lo*hi, hi*lo, hi*hi
      Frags<NT> f;
      for (snn::TapWalk tw; tw.dy < s.R; tw.next(s.R, ksteps)) {
        load_frags(f, tw, s, d, hs_base, ws_base, a_off, warp);
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          if (warp + snn::kMmaWarps * mi >= d.m_tiles) break;
          uint32_t a_hi[4], a_lo[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float av = __uint_as_float(f.a[mi][j]);
            a_hi[j] = snn::to_tf32(av);
            a_lo[j] = snn::to_tf32(av - __uint_as_float(a_hi[j]));
          }
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            snn::mma_tf32(acc[mi][nt], a_lo, f.b[0][nt]);
            snn::mma_tf32(acc[mi][nt], a_hi, f.b[1][nt]);
            snn::mma_tf32(acc[mi][nt], a_hi, f.b[0][nt]);
          }
        }
      }
    }

#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int jh = 0; jh < 2; ++jh) {
        const snn::Pixel px(s, d.m, i,
                            (warp + snn::kMmaWarps * mi) * 16 + gq + 8 * jh);
        if (!px.active) continue;
        float* dst = dx + (((size_t)n * s.E_h + px.y) * s.E_w + px.lx) * s.Cout;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int co = c0 + nt * 8 + 2 * tq;
          snn::store_pair(dst + co, acc[mi][nt][2 * jh],
                          acc[mi][nt][2 * jh + 1], co, s.Cout);
        }
      }
  }
}

template <int NT>
int launch(const float* g, const float* w, float* dx, int N,
           const ConvShape& s, cudaStream_t stream) {
  const Dims d(s, 8 * NT);
  if (d.m_tiles > snn::kMaxMTiles)
    return (int)cudaErrorInvalidValue;
  const size_t smem = d.smem_bytes();
  auto kernel = conv_grad_input_kernel<NT>;
  cudaError_t err = snn::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, snn::kMmaThreads, smem)) != cudaSuccess)
    return (int)err;
  const long tiles = (long)N * ((s.E_h + s.BR - 1) / s.BR);
  const int groups = (s.Cout + d.nc - 1) / d.nc;
  // persistent blocks: as many as are resident at once, shared by the
  // channel groups
  long resident = (long)sms * (per_sm > 0 ? per_sm : 1) / groups;
  if (resident < 1) resident = 1;
  const dim3 grid((unsigned)(tiles < resident ? tiles : resident), 1, groups);
  kernel<<<grid, snn::kMmaThreads, smem, stream>>>(g, w, dx, N, s);
  return (int)cudaGetLastError();
}

}  // namespace

// The backward conv in its own terms: g (N, H, W, Cin) is the forward's
// output cotangent (H, W, Cin = the forward's E_h, E_w, Cout), w the
// forward's (R, R, Cout, Cin) weights, dx (N, E_h, E_w, Cout) the forward
// input's gradient, pad_lo = R-1-lo of the forward.  cout_tile is the
// channel group of a block, 8, 16, 24 or 32 (plan_mma_tiles).  float32,
// contiguous, on the stream's device.  Returns a cudaError_t.
extern "C" int conv_grad_input_launch(const float* g, const float* w,
                                      float* dx, int N, int H, int W, int Cin,
                                      int Cout, int R, int pad_lo, int E_h,
                                      int E_w, int block_rows, int cout_tile,
                                      void* stream) {
  const ConvShape s{H, W, Cin, Cout, R, pad_lo, E_h, E_w, block_rows};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (cout_tile) {
    case 8: return launch<1>(g, w, dx, N, s, st);
    case 16: return launch<2>(g, w, dx, N, s, st);
    case 24: return launch<3>(g, w, dx, N, s, st);
    case 32: return launch<4>(g, w, dx, N, s, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
