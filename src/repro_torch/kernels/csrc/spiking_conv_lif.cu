// Fused spiking conv + LIF over all T timesteps for Hopper (sm_90a), on the
// tensor cores.
//
// Replaces two TPU kernels of repro/kernels/spiking_conv_lif.py, both
// _fused_call (its pl.pallas_call, line 181) with the kernel body
// _make_kernel: spiking_conv_lif_pallas (save_u=False, the inference primal;
// SAVE_U=false here, kernel B) and spiking_conv_lif_fwd_pallas (save_u=True,
// the training forward; SAVE_U=true, kernel C).  For each t:
// dV_t = conv(x[t], w) + bias, bias only where the block's receptive inputs
// hold no spike; then u = v + dV_t; s = u >= v_th; v = u - v_th * s.  The
// membrane stays on chip from v0 to v_final.  With SAVE_U the kernel also
// stores the pre-reset membrane u of every step: the residual of the
// surrogate backward (lif_bwd.cu).  With COUNT (kernel B for a caller that
// reports counts) it also writes the train's spike counts, as kernel A's
// hoisted mode does (spiking_conv.cu): t_counts (T, Cout), the spikes of
// every step and channel, and row_nz (T, N, E_h), those of every output
// row of every step and image.
//
// On the main path it runs snn-mnist layers 1 and 2 (T = 8, float32, NHWC,
// APRC full padding):
//   layer 1  x (8, B, 30, 30, 16) -> s (8, B, 32, 32, 32), v (B, 32, 32, 32)
//   layer 2  x (8, B, 32, 32, 32) -> s (8, B, 34, 34, 8),  v (B, 34, 34, 8)
// and, with SAVE_U, u of the shape of s.
//
// The operand split.  The inputs are spike trains, 0 or 1, exact in bf16.
// Each float32 weight splits exactly into three bf16 parts, hi = bf16(w),
// mid = bf16(w - hi), lo = bf16(w - hi - mid) (8 + 8 + 8 significant bits),
// so every product spike * part is exact.  Each k step issues three
// m16n8k16 MMAs with float32 accumulators: lo and mid into one set, hi into
// another.  The hi products carry 8 significant bits, so their sum is
// exact unless a weight lies below 2^-16 of it, and the low set's rounding
// is 2^-8 smaller; dV = hi sum + low sum is then the float32 rounding of
// the exact sum at all but rare sites, as the plain version computes it
// (one accumulator for all three lost ulps in the tensor core's truncating
// adds and let threshold flips cascade).  The split is made while the
// weights are staged, in the kernel (no extra launch).
//
// What bounds it on the H100 (batch 256, chip_smoke.py's data; each input
// byte read once, each output byte written once; the three split products
// of every tap of a row-block with a spike):
//   layer 1  453.5 MB: 0.135 ms at 3.35 TB/s;  3 x 19.6 GFLOP: 0.059 ms at
//            989 TFLOP/s bf16
//   layer 2  363.1 MB: 0.108 ms;  3 x 10.9 GFLOP: 0.033 ms
// (SAVE_U: 722.0 and 438.9 MB, 0.216 and 0.131 ms), so both are bound by
// their bytes, the spike and u stores most of them.
//
// Design (mma_tile.cuh has the GEMM view): one block per (image, row-block)
// and all of a layer's <= 32 output channels, so each step's halo is staged
// once; the A operand is read by ldmatrix straight from the bf16 halo
// shifted by each tap, with no im2col copy; the weight planes are staged
// once per block, and each warp's B fragments feed its two m-tiles.  The
// two accumulator sets fill the registers, so the membrane lives in shared
// memory, one slot per thread and site, read and written only by its
// thread.  The halo is double-buffered: step t+1's raw float32 rows
// travel by cp.async into a staging buffer while step t's MMAs run; at the
// next step a pass converts them to bf16, counts the nonzero values (the
// skip) and the values that are neither 0 nor 1.  A (block, step) whose
// input is not all 0 and 1 takes the float32 tap sum of conv_tile.cuh
// (tap_sum, in the plain path's rounding order, so such a step's dV has
// the plain version's bits) for its outputs instead of the MMAs: the
// public wrappers take any float32 input, as the reference's _fused_call
// does.  Each output's
// sum runs in one fixed order inside one block (taps, then k steps, then
// lo, mid, hi), with no atomics and no split of K across blocks, so a split
// of T into chunks that threads v_final into v0 gives the same bits as one
// call, and an image's bits do not depend on the batch.
//
// The counts (COUNT).  In the epilogue each lane packs its spikes of the
// step into fields, 8 bits a channel pair slot (nt, h) and 16 a pixel
// (mi, jh); three xor shuffles sum the channel fields over the eight lanes
// of a channel pair (lane = 4 g + tq), two sum the pixel fields over the
// four lanes of a pixel and three more over the eight pixels of (mi, jh),
// and one lane adds each to the block's count of its channel or row in
// shared memory (where the eight pixels span two rows, one lane a
// pixel).  At the next step's
// barrier the block adds each channel's count to t_counts with one
// atomic, and stores each row's count (an atomic where several channel
// groups share the row); two count buffers alternate between the steps.
// The sums are of integers, exact in any order, so the float bits do not
// change; the counts add 0.28 MB to layer 2's 363.1 MB at batch 256.
#include "mma_tile.cuh"

namespace {

using snn::ConvShape;
using Dims = snn::MmaDims<true>;

// Copy the block's channel group of the (R, R, Cin, Cout) weights into three
// bf16 planes ws[((plane * taps + tap) * nc + c) * cs + k], zero past Cin
// and Cout: plane 0 hi, 1 mid, 2 lo.
__device__ __forceinline__ void stage_split_weights(
    __nv_bfloat16* ws, const float* __restrict__ w, const ConvShape& s,
    const Dims& d, int c0) {
  const int n = d.taps * d.kp * d.nc;
  const size_t plane = (size_t)d.taps * d.nc * d.cs;
  constexpr int kBatch = 4;   // loads in flight a thread
  for (int base = threadIdx.x; base < n; base += kBatch * blockDim.x) {
    float wv[kBatch];
#pragma unroll
    for (int r = 0; r < kBatch; ++r) {
      const int idx = base + r * blockDim.x;
      const int c = idx % d.nc, k = idx / d.nc % d.kp, tap = idx / d.nc / d.kp;
      wv[r] = idx < n && k < s.Cin && c0 + c < s.Cout
                  ? __ldg(w + ((size_t)tap * s.Cin + k) * s.Cout + c0 + c)
                  : 0.f;
    }
#pragma unroll
    for (int r = 0; r < kBatch; ++r) {
      const int idx = base + r * blockDim.x;
      if (idx >= n) break;
      const int c = idx % d.nc, k = idx / d.nc % d.kp, tap = idx / d.nc / d.kp;
      const __nv_bfloat16 hi = __float2bfloat16_rn(wv[r]);
      const float r1 = wv[r] - __bfloat162float(hi);
      const __nv_bfloat16 mid = __float2bfloat16_rn(r1);
      const __nv_bfloat16 lo = __float2bfloat16_rn(r1 - __bfloat162float(mid));
      const size_t at = ((size_t)tap * d.nc + c) * d.cs + k;
      ws[at] = hi;
      ws[plane + at] = mid;
      ws[2 * plane + at] = lo;
    }
  }
}

// Convert the staged float32 rows xs[pix * cin4 + ci] into the bf16 halo
// hs[pix * cs + ci].  Returns in bit 0 whether this thread saw a nonzero
// value, in bit 1 whether it saw one that is neither 0 nor 1.
__device__ __forceinline__ int convert_halo(__nv_bfloat16* hs,
                                            const float* xs, const Dims& d) {
  const int q4 = d.cin4 / 4, n = d.halo_pix * q4;
  bool nonzero = false, other = false;
  snn::Walk wk(threadIdx.x, blockDim.x, d.halo_pix, q4);
  for (int u = threadIdx.x; u < n; u += blockDim.x, wk.next()) {
    const float4 v = reinterpret_cast<const float4*>(xs)[u];
    nonzero |= v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f;
    other |= (v.x != 0.f && v.x != 1.f) || (v.y != 0.f && v.y != 1.f) ||
             (v.z != 0.f && v.z != 1.f) || (v.w != 0.f && v.w != 1.f);
    __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 packed;
    packed.x = *reinterpret_cast<uint32_t*>(&lo);
    packed.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(hs + (size_t)wk.col * d.cs + 4 * wk.q) = packed;
  }
  return (int)nonzero | ((int)other << 1);
}

// The fragments of one (tap, k step): A of each of the warp's m-tiles, B of
// each n-tile in the three weight planes.
template <int NT>
struct Frags {
  uint32_t a[snn::kMmaTiles][4], b[3][NT][2];
};

template <int NT>
__device__ __forceinline__ void load_frags(
    Frags<NT>& f, const snn::TapWalk& tw, const ConvShape& s, const Dims& d,
    uint32_t hs_base, uint32_t ws_base,
    const uint32_t (&a_off)[snn::kMmaTiles], int warp) {
  const int tap = tw.dy * s.R + tw.dx;
  const uint32_t a_at = hs_base +
                        (uint32_t)((tw.dy * s.w_pad() + tw.dx) * d.cs) * 2 +
                        tw.kk * 32;
  const uint32_t b_at =
      ws_base + (uint32_t)(tap * d.nc * d.cs) * 2 + tw.kk * 32;
  const uint32_t plane_bytes = (uint32_t)(d.taps * d.nc * d.cs) * 2;
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      snn::ldsm_x2(b_at + p * plane_bytes + (uint32_t)(nt * 8 * d.cs) * 2,
                   f.b[p][nt]);
#pragma unroll
  for (int mi = 0; mi < snn::kMmaTiles; ++mi)
    if (warp + snn::kMmaWarps * mi < d.m_tiles)
      snn::ldsm_x4(a_at + a_off[mi], f.a[mi]);
}

// COUNT: add the block's count buffer cb of step t to t_counts and row_nz,
// and zero it for step t + 2 (after a barrier).
__device__ __forceinline__ void flush_counts(
    int* cb, int* __restrict__ t_counts, int* __restrict__ row_nz, int t,
    int N, const ConvShape& s, const Dims& d, int n, int i, int c0) {
  for (int e = threadIdx.x; e < d.nc + s.BR; e += blockDim.x) {
    const int k = cb[e];
    cb[e] = 0;
    if (e < d.nc) {
      if (k) atomicAdd(t_counts + (size_t)t * s.Cout + c0 + e, k);
    } else if (i * s.BR + e - d.nc < s.E_h) {
      int* dst = row_nz + ((size_t)t * N + n) * s.E_h + i * s.BR + e - d.nc;
      if (gridDim.z == 1)
        *dst = k;
      else if (k)
        atomicAdd(dst, k);
    }
  }
}

template <int NT, bool SAVE_U, bool COUNT>
__global__ void __launch_bounds__(snn::kMmaThreads, 2)
spiking_conv_lif_kernel(const float* __restrict__ x,
                        const float* __restrict__ v0,
                        const float* __restrict__ w,
                        const float* __restrict__ b, float* __restrict__ s_out,
                        float* __restrict__ v_out, float* __restrict__ u_out,
                        int* __restrict__ t_counts, int* __restrict__ row_nz,
                        int T, int N, ConvShape s, float v_th) {
  constexpr int MT = snn::kMmaTiles;
  const Dims d(s, 8 * NT);
  extern __shared__ float4 smem4[];
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* hs = ws + d.weight_elems();
  float* xs = reinterpret_cast<float*>(hs + d.halo_elems());
  // the membrane of this thread's site k lives at vs[k * threads + tid]
  float* vs = xs + d.stage_floats() + threadIdx.x;
  // COUNT: two count buffers, each [channel of the group, then row]
  int* cnt = reinterpret_cast<int*>(xs + d.stage_floats() +
                                    d.membrane_floats());
  const int n_cnt = d.nc + s.BR;
  const int n = blockIdx.x, i = blockIdx.y, c0 = blockIdx.z * d.nc;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t img_size = (size_t)s.H * s.W * s.Cin;
  const size_t frame = (size_t)N * s.E_h * s.E_w * s.Cout;

  // zero both halo buffers (their pad channels are never written again),
  // start step 0's copy, and split the weights while it travels
  {
    const size_t n4 = (d.halo_elems() * 2 + d.stage_floats() * 4) / 16;
    float4* z = reinterpret_cast<float4*>(hs);
    for (size_t k = threadIdx.x; k < n4; k += blockDim.x)
      z[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (COUNT)
      for (int e = threadIdx.x; e < 2 * n_cnt; e += blockDim.x) cnt[e] = 0;
  }
  __syncthreads();
  snn::issue_halo(xs, d.cin4, x + (size_t)n * img_size, s, i);
  stage_split_weights(ws, w, s, d, c0);

  // this thread's C-fragment sites: pixel rows g and g + 8 of each of its
  // m-tiles (out[mi][jh]: the pixel's index in (N, E_h, E_w), -1 if it is
  // no output), channels c0 + nt*8 + 2*tq + {0, 1}; site
  // ((mi * NT + nt) * 4 + 2 * jh + h)
  const int g = lane >> 2, tq = lane & 3;
  int out[MT][2], ly[MT][2];
  uint32_t a_off[MT];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
    const int tile = warp + snn::kMmaWarps * mi;
    a_off[mi] = snn::a_row_offset<true>(s, d.m, d.cs, tile, lane);
#pragma unroll
    for (int jh = 0; jh < 2; ++jh) {
      const snn::Pixel px(s, d.m, i, tile * 16 + g + 8 * jh);
      out[mi][jh] = px.active ? (n * s.E_h + px.y) * s.E_w + px.lx : -1;
      ly[mi][jh] = px.ly;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int co = c0 + nt * 8 + 2 * tq + h;
          vs[((mi * NT + nt) * 4 + 2 * jh + h) * snn::kMmaThreads] =
              out[mi][jh] >= 0 && co < s.Cout
                  ? v0[(size_t)out[mi][jh] * s.Cout + co]
                  : 0.f;
        }
    }
  }
  // COUNT: bit mi * 2 + jh when the eight pixels of (mi, jh) that are
  // outputs lie in one row
  int one_row = 0;
  if (COUNT)
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int jh = 0; jh < 2; ++jh) {
        const int first = __shfl_sync(~0u, ly[mi][jh], 0);
        if (__all_sync(~0u, out[mi][jh] < 0 || ly[mi][jh] == first))
          one_row |= 1 << (mi * 2 + jh);
      }
  const uint32_t hs_base = snn::smem_u32(hs);
  const uint32_t ws_base =
      snn::smem_u32(ws) + snn::b_row_offset<true>(d.cs, lane);
  const int ksteps = d.kp / 16;

  for (int t = 0; t < T; ++t) {
    // step t's rows have landed, and every warp is done with step t-1's halo
    snn::cp_async_wait_all();
    __syncthreads();
    if (COUNT && t > 0)
      flush_counts(cnt + ((t - 1) & 1) * n_cnt, t_counts, row_nz, t - 1, N, s,
                   d, n, i, c0);
    const int flags = convert_halo(hs, xs, d);
    const int nonzero = __syncthreads_or(flags & 1);
    const int other = __syncthreads_or(flags & 2);
    if (t + 1 < T)   // the staging buffer is free again: overlap t+1's copy
      snn::issue_halo(xs, d.cin4, x + ((size_t)(t + 1) * N + n) * img_size,
                      s, i);

    // the hi plane's products sum into acc, the mid and lo planes' into
    // low: spike * hi values carry 8 significant bits, so acc holds their
    // exact sum unless a weight is below 2^-16 of it, and low's rounding
    // is 2^-8 smaller; dV = acc + low
    float acc[MT][NT][4], low[MT][NT][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[mi][nt][j] = low[mi][nt][j] = 0.f;

    if (other) {
      // an input that is not a spike train: the float32 tap sum, one site
      // at a time (one call site, so the live fragments stay in registers)
      const float* img = x + ((size_t)t * N + n) * img_size;
#pragma unroll 1
      for (int q = 0; q < MT * NT * 4; ++q) {
        const int mi = q / (NT * 4), nt = q / 4 % NT, j = q % 4;
        const int p = (warp + snn::kMmaWarps * mi) * 16 + g + 8 * (j >> 1);
        const int co = c0 + nt * 8 + 2 * tq + (j & 1);
        const snn::Pixel px(s, d.m, i, p);
        const float sum = px.active && co < s.Cout
                              ? snn::tap_sum(img, w, s, px.y, px.lx, co)
                              : 0.f;
#pragma unroll
        for (int mi2 = 0; mi2 < MT; ++mi2)
#pragma unroll
          for (int nt2 = 0; nt2 < NT; ++nt2)
#pragma unroll
            for (int j2 = 0; j2 < 4; ++j2)
              if (q == (mi2 * NT + nt2) * 4 + j2) acc[mi2][nt2][j2] = sum;
      }
    } else if (nonzero && warp < d.m_tiles) {
      // the taps and k steps in their fixed order; per fragment the three
      // planes, lo and mid into low, hi into acc
      Frags<NT> f;
      for (snn::TapWalk tw; tw.dy < s.R; tw.next(s.R, ksteps)) {
        load_frags(f, tw, s, d, hs_base, ws_base, a_off, warp);
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          if (warp + snn::kMmaWarps * mi >= d.m_tiles) break;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            snn::mma_bf16(low[mi][nt], f.a[mi], f.b[2][nt]);   // lo
            snn::mma_bf16(low[mi][nt], f.a[mi], f.b[1][nt]);   // mid
            snn::mma_bf16(acc[mi][nt], f.a[mi], f.b[0][nt]);   // hi
          }
        }
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[mi][nt][j] += low[mi][nt][j];
    }

    // integrate, fire, reset; store s (and u) of step t; COUNT: this
    // lane's spikes, of channel pair slot nt * 2 + h in 8-bit field
    // nt % 2 * 2 + h of chan[nt / 2], of pixel (mi, jh) in 16-bit field jh
    // of pixel[mi]
    int chan[(NT + 1) / 2] = {}, pixel[MT] = {};
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int jh = 0; jh < 2; ++jh) {
        if (out[mi][jh] < 0) continue;
        const size_t pix = (size_t)out[mi][jh] * s.Cout;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int co = c0 + nt * 8 + 2 * tq;
          float u[2], sp[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float& v = vs[((mi * NT + nt) * 4 + 2 * jh + h) * snn::kMmaThreads];
            const float bias = co + h < s.Cout ? __ldg(b + co + h) : 0.f;
            u[h] = v + (acc[mi][nt][2 * jh + h] + bias);   // integrate
            sp[h] = u[h] >= v_th ? 1.f : 0.f;              // fire
            v = u[h] - v_th * sp[h];                       // reset
            if (COUNT && co + h < s.Cout && sp[h] != 0.f) {
              chan[nt >> 1] += 1 << (16 * (nt & 1) + 8 * h);
              pixel[mi] += 1 << (16 * jh);
            }
          }
          const size_t at = (size_t)t * frame + pix + co;
          if (SAVE_U) snn::store_pair(u_out + at, u[0], u[1], co, s.Cout);
          snn::store_pair(s_out + at, sp[0], sp[1], co, s.Cout);
        }
      }
    if (COUNT) {
      int* cb = cnt + (t & 1) * n_cnt;
      // a channel field sums at most 4 sites of 8 lanes (32), a pixel field
      // 2 * NT channels of 4 lanes of 8 pixels (256): no carries
#pragma unroll
      for (int j = 0; j < (NT + 1) / 2; ++j)
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
          chan[j] += __shfl_xor_sync(~0u, chan[j], off);
      if (g == 0)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int k = chan[nt >> 1] >> (16 * (nt & 1) + 8 * h) & 255;
            if (k) atomicAdd(cb + nt * 8 + 2 * tq + h, k);
          }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        pixel[mi] += __shfl_xor_sync(~0u, pixel[mi], 1);
        pixel[mi] += __shfl_xor_sync(~0u, pixel[mi], 2);
        const int own = pixel[mi];
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
          pixel[mi] += __shfl_xor_sync(~0u, pixel[mi], off);
#pragma unroll
        for (int jh = 0; jh < 2; ++jh) {
          const bool one = one_row >> (mi * 2 + jh) & 1;
          const int k = (one ? pixel[mi] : own) >> (16 * jh) & 0xffff;
          if (k && (one ? lane == 0 : tq == 0))
            atomicAdd(cb + d.nc + ly[mi][jh], k);
        }
      }
    }
  }
  if (COUNT) {
    __syncthreads();
    flush_counts(cnt + ((T - 1) & 1) * n_cnt, t_counts, row_nz, T - 1, N, s, d,
                 n, i, c0);
  }

#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int jh = 0; jh < 2; ++jh) {
      if (out[mi][jh] < 0) continue;
      const size_t pix = (size_t)out[mi][jh] * s.Cout;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int co = c0 + nt * 8 + 2 * tq;
        const float* v = vs + ((mi * NT + nt) * 4 + 2 * jh) * snn::kMmaThreads;
        snn::store_pair(v_out + pix + co, v[0], v[snn::kMmaThreads], co,
                        s.Cout);
      }
    }
}

// What a launch writes besides s and v: u (SAVE_U) or the counts (COUNT).
struct Extra {
  float* u;
  int* t_counts;
  int* row_nz;
};

template <int NT, bool SAVE_U, bool COUNT>
int launch(const float* x, const float* v0, const float* w, const float* b,
           float* s_out, float* v_out, const Extra& e, int T, int N,
           const ConvShape& s, float v_th, cudaStream_t stream) {
  const Dims d(s, 8 * NT);
  if (d.m_tiles > snn::kMaxMTiles)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      d.smem_bytes() + (COUNT ? 2 * (d.nc + s.BR) * sizeof(int) : 0);
  auto kernel = spiking_conv_lif_kernel<NT, SAVE_U, COUNT>;
  cudaError_t err = snn::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(N, (s.E_h + s.BR - 1) / s.BR, (s.Cout + d.nc - 1) / d.nc);
  kernel<<<grid, snn::kMmaThreads, smem, stream>>>(
      x, v0, w, b, s_out, v_out, e.u, e.t_counts, e.row_nz, T, N, s, v_th);
  return (int)cudaGetLastError();
}

template <bool SAVE_U, bool COUNT>
int dispatch(const float* x, const float* v0, const float* w, const float* b,
             float* s_out, float* v_out, const Extra& e, int T, int N,
             const ConvShape& s, int cout_tile, float v_th, cudaStream_t st) {
  switch (cout_tile) {
    case 8:
      return launch<1, SAVE_U, COUNT>(x, v0, w, b, s_out, v_out, e, T, N, s,
                                      v_th, st);
    case 16:
      return launch<2, SAVE_U, COUNT>(x, v0, w, b, s_out, v_out, e, T, N, s,
                                      v_th, st);
    case 24:
      return launch<3, SAVE_U, COUNT>(x, v0, w, b, s_out, v_out, e, T, N, s,
                                      v_th, st);
    case 32:
      return launch<4, SAVE_U, COUNT>(x, v0, w, b, s_out, v_out, e, T, N, s,
                                      v_th, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x (T, N, H, W, Cin), v0 (N, E_h, E_w, Cout), w (R, R, Cin, Cout),
// b (Cout,) -> s (T, N, E_h, E_w, Cout), v (N, E_h, E_w, Cout); float32,
// contiguous, on the stream's device; and, when t_counts is not null, the
// counts (COUNT): t_counts (T, Cout) int32, zero at launch, and row_nz
// (T, N, E_h) int32, zero at launch where the layer has several channel
// groups.  cout_tile is the channel group of a block, 8, 16, 24 or 32
// (plan_mma_tiles).  Returns a cudaError_t.
extern "C" int spiking_conv_lif_launch(const float* x, const float* v0,
                                       const float* w, const float* b,
                                       float* s_out, float* v_out,
                                       int* t_counts, int* row_nz, int T,
                                       int N, int H, int W, int Cin, int Cout,
                                       int R, int pad_lo, int E_h, int E_w,
                                       int block_rows, int cout_tile,
                                       float v_th, void* stream) {
  const ConvShape s{H, W, Cin, Cout, R, pad_lo, E_h, E_w, block_rows};
  const Extra e{nullptr, t_counts, row_nz};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (t_counts && !row_nz) return (int)cudaErrorInvalidValue;
  return t_counts ? dispatch<false, true>(x, v0, w, b, s_out, v_out, e, T, N,
                                          s, cout_tile, v_th, st)
                  : dispatch<false, false>(x, v0, w, b, s_out, v_out, e, T, N,
                                           s, cout_tile, v_th, st);
}

// The training forward: as spiking_conv_lif_launch, plus the pre-reset
// membrane u (T, N, E_h, E_w, Cout).
extern "C" int spiking_conv_lif_fwd_launch(
    const float* x, const float* v0, const float* w, const float* b,
    float* s_out, float* v_out, float* u_out, int T, int N, int H, int W,
    int Cin, int Cout, int R, int pad_lo, int E_h, int E_w, int block_rows,
    int cout_tile, float v_th, void* stream) {
  const ConvShape s{H, W, Cin, Cout, R, pad_lo, E_h, E_w, block_rows};
  const Extra e{u_out, nullptr, nullptr};
  return dispatch<true, false>(x, v0, w, b, s_out, v_out, e, T, N, s,
                               cout_tile, v_th,
                               static_cast<cudaStream_t>(stream));
}
