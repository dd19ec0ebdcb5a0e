// Device code shared by the tensor-core conv kernels (spiking_conv_lif.cu,
// kernels B and C, conv_grad_input.cu, kernel E, and conv_grad_weights.cu,
// the weight gradient): the implicit-GEMM decomposition of B, C and E, the
// shared-memory plan, and thin wrappers of the PTX they issue (ldmatrix,
// mma.sync; cp.async is in conv_tile.cuh) and the TF32 rounding.  The
// weight gradient has a GEMM view of its own (its source note).
//
// The GEMM view.  One thread block per (image n, output row-block i,
// channel group g): M = the row-block's BR * E_w output pixels, in m16
// tiles over the linear pixel index (the last one masked); N = the group's
// NC = 8 * NT output channels, in n8 tiles (NT <= 4, so a layer of at most
// 32 channels has one group and its halo is staged once); K = the R*R taps
// in a fixed order, each tap's Cin padded with zeros to the MMA depth KP.
// The A operand of tap (dy, dx) is the staged halo shifted by (dy, dx):
// each lane hands ldmatrix the address of its pixel's row, so no im2col
// copy is made.  The B operand is the weight tile, staged once per block as
// [plane][tap][channel][k], k contiguous, which ldmatrix (not transposed)
// turns into the col-major B fragment.  Eight warps; warp w owns m-tiles
// w and w + 8 (MT = 2, so each B fragment feeds two m-tiles and a block
// holds at most 16 m-tiles, 256 pixels), and each of its accumulator sets
// is MT * NT * 4 <= 32 floats a thread.  Each thread of the C fragment
// owns pixel rows lane/4 and lane/4 + 8 of an m-tile and channels
// 2*(lane%4) + {0, 1} of an n-tile.
//
// Row strides.  A halo pixel's row is CS elements: KP plus 16 bytes, so the
// stride is an odd number of 16-byte units and the eight rows of one
// ldmatrix phase fall in eight different bank groups.  Weight rows use the
// same stride.  The host mirrors every size here in
// kernels/spiking_conv.py:plan_mma_tiles.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_tile.cuh"

namespace snn {

constexpr int kMmaWarps = 8;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaTiles = 2;   // m-tiles a warp holds
constexpr int kMaxMTiles = kMmaWarps * kMmaTiles;

__host__ __device__ inline int round_up(int a, int b) {
  return (a + b - 1) / b * b;
}

// Sizes of one launch, in elements.  BF16 = true for kernels B and C (bf16
// halo, three bf16 weight planes, a float32 staging copy of the raw input
// rows, and the membrane: a float slot per thread and C-fragment site);
// false for kernel E (float32 halo, two TF32 weight planes).
template <bool BF16>
struct MmaDims {
  int kp, cs, nc, taps, halo_pix, cin4, m, m_tiles;
  __host__ __device__ MmaDims(const ConvShape& s, int nc_)
      : kp(round_up(s.Cin, BF16 ? 16 : 8)),
        cs(kp + (BF16 ? 8 : 4)),
        nc(nc_),
        taps(s.R * s.R),
        halo_pix(s.halo_rows() * s.w_pad()),
        cin4(round_up(s.Cin, 4)),
        m(s.BR * s.E_w),
        m_tiles((s.BR * s.E_w + 15) / 16) {}
  __host__ __device__ int planes() const { return BF16 ? 3 : 2; }
  __host__ __device__ size_t weight_elems() const {
    return (size_t)planes() * taps * nc * cs;
  }
  __host__ __device__ size_t halo_elems() const {
    return (size_t)halo_pix * cs;
  }
  // float32 staging of the raw input rows and the membrane slots (kernels
  // B and C only)
  __host__ __device__ size_t stage_floats() const {
    return BF16 ? (size_t)halo_pix * cin4 : 0;
  }
  __host__ __device__ size_t membrane_floats() const {
    return BF16 ? (size_t)kMmaThreads * kMmaTiles * 4 * (nc / 8) : 0;
  }
  __host__ __device__ size_t smem_bytes() const {
    const size_t elt = BF16 ? 2 : 4;
    return (weight_elems() + halo_elems()) * elt +
           (stage_floats() + membrane_floats()) * 4;
  }
};

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t (&r)[2]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

// ldmatrix with .trans: each 8x8 matrix arrives transposed, so rows that
// hold the K axis contiguous in shared memory give the A and B fragments
// of a GEMM whose K runs down the rows (the weight gradient's positions)
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t addr,
                                              uint32_t (&r)[2]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr)
      : "memory");
}

// d = a (16x16, row) * b (16x8, col); bf16 inputs, float32 results (the
// accumulators start from zero)
__device__ __forceinline__ void mma_bf16_zero(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

// d += a (16x16, row) * b (16x8, col); bf16 inputs, float32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a (16x8, row) * b (8x8, col); TF32 inputs, float32 accumulators
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// float32 -> TF32 (10 explicit mantissa bits), round to nearest, ties away
// from zero: cvt.rna.tf32.f32's rounding, by integer operations on the bits
// (add half a TF32 ulp to the magnitude, clear the 13 dropped bits), since
// the conversion unit that cvt uses issues at a quarter of their rate and
// kernel E rounds in its inner loop.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// Start the asynchronous copy of the halo rows of row-block i of one
// (H, W, Cin) image into dst[pix * stride + ci], zeros outside the image:
// 16 bytes a copy when Cin is a multiple of 4, else 4.
__device__ __forceinline__ void issue_halo(float* dst, int stride,
                                           const float* __restrict__ img,
                                           const ConvShape& s, int i) {
  const int w_pad = s.w_pad(), row0 = i * s.BR - s.pad_lo;
  const bool vec = s.Cin % 4 == 0;
  const int q4 = vec ? s.Cin / 4 : s.Cin, width = vec ? 4 : 1;
  const int n = s.halo_rows() * w_pad * q4;
  Walk wk(threadIdx.x, blockDim.x, w_pad, q4);
  for (int u = threadIdx.x; u < n; u += blockDim.x, wk.next()) {
    const int iy = row0 + wk.row, ix = wk.col - s.pad_lo;
    const bool ok = iy >= 0 && iy < s.H && ix >= 0 && ix < s.W;
    const float* src =
        ok ? img + ((size_t)iy * s.W + ix) * s.Cin + width * wk.q : img;
    const uint32_t at = smem_u32(
        dst + (size_t)(wk.row * w_pad + wk.col) * stride + width * wk.q);
    if (vec)
      cp_async16(at, src, ok);
    else
      cp_async4(at, src, ok);
  }
  cp_async_commit();
}

// The next (tap, k step) to load, in the fixed order: taps (dy, dx)
// row-major, then the k steps of the tap.
struct TapWalk {
  int dy = 0, dx = 0, kk = 0;
  __device__ __forceinline__ void next(int R, int ksteps) {
    if (++kk == ksteps) {
      kk = 0;
      if (++dx == R) {
        dx = 0;
        ++dy;
      }
    }
  }
};

// The pixel (row of the M tile) of a block, and whether it is an output.
struct Pixel {
  int ly, lx, y;
  bool active;
  __device__ Pixel(const ConvShape& s, int m, int i, int p) {
    ly = p / s.E_w;
    lx = p % s.E_w;
    y = i * s.BR + ly;
    active = p < m && y < s.E_h;
  }
};

// The byte offset in the halo of the row this lane hands ldmatrix for
// m-tile `tile` (the tap-(0, 0) window): row (lane & 7) + 8 * bit 3 of the
// lane, k offset 8 (bf16) or 4 (TF32) elements for lanes 16-31.  Rows past
// the block's pixels read pixel 0; their results are never stored.
template <bool BF16>
__device__ __forceinline__ uint32_t a_row_offset(const ConvShape& s, int m,
                                                 int cs, int tile, int lane) {
  int p = tile * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  if (p >= m) p = 0;
  const int hp = (p / s.E_w) * s.w_pad() + p % s.E_w;
  const int koff = (lane >> 4) * (BF16 ? 8 : 4);
  return (uint32_t)(hp * cs + koff) * (BF16 ? 2 : 4);
}

// The byte offset in a weight plane of the row this lane hands ldmatrix.x2
// for n-tile 0 of tap 0, k step 0: channel lane & 7, k offset 8 (bf16) or
// 4 (TF32) elements for lanes 8-15.
template <bool BF16>
__device__ __forceinline__ uint32_t b_row_offset(int cs, int lane) {
  const int koff = ((lane >> 3) & 1) * (BF16 ? 8 : 4);
  return (uint32_t)((lane & 7) * cs + koff) * (BF16 ? 2 : 4);
}

// Store the channel pair (co, co+1) of one pixel, masked at Cout: one
// float2 when both are in range and aligned, scalars otherwise.
__device__ __forceinline__ void store_pair(float* dst, float a, float b,
                                           int co, int Cout) {
  if (co + 1 < Cout && (Cout & 1) == 0) {
    *reinterpret_cast<float2*>(dst) = make_float2(a, b);
  } else {
    if (co < Cout) dst[0] = a;
    if (co + 1 < Cout) dst[1] = b;
  }
}

}  // namespace snn
