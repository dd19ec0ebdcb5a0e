// Weight gradient of the spiking conv for Hopper (sm_90a): dw and db of the
// forward conv from its input x and output cotangent dz, every tap and the
// bias in one pass over both.
//
// Replaces no TPU kernel: the reference computes it with XLA ops
// (repro/kernels/spiking_conv.py: conv_grad_weights_xla, one
// (Cin, N*E_h*E_w) @ (N*E_h*E_w, Cout) product per tap), and the port did
// the same with torch ops until this kernel: a padded copy of x, a sliced
// copy of it per tap and a float32 cuBLAS GEMM per tap, 11.5 of a 13.7 ms
// train step on the card.  For tap (dy, dx) of the forward conv (pads lo,
// hi):
//   dw[dy, dx, ci, co] = sum_m x[n, y + dy - lo, x + dx - lo, ci] dz[m, co]
//   db[co]             = sum_m dz[m, co]
// over the M = N * E_h * E_w output positions m = (n, y, x); x is zero
// outside the image.  The caller folds T x batch into N.
//
// On the main path it runs the backward of snn-mnist (T * B = 8 * 256):
//   layer 1  x (2048, 30, 30, 16) spikes, dz (2048, 32, 32, 32)
//   layer 2  x (2048, 32, 32, 32) spikes, dz (2048, 34, 34, 8)
//   layer 0  x (256, 28, 28, 1) frames,   dz (256, 30, 30, 16)  (analog)
//
// What bounds it on the H100 (x and dz read once, dw and db written once;
// the forward conv's products, 2 * M * R * R * Cin * Cout FLOPs):
//   layer 1  386.4 MB: 0.115 ms at 3.35 TB/s;  19.3 GFLOP
//   layer 2  344.2 MB: 0.103 ms;                10.9 GFLOP
//   layer 0   15.5 MB: 0.005 ms;                 0.07 GFLOP
// and the three bf16 products a product takes here (below) run 58 and 33
// GFLOP on the tensor cores, 0.059 and 0.033 ms at 989 TFLOP/s: both
// spiking layers are bound by their bytes.
//
// The GEMM view.  Per tap, dw[tap] (Cin x Cout) = A (Cin x M) . B (M x
// Cout), K = M: A is x shifted by the tap and transposed, B is dz.  A block
// stages a tile of block_rows x block_cols output positions of one image
// (whole rows on snn-mnist, a third of a row on snn-seg's 162-172): dz's
// rows, and x's halo ((block_rows + R - 1) x (block_cols + R - 1) input
// pixels) once, and every tap's product reads the one halo shifted by
// (dy, dx), as kernel E does; there is no im2col copy and no padded copy,
// the pads being zeros that the staging writes.  K runs over the tile's
// positions row by row in k16 steps; positions past the image or the tile
// have zero dz rows.  Both are staged with the channels of a position
// contiguous ([position][channel], rows of an odd number of 16-byte
// units), so ldmatrix with .trans hands out the A fragment (m = ci, k =
// position) and the B fragment (k = position, n = co).  A m16 tile covers 16 input channels, an n8 tile 8
// output channels; a block takes up to 32 of each (wider layers add
// channel groups on the grid).  The bias is one more "tap" whose A
// fragment is all ones (no load): its rows all hold dz's column sums, so
// db comes from the same staged tiles and the same MMAs.
//
// Operands at float32 accuracy.  x on a spiking layer is 0 or 1, exact in
// bf16.  dz is split exactly into three bf16 parts, hi = bf16(dz), mid =
// bf16(dz - hi), lo = bf16(dz - hi - mid) (kernel B's split of its
// weights, kernels/ref.py:split_bf16x3: hi + mid + lo == dz), as the
// staged rows are converted, so every product x * part is exact.  Each
// (k16 step, tile) issues three m16n8k16 MMAs into a fresh accumulator,
// lo, then mid, then hi (the smallest first), and adds the result to the
// running float32 sum with one rounding: the tensor core's truncating adds
// touch only 48 products at a time, and the long sum over M rounds to
// nearest, as a float32 GEMM's does.  (E's 3xTF32 split would need x's
// positions contiguous for its ldmatrix, and four TF32 MMAs of half the
// rate per 16 positions against three bf16 ones.)  A tile whose staged x
// holds a value that is neither 0 nor 1 takes the analog route below for
// its products instead, so the spike instance is right for any input.
//
// Analog inputs (the hoisted first layer's frames: ANALOG = true, the
// instance a caller takes for any input it does not know to be spikes):
// the same tiles, fragments and sums, each thread's accumulator sites
// summed with float32 FMAs on the CUDA cores, position by position, from
// the staged float32 tile (0.07 GFLOP on mnist layer 0).
//
// The warps.  The R * R taps plus the bias "tap" are dealt round-robin to
// tap_groups groups of warps (8 / tap_groups warps a group when
// tap_groups <= 8; beyond, the groups go on the grid too), so a warp holds
// at most kAccTiles 16x8 accumulator tiles, and the warps of a group split
// the tile's k16 steps between them.  A warp loads dz's B fragments of a
// k step once for all its taps, and x's A fragment once per tap and m
// tile.  The MMAs of a tap slot go stage by stage (every lo product, then
// every mid, then every hi), so each warp has its tiles' MMAs in flight
// at once.  The accumulators take the registers (one block an SM), so the
// raw staging is double-buffered instead: a tile's copies start while the
// tile before it is converted and multiplied.  Measured on an H100 at
// snn-mnist's shapes (variants of this source with parts left out), a
// layer's MMAs take about half its time, and the staging and conversion,
// which one block cannot overlap with them, the other half.
//
// The reduction across blocks, in a fixed order and with no atomics.  The
// tiles are dealt to `chains` accumulation chains, tile t to chain t %
// chains, each summed by one block in tile order; persistent blocks, as
// many as fit the card, each take chains b, b + gridDim.x, ...  At a
// chain's end the block adds its warps' sums of the chain in warp order
// and writes them to partial[chain] (scratch the wrapper allocates), and a
// second launch sums the chains in order, in float64, into dw and db.  So
// the bits depend on the shape's plan (the tile, tap_groups, chains:
// planned from M and the widths) and not on how many blocks ran, nor on
// their timing.  The launches allocate nothing and never synchronize, so
// they capture in a CUDA graph.
#include "mma_tile.cuh"

namespace {

using snn::ConvShape;

constexpr int kThreads = snn::kMmaThreads;
constexpr int kWarps = snn::kMmaWarps;
// 16x8 accumulator tiles a warp holds (80 float registers a thread): tap
// slots x m tiles x n tiles
constexpr int kAccTiles = 20;
// bf16 1.0 in both halves: the bias tap's A fragment
constexpr uint32_t kOnes = 0x3F803F80u;

// wait until at most N of this thread's committed copy groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The plan of one launch beside the conv's geometry (s: H, W, Cin, Cout,
// R, pad_lo, E_h, E_w; s.BR the tile's rows).  Host and device.
struct Plan {
  ConvShape s;
  int N, BC, tap_groups, chains;
  __host__ __device__ int taps() const { return s.R * s.R; }
  __host__ __device__ int tile_pos() const { return s.BR * BC; }
  __host__ __device__ int ksteps() const { return (tile_pos() + 15) / 16; }
  __host__ __device__ int row_blocks() const {
    return (s.E_h + s.BR - 1) / s.BR;
  }
  __host__ __device__ int col_blocks() const { return (s.E_w + BC - 1) / BC; }
  __host__ __device__ int tiles() const {
    return N * row_blocks() * col_blocks();
  }
  // the halo's pixels: (BR + R - 1) rows of (BC + R - 1)
  __host__ __device__ int halo_w() const { return BC + s.R - 1; }
  __host__ __device__ int halo_pix() const {
    return (s.BR + s.R - 1) * halo_w();
  }
  // tap groups in a block (QT) and blocks' worth of them on the grid
  __host__ __device__ int qt() const {
    return tap_groups < kWarps ? tap_groups : kWarps;
  }
  __host__ __device__ int split() const { return tap_groups / qt(); }
  __host__ __device__ int cin4() const { return snn::round_up(s.Cin, 4); }
  __host__ __device__ int cin16() const { return snn::round_up(s.Cin, 16); }
  // a staged x pixel's row, in bf16: cin16 plus one 16-byte unit
  __host__ __device__ int xcs() const { return cin16() + 8; }
  __host__ __device__ int nc8() const { return snn::round_up(s.Cout, 8); }
  // a staged dz row: the three planes' nc8 columns, rounded up to an odd
  // number of 16-byte units
  __host__ __device__ int zcs() const { return 8 * ((3 * nc8() / 8) | 1); }
  __host__ __device__ int cin_groups() const { return (s.Cin + 31) / 32; }
  __host__ __device__ int cout_groups() const { return (s.Cout + 31) / 32; }
  __host__ __device__ int grid_y() const {
    return split() * cin_groups() * cout_groups();
  }
  __host__ __device__ int out_elems() const {
    return taps() * s.Cin * s.Cout + s.Cout;
  }
};

template <int MT, int NT>
struct Acc {
  static constexpr int TW = kAccTiles / (MT * NT);   // tap slots
  float v[TW][MT][NT][4];
};

// Shared memory, in bytes from the start: the tap tables (each tap's
// offset in the bf16 halo, in bytes, and in the raw halo, in floats), then
// two raw float32 stagings of a tile (x's halo, then dz's rows), then one
// region holding either (not ANALOG) the bf16 halo and dz planes or, at a
// chain's end, the warps' sums.
struct Layout {
  size_t tables, raw_x, raw_dz, region, total;
  __host__ __device__ size_t raw() const { return raw_x + raw_dz; }
  template <int MT, int NT, bool ANALOG>
  __host__ __device__ static Layout of(const Plan& p) {
    Layout l;
    l.tables = snn::round_up(2 * p.taps() * 4, 16);
    l.raw_x = (size_t)p.halo_pix() * p.cin4() * 4;
    l.raw_dz = (size_t)snn::round_up(p.tile_pos() * p.s.Cout, 4) * 4;
    const size_t staged =
        ANALOG ? 0
               : ((size_t)p.halo_pix() * p.xcs() +
                  (size_t)p.ksteps() * 16 * p.zcs()) * 2;
    const size_t red = (size_t)p.qt() * Acc<MT, NT>::TW * MT * NT * 128 * 4;
    l.region = staged > red ? staged : red;
    l.total = l.tables + 2 * l.raw() + l.region;
    return l;
  }
};

// One tile: image n, output rows y0.., columns x0..; rows and cols of them
// inside the image.
struct Tile {
  int n, y0, x0, rows, cols;
  __device__ Tile(const Plan& p, int t) {
    const int cb = p.col_blocks(), rb = p.row_blocks();
    n = t / (rb * cb);
    y0 = t / cb % rb * p.s.BR;
    x0 = t % cb * p.BC;
    rows = min(p.s.BR, p.s.E_h - y0);
    cols = min(p.BC, p.s.E_w - x0);
  }
};

// Start the copies of a tile's halo (zeros outside the image: 16 bytes a
// copy when Cin is a multiple of 4, else 4) and dz rows into the raw
// staging buffers, and commit.
__device__ __forceinline__ void issue_tile(float* raw_x, float* raw_dz,
                                           const float* __restrict__ x,
                                           const float* __restrict__ dz,
                                           const Plan& p, const Tile& tl) {
  const ConvShape& s = p.s;
  const float* img = x + (size_t)tl.n * s.H * s.W * s.Cin;
  const bool vec = s.Cin % 4 == 0;
  const int q4 = vec ? s.Cin / 4 : s.Cin, width = vec ? 4 : 1;
  const int hw = p.halo_w(), cin4 = p.cin4();
  const int nx = (s.BR + s.R - 1) * hw * q4;
  snn::Walk wk(threadIdx.x, blockDim.x, hw, q4);
  for (int u = threadIdx.x; u < nx; u += blockDim.x, wk.next()) {
    const int iy = tl.y0 - s.pad_lo + wk.row, ix = tl.x0 - s.pad_lo + wk.col;
    const bool ok = iy >= 0 && iy < s.H && ix >= 0 && ix < s.W;
    const float* src =
        ok ? img + ((size_t)iy * s.W + ix) * s.Cin + width * wk.q : img;
    const uint32_t at = snn::smem_u32(
        raw_x + (size_t)(wk.row * hw + wk.col) * cin4 + width * wk.q);
    if (vec)
      snn::cp_async16(at, src, ok);
    else
      snn::cp_async4(at, src, ok);
  }
  // dz: the tile's rows of cols positions, each a contiguous run of
  // cols * Cout floats, to raw_dz[(row * BC + col) * Cout + co]
  const bool vz = s.Cout % 4 == 0;
  const int per_row = tl.cols * s.Cout / (vz ? 4 : 1), w4 = vz ? 4 : 1;
  const int nz = tl.rows * per_row;
  snn::Walk wz(threadIdx.x, blockDim.x, per_row, 1);
  for (int u = threadIdx.x; u < nz; u += blockDim.x, wz.next()) {
    const float* src = dz + (((size_t)tl.n * s.E_h + tl.y0 + wz.row) * s.E_w +
                             tl.x0) * s.Cout + w4 * wz.col;
    const uint32_t at = snn::smem_u32(
        raw_dz + (size_t)wz.row * p.BC * s.Cout + w4 * wz.col);
    if (vz)
      snn::cp_async16(at, src, true);
    else
      snn::cp_async4(at, src, true);
  }
  snn::cp_async_commit();
}

// Convert the staged halo (npix pixels of cin4 floats) into bf16 rows of
// xcs; returns whether this thread saw a value that is neither 0 nor 1.
__device__ __forceinline__ bool convert_x(__nv_bfloat16* xb,
                                          const float* raw, int npix,
                                          const Plan& p) {
  const int q4 = p.cin4() / 4, n = npix * q4, xcs = p.xcs();
  bool other = false;
  snn::Walk wk(threadIdx.x, blockDim.x, npix, q4);
  for (int u = threadIdx.x; u < n; u += blockDim.x, wk.next()) {
    const float4 v = reinterpret_cast<const float4*>(raw)[u];
    other |= (v.x != 0.f && v.x != 1.f) || (v.y != 0.f && v.y != 1.f) ||
             (v.z != 0.f && v.z != 1.f) || (v.w != 0.f && v.w != 1.f);
    __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 packed;
    packed.x = *reinterpret_cast<uint32_t*>(&lo);
    packed.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(xb + (size_t)wk.col * xcs + 4 * wk.q) = packed;
  }
  return other;
}

// hi, mid, lo of four values (each rounded to nearest even, as
// kernels/ref.py:split_bf16x3), each plane's four packed into a uint2
__device__ __forceinline__ void split4(const float (&v)[4], uint2 (&out)[3]) {
  float2 r[2] = {make_float2(v[0], v[1]), make_float2(v[2], v[3])};
#pragma unroll
  for (int pl = 0; pl < 3; ++pl) {
    uint32_t packed[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const __nv_bfloat162 part = __floats2bfloat162_rn(r[h].x, r[h].y);
      packed[h] = *reinterpret_cast<const uint32_t*>(&part);
      const float2 f = __bfloat1622float2(part);
      r[h] = make_float2(r[h].x - f.x, r[h].y - f.y);
    }
    out[pl] = make_uint2(packed[0], packed[1]);
  }
}

// Convert the staged dz rows into the three bf16 planes of each of the
// tile's ksteps * 16 rows, zeros past the image, the tile and Cout:
// zb[pos * zcs + plane * nc8 + co], pos = row * BC + col.
__device__ __forceinline__ void convert_dz(__nv_bfloat16* zb,
                                           const float* raw, const Plan& p,
                                           const Tile& tl) {
  const int cout = p.s.Cout, nc8 = p.nc8(), zcs = p.zcs();
  const int q8 = nc8 / 4, n = p.tile_pos() * q8;
  const bool vec = cout % 4 == 0;
  snn::Walk wk(threadIdx.x, blockDim.x, p.BC, q8);
  for (int u = threadIdx.x; u < n; u += blockDim.x, wk.next()) {
    const int pos = wk.row * p.BC + wk.col, c = 4 * wk.q;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (wk.row < tl.rows && wk.col < tl.cols) {
      const float* r = raw + (size_t)pos * cout + c;
      if (vec) {
        if (c < cout) {
          const float4 f = *reinterpret_cast<const float4*>(r);
          v[0] = f.x;
          v[1] = f.y;
          v[2] = f.z;
          v[3] = f.w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (c + i < cout) v[i] = r[i];
      }
    }
    uint2 planes[3];
    split4(v, planes);
    __nv_bfloat16* dst = zb + (size_t)pos * zcs + c;
#pragma unroll
    for (int pl = 0; pl < 3; ++pl)
      *reinterpret_cast<uint2*>(dst + pl * nc8) = planes[pl];
  }
  // the rows past the tile, up to the last k16 step's
  const int pad = (p.ksteps() * 16 - p.tile_pos()) * q8;
  for (int u = threadIdx.x; u < pad; u += blockDim.x) {
    __nv_bfloat16* dst =
        zb + (size_t)(p.tile_pos() + u / q8) * zcs + 4 * (u % q8);
#pragma unroll
    for (int pl = 0; pl < 3; ++pl)
      *reinterpret_cast<uint2*>(dst + pl * nc8) = make_uint2(0u, 0u);
  }
}

// What a warp owns: its tap group and its share of the k16 steps, and the
// block's channel group.
struct Warp {
  int lane, gq, tq, pg, P, gidx, TG, ci0, co0;
  bool db_group;   // the block whose channel group writes db
};

// The tensor-core route of one tile: every k16 step of the warp's share up
// to the tile's last row inside the image, every tap slot, m tile and n
// tile.
template <int MT, int NT>
__device__ __forceinline__ void mma_tile(Acc<MT, NT>& acc, const Plan& p,
                                         const Warp& w, const int* toff,
                                         uint32_t xb_base, uint32_t zb_base,
                                         const Tile& tl) {
  constexpr int TW = Acc<MT, NT>::TW;
  const int taps = p.taps(), cin16 = p.cin16(), tp = p.tile_pos();
  const int nc8 = p.nc8(), zcs = p.zcs(), xcs = p.xcs();
  const int limit = tl.rows * p.BC;   // positions in the image's rows
  // each tap slot's offset in the bf16 halo, in registers (ldmatrix's
  // memory clobber would reload it from shared memory at every load)
  uint32_t tof[TW];
#pragma unroll
  for (int j = 0; j < TW; ++j) {
    const int t = w.gidx + w.TG * j;
    tof[j] = t < taps ? (uint32_t)toff[t] : 0u;
  }
  // this lane's column of each ldmatrix of dz's combos (plane, n tile),
  // two combos an x4; channels past the layer read column 0
  uint32_t bcol[(3 * NT + 1) / 2];
#pragma unroll
  for (int c = 0; c < 3 * NT; c += 2) {
    const int cc = c + 1 < 3 * NT ? c + (w.lane >> 4) : c;
    const int col = w.co0 + cc % NT * 8;
    bcol[c / 2] = (uint32_t)(cc / NT * nc8 + (col < nc8 ? col : 0)) * 2;
  }
  for (int kk = w.pg; kk * 16 < limit; kk += w.P) {
    uint32_t b[3][NT][2];
    const int pb = kk * 16 + (w.lane & 7) + ((w.lane >> 3) & 1) * 8;
    const uint32_t zrow = zb_base + (uint32_t)(pb * zcs) * 2;
#pragma unroll
    for (int c = 0; c < 3 * NT; c += 2) {
      if (c + 1 < 3 * NT) {
        const int c1 = c + 1 < 3 * NT ? c + 1 : c;   // in bounds, unrolled
        uint32_t r[4];
        snn::ldsm_x4_trans(zrow + bcol[c / 2], r);
        b[c / NT][c % NT][0] = r[0];
        b[c / NT][c % NT][1] = r[1];
        b[c1 / NT][c1 % NT][0] = r[2];
        b[c1 / NT][c1 % NT][1] = r[3];
      } else {
        uint32_t r[2];
        snn::ldsm_x2_trans(zrow + bcol[c / 2], r);
        b[c / NT][c % NT][0] = r[0];
        b[c / NT][c % NT][1] = r[1];
      }
    }
    // the halo pixel of this lane's position (the tap-(0, 0) window); the
    // padding rows past the tile read pixel 0, against zero dz rows
    const int pa = kk * 16 + (w.lane & 7) + ((w.lane >> 4) & 1) * 8;
    const int ly = pa / p.BC;
    const int hp = pa < tp ? ly * p.halo_w() + pa - ly * p.BC : 0;
    const uint32_t arow =
        xb_base + (uint32_t)(hp * xcs + w.ci0 + ((w.lane >> 3) & 1) * 8) * 2;
#pragma unroll
    for (int j = 0; j < TW; ++j) {
      const int t = w.gidx + w.TG * j;
      if (t > taps) break;
      // the slot's m tiles (the bias tap has one: its rows are all equal)
      // and n tiles inside the layer
      bool m_in[MT], n_in[NT];
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        m_in[mt] = t == taps ? mt == 0 : w.ci0 + 16 * mt < cin16;
#pragma unroll
        for (int k = 0; k < 4; ++k) a[mt][k] = kOnes;
        if (t < taps && m_in[mt])
          snn::ldsm_x4_trans(arow + tof[j] + mt * 32, a[mt]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) n_in[nt] = w.co0 + 8 * nt < nc8;
      float d[MT][NT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          if (m_in[mt] && n_in[nt])
            snn::mma_bf16_zero(d[mt][nt], a[mt], b[2][nt]);
#pragma unroll
      for (int pl = 1; pl >= 0; --pl)   // mid, then hi
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            if (m_in[mt] && n_in[nt])
              snn::mma_bf16(d[mt][nt], a[mt], b[pl][nt]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          if (m_in[mt] && n_in[nt])
#pragma unroll
            for (int k = 0; k < 4; ++k) acc.v[j][mt][nt][k] += d[mt][nt][k];
    }
  }
}

// The analog route of one tile: the same sites, summed with FMAs position
// by position from the staged float32 tile (raw_x: the halo, [pixel][cin4];
// raw_dz: [row * BC + col][Cout]; xoff: each tap's offset in raw_x).
template <int MT, int NT>
__device__ __forceinline__ void fma_tile(Acc<MT, NT>& acc, const float* raw_x,
                                         const float* raw_dz, const Plan& p,
                                         const Warp& w, const int* xoff,
                                         const Tile& tl) {
  constexpr int TW = Acc<MT, NT>::TW;
  const ConvShape& s = p.s;
  const int taps = p.taps(), limit = tl.rows * p.BC, cin4 = p.cin4();
  int xo[TW];   // each tap slot's offset in the raw halo, in registers
#pragma unroll
  for (int j = 0; j < TW; ++j) {
    const int t = w.gidx + w.TG * j;
    xo[j] = t < taps ? xoff[t] : 0;
  }
  for (int kk = w.pg; kk * 16 < limit; kk += w.P) {
    const int end = min(16, limit - kk * 16);
    for (int r = 0; r < end; ++r) {
      const int pos = kk * 16 + r, ly = pos / p.BC, lx = pos - ly * p.BC;
      if (lx >= tl.cols) continue;
      const float* zp = raw_dz + (size_t)pos * s.Cout;
      const float* xp = raw_x + (size_t)(ly * p.halo_w() + lx) * cin4;
      float za[NT], zb[NT];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int co = w.co0 + nt * 8 + 2 * w.tq;
        za[nt] = co < s.Cout ? zp[co] : 0.f;
        zb[nt] = co + 1 < s.Cout ? zp[co + 1] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < TW; ++j) {
        const int t = w.gidx + w.TG * j;
        if (t > taps) break;
        float xa[MT], xb[MT];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int ci = w.ci0 + 16 * mt + w.gq;
          xa[mt] = t == taps ? 1.f : ci < s.Cin ? xp[xo[j] + ci] : 0.f;
          xb[mt] = t == taps ? 1.f : ci + 8 < s.Cin ? xp[xo[j] + ci + 8]
                                                    : 0.f;
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            float* a = acc.v[j][mt][nt];
            a[0] = fmaf(xa[mt], za[nt], a[0]);
            a[1] = fmaf(xa[mt], zb[nt], a[1]);
            a[2] = fmaf(xb[mt], za[nt], a[2]);
            a[3] = fmaf(xb[mt], zb[nt], a[3]);
          }
      }
    }
  }
}

// A chain's end: add the warps' sums in position-group order into red (the
// region, free once every warp is done with the tile), write this block's
// entries of partial[chain], and zero the sums.
template <int MT, int NT>
__device__ __forceinline__ void write_chain(Acc<MT, NT>& acc, float* red,
                                            float* __restrict__ partial,
                                            const Plan& p, const Warp& w,
                                            int q, int chain) {
  constexpr int TW = Acc<MT, NT>::TW;
  const ConvShape& s = p.s;
  const int taps = p.taps(), QT = p.qt();
  // red[((((q * TW + j) * MT + mt) * NT + nt) * 4 + k) * 32 + lane]
  float* mine = red + (size_t)q * TW * MT * NT * 128 + w.lane;
  for (int g = 0; g < w.P; ++g) {
    __syncthreads();
    if (w.pg == g) {
#pragma unroll
      for (int j = 0; j < TW; ++j)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              float& r = mine[(((j * MT + mt) * NT + nt) * 4 + k) * 32];
              r = g == 0 ? acc.v[j][mt][nt][k] : r + acc.v[j][mt][nt][k];
              acc.v[j][mt][nt][k] = 0.f;
            }
    }
  }
  __syncthreads();
  const int n_red = QT * TW * MT * NT * 128;
  float* out = partial + (size_t)chain * p.out_elems();
  const int split0 = w.gidx - w.gidx % QT;   // this block's first group
  for (int e = threadIdx.x; e < n_red; e += blockDim.x) {
    const int lane = e % 32, k = e / 32 % 4, nt = e / 128 % NT;
    const int mt = e / (128 * NT) % MT, j = e / (128 * NT * MT) % TW;
    const int grp = e / (128 * NT * MT * TW);
    const int t = split0 + grp + w.TG * j;
    const int ci = w.ci0 + 16 * mt + lane / 4 + 8 * (k >> 1);
    const int co = w.co0 + 8 * nt + 2 * (lane % 4) + (k & 1);
    if (t > taps || co >= s.Cout) continue;
    if (t == taps) {
      // the bias: row 0 of the ones tap, from one channel group of Cin
      if (w.db_group && mt == 0 && lane / 4 == 0 && k < 2)
        out[taps * s.Cin * s.Cout + co] = red[e];
    } else if (ci < s.Cin) {
      out[((size_t)t * s.Cin + ci) * s.Cout + co] = red[e];
    }
  }
}

template <int MT, int NT, bool ANALOG>
__global__ void __launch_bounds__(kThreads, 1)
conv_grad_weights_kernel(const float* __restrict__ x,
                         const float* __restrict__ dz,
                         float* __restrict__ partial, Plan p) {
  constexpr int TW = Acc<MT, NT>::TW;
  const ConvShape& s = p.s;
  const Layout l = Layout::of<MT, NT, ANALOG>(p);
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  int* toff = reinterpret_cast<int*>(base);
  int* xoff = toff + p.taps();
  // raw staging set b: x's halo at raw(b), dz's rows after it
  auto raw = [&](int b) {
    return reinterpret_cast<float*>(base + l.tables + b * l.raw());
  };
  char* region = base + l.tables + 2 * l.raw();
  __nv_bfloat16* xb = reinterpret_cast<__nv_bfloat16*>(region);
  __nv_bfloat16* zb = xb + (size_t)p.halo_pix() * p.xcs();
  float* red = reinterpret_cast<float*>(region);

  const int warp = threadIdx.x >> 5, QT = p.qt(), q = warp % QT;
  // blockIdx.y: (tap split, Cin group, Cout group)
  const int cg = blockIdx.y % p.cout_groups();
  const int mg = blockIdx.y / p.cout_groups() % p.cin_groups();
  const int sidx = blockIdx.y / (p.cout_groups() * p.cin_groups());
  Warp w;
  w.lane = threadIdx.x & 31;
  w.gq = w.lane >> 2;
  w.tq = w.lane & 3;
  w.pg = warp / QT;
  w.P = kWarps / QT;
  w.TG = p.tap_groups;
  w.gidx = sidx * QT + q;
  w.ci0 = 32 * mg;
  w.co0 = 32 * cg;
  w.db_group = mg == 0;

  for (int t = threadIdx.x; t < p.taps(); t += blockDim.x) {
    const int off = t / s.R * p.halo_w() + t % s.R;
    toff[t] = off * p.xcs() * 2;
    xoff[t] = off * p.cin4();
  }
  // the raw halos' pad channels (Cin not a multiple of 4) are never
  // written again
  for (int b = 0; b < 2; ++b)
    for (size_t k = threadIdx.x; k < l.raw_x / 16; k += blockDim.x)
      reinterpret_cast<float4*>(raw(b))[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  Acc<MT, NT> acc;
#pragma unroll
  for (int j = 0; j < TW; ++j)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc.v[j][mt][nt][k] = 0.f;

  const int n_tiles = p.tiles();
  const size_t dz_at = l.raw_x / 4;   // dz's rows in a staging set, floats
  const uint32_t xb_base = snn::smem_u32(xb), zb_base = snn::smem_u32(zb);
  int chain = blockIdx.x, tile = chain, buf = 0;
  if (chain < p.chains) {
    float* r0 = raw(0);
    issue_tile(r0, r0 + dz_at, x, dz, p, Tile(p, tile));
  }
  while (chain < p.chains) {
    const Tile tl(p, tile);
    // the next tile of this block: the chain's next, or the next chain's
    // first; its copies start now, into the other staging set, which no
    // warp reads any more
    int next = tile + p.chains, next_chain = chain;
    if (next >= n_tiles) {
      next_chain = chain + gridDim.x;
      next = next_chain;
    }
    if (next_chain < p.chains) {
      float* rn = raw(buf ^ 1);
      issue_tile(rn, rn + dz_at, x, dz, p, Tile(p, next));
      cp_async_wait_group<1>();
    } else {
      cp_async_wait_group<0>();
    }
    // this tile's rows have landed, and every warp is done with the last
    // tile's bf16 rows (or the chain's sums)
    __syncthreads();
    const float* rx = raw(buf);
    int other = 1;
    if (!ANALOG) {
      const bool mine = convert_x(xb, rx, p.halo_pix(), p);
      convert_dz(zb, rx + dz_at, p, tl);
      other = __syncthreads_or(mine);
    }
    if (other) {
      fma_tile(acc, rx, rx + dz_at, p, w, xoff, tl);
      __syncthreads();   // the staging set is written again next tile
    } else {
      mma_tile(acc, p, w, toff, xb_base, zb_base, tl);
    }
    if (next_chain != chain) write_chain(acc, red, partial, p, w, q, chain);
    chain = next_chain;
    tile = next;
    buf ^= 1;
  }
}

// dw, db = the sums of the chains' partials, chain by chain in order, in
// float64: a block of 32 entries, warp k summing chains k, k + 8, ..., the
// eight warps then added in order.
__global__ void __launch_bounds__(kThreads)
reduce_chains(const float* __restrict__ partial, float* __restrict__ dw,
              float* __restrict__ db, int chains, int out_elems,
              int dw_elems) {
  __shared__ double sums[kWarps][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int e = blockIdx.x * 32 + lane;
  double acc = 0.0;
  if (e < out_elems)
    for (int c = warp; c < chains; c += kWarps)
      acc += (double)partial[(size_t)c * out_elems + e];
  sums[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && e < out_elems) {
    double tot = 0.0;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) tot += sums[k][lane];
    if (e < dw_elems)
      dw[e] = (float)tot;
    else
      db[e - dw_elems] = (float)tot;
  }
}

template <int MT, int NT, bool ANALOG>
int launch(const float* x, const float* dz, float* partial, float* dw,
           float* db, const Plan& p, int max_blocks, cudaStream_t stream) {
  constexpr int TW = Acc<MT, NT>::TW;
  const int tg = p.tap_groups;
  // the plan (kernels/spiking_conv.py:plan_wgrad) must fit the instance
  if (tg < 1 || (tg < kWarps && (kWarps % tg) != 0) ||
      (tg > kWarps && tg % kWarps != 0) ||
      (p.taps() + 1 + tg - 1) / tg > TW || p.s.BR < 1 || p.BC < 1 ||
      p.chains < 1 || p.chains > p.tiles())
    return (int)cudaErrorInvalidValue;
  const size_t smem = Layout::of<MT, NT, ANALOG>(p).total;
  auto kernel = conv_grad_weights_kernel<MT, NT, ANALOG>;
  cudaError_t err = snn::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  // persistent blocks: as many as are resident at once, shared by the
  // groups on the grid's y axis, and no more than the chains
  long blocks = (long)sms * per_sm / p.grid_y();
  if (blocks < 1) blocks = 1;
  if (blocks > p.chains) blocks = p.chains;
  if (max_blocks > 0 && blocks > max_blocks) blocks = max_blocks;
  kernel<<<dim3((unsigned)blocks, p.grid_y()), kThreads, smem, stream>>>(
      x, dz, partial, p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int out = p.out_elems();
  reduce_chains<<<(out + 31) / 32, kThreads, 0, stream>>>(
      partial, dw, db, p.chains, out, out - p.s.Cout);
  return (int)cudaGetLastError();
}

template <bool ANALOG>
int dispatch(const float* x, const float* dz, float* partial, float* dw,
             float* db, const Plan& p, int max_blocks, cudaStream_t st) {
  // m16 tiles of a block's input channels, n8 tiles of its output channels
  const int mt = p.s.Cin > 16 ? 2 : 1;
  const int nt = p.s.Cout > 16 ? 4 : (p.s.Cout > 8 ? 2 : 1);
  switch (mt * 10 + nt) {
    case 11:
      return launch<1, 1, ANALOG>(x, dz, partial, dw, db, p, max_blocks, st);
    case 12:
      return launch<1, 2, ANALOG>(x, dz, partial, dw, db, p, max_blocks, st);
    case 14:
      return launch<1, 4, ANALOG>(x, dz, partial, dw, db, p, max_blocks, st);
    case 21:
      return launch<2, 1, ANALOG>(x, dz, partial, dw, db, p, max_blocks, st);
    case 22:
      return launch<2, 2, ANALOG>(x, dz, partial, dw, db, p, max_blocks, st);
    case 24:
      return launch<2, 4, ANALOG>(x, dz, partial, dw, db, p, max_blocks, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x (N, H, W, Cin) the forward's input, dz (N, E_h, E_w, Cout) its output
// cotangent -> dw (R, R, Cin, Cout), db (Cout,); partial (chains,
// R*R*Cin*Cout + Cout) scratch; float32, contiguous, on the stream's
// device.  pad_lo is the forward's.  block_rows, block_cols, tap_groups
// and chains are the plan (kernels/spiking_conv.py:plan_wgrad); max_blocks
// caps the persistent blocks (0: as many as fit), which leaves the bits as
// they are.  analog != 0 takes the instance for inputs that are not
// spikes.  Two launches: the tiles, then the chains' sum.  Returns a
// cudaError_t.
extern "C" int conv_grad_weights_launch(const float* x, const float* dz,
                                        float* partial, float* dw, float* db,
                                        int N, int H, int W, int Cin,
                                        int Cout, int R, int pad_lo, int E_h,
                                        int E_w, int block_rows,
                                        int block_cols, int tap_groups,
                                        int chains,
                                        int max_blocks, int analog,
                                        void* stream) {
  const Plan p{ConvShape{H, W, Cin, Cout, R, pad_lo, E_h, E_w, block_rows},
               N, block_cols, tap_groups, chains};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return analog ? dispatch<true>(x, dz, partial, dw, db, p, max_blocks, st)
                : dispatch<false>(x, dz, partial, dw, db, p, max_blocks, st);
}
