// Spike-driven convolution for Hopper (sm_90a), kernel A, in two modes:
//
//   dV mode       spiking_conv_launch: dV = conv(x, w) + bias;
//   hoisted mode  spiking_conv_lif_hoisted_launch: dV once, then T steps of
//                 LIF on the constant current dV, writing the spike train
//                 (and, with SAVE_U, the pre-reset membrane u; with COUNT,
//                 the train's spike counts).
//
// Replaces the TPU kernel repro/kernels/spiking_conv.py:spiking_conv_pallas
// (kernel body _make_kernel); the hoisted mode also takes in the LIF scan
// the reference runs on its output for the hoisted first layer
// (repro/core/snn_model.py:_lif_scan_const).  On the main path it is the
// first layer of snn-mnist: frames x (B, 28, 28, 1) float32, w (3, 3, 1,
// 16), APRC full padding, out (T, B, 30, 30, 16); all NHWC x RRIO.
//
// What bounds it on the H100.  The hoisted mode at batch 256, T=8 reads
// 0.80 MB of frames and 14.75 MB of v0 and writes 117.96 MB of spikes and
// 14.75 MB of v_final (plus 117.96 MB of u under SAVE_U): 148.3 MB, 0.044
// ms at 3.35 TB/s (266.2 MB, 0.080 ms), against 0.19 GFLOP of taps and
// membrane updates, 0.003 ms at 67 TFLOP/s.  The dV mode writes 14.75 MB.
// Both are bound by their stores, so the design spends nothing on the
// arithmetic and makes every store dense:
//
//   - each thread owns one output pixel and four consecutive channels (a
//     quad) and writes them as one 16-byte store per output and step, the
//     quads of a pixel on neighbouring threads, so a warp's store covers
//     512 contiguous bytes;
//   - the current dV and the membrane stay in registers across all T
//     steps: every output byte is written once and nothing is read back;
//   - one block per (image, row-block of BR full output rows, channel
//     group), in a one-dimensional grid whose consecutive blocks write
//     consecutive memory; the main path's 2,048 blocks of 480 threads
//     keep all 132 SMs busy;
//   - the block's weight tile and the halo rows of its frame go to shared
//     memory by cp.async (zero-filled outside the image), overlapping the
//     load of v0.
//
// The sum.  Each output sums its taps in the plain path's order with the
// plain path's two roundings per tap (conv_tile.cuh: tap_add), then adds
// the bias; the LIF steps are the plain path's float operations
// (core/snn_model.py:_lif_scan): v = v + dV; s = (v - v_th >= 0);
// v = v - v_th * s, each rounded as written.  So dV, the spike train, u and
// v_final have the plain version's bits on an analog input (the direct-
// coded frame).  A's tap sum is its own (tap_add); the float32 path of
// kernels B and C (tap_sum) uses the same function, so they round alike.
//
// The skip.  A block whose halo rows hold no nonzero input (a count of
// nonzero values, not a value sum, as in the TPU kernel's table, so a
// faint analog frame is never skipped) sums no taps: its dV is the bias,
// bit for bit what the taps' zero products plus the bias give.  No atomics,
// and each output's sum lies in one thread, so the bits depend neither on
// the block order nor on the batch, and a split of T into chunks that
// threads v_final into v0 gives the bits of one call.
//
// The counts (COUNT, the inference forward that reports them).  With each
// step's spikes the launch also writes t_counts (T, Cout), the spikes of
// every step and channel, and row_nz (T, N, E_h), the spikes of every
// output row of every step and image (over E_w and Cout): the model's
// per-layer counts and the next layer's skip table
// (kernels/spiking_conv.py:skip_fraction_from_rows), so nothing reads the
// train again to count it.  A warp ballots each of its four spikes; the
// population counts under the lanes of one quad and of one row go by one
// shared-memory atomic a warp into the block's count of each channel and
// row, a slot per step for kCountSteps steps; then, after a barrier, the
// block adds each channel's count to t_counts with one atomic and stores
// each row's count (an atomic where several channel groups share the
// row).  Two sets of slots alternate, so a barrier every kCountSteps steps
// suffices (one at T=8).  The sums are of integers, exact in any order:
// the float bits above do not change.  At batch 256, T=8 they add 0.25 MB
// of row counts to the 148.3 MB above.
//
// Tiling.  The host plans (kernels/spiking_conv.py:plan_tiles): QT quads a
// block (cout_tile = 4 * QT channels), BR rows, BR * E_w * QT <= 512
// threads.  Thread t owns quad t % QT of pixel t / QT of the row-block.
// Shared memory, in floats (ints for cnt):
//   ws  R*R*Cin*cout_tile              weights of the tile, [tap][ci][c]
//   xs  (BR+R-1) * W_pad * CinP        halo rows, [row][col][ci]
//   cnt 2 * kCountSteps *              COUNT only: the count slots,
//       (cout_tile + BR)               [set][step][channel, then row]
// with W_pad = E_w + R - 1 and CinP = Cin | 1.
#include "conv_tile.cuh"

namespace {

constexpr int kMaxThreads = 512;
constexpr int kCountSteps = 8;   // steps a set of count slots holds

// What a launch writes.  dV mode: dv.  Hoisted mode: s (T planes), v, and
// u (T planes) under SAVE_U, or t_counts and row_nz under COUNT, from v0.
struct Outs {
  float* dv;
  const float* v0;
  float* s;
  float* v;
  float* u;
  int* t_counts;
  int* row_nz;
  int T;
  float v_th;
};

enum Mode { kDV, kHoisted, kHoistedSaveU, kHoistedCount };

// Load or store the quad of channels [c, c+4) of one pixel at p, masked at
// Cout.  VEC (Cout a multiple of 4, every pointer 16-byte aligned): one
// 16-byte access.
template <bool VEC>
__device__ __forceinline__ void load_quad(float (&q)[4], const float* p,
                                          int c, int Cout) {
  if (VEC) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    q[0] = a.x, q[1] = a.y, q[2] = a.z, q[3] = a.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) q[k] = c + k < Cout ? p[k] : 0.f;
  }
}

template <bool VEC>
__device__ __forceinline__ void store_quad(float* p, const float (&q)[4],
                                           int c, int Cout) {
  if (VEC) {
    *reinterpret_cast<float4*>(p) = make_float4(q[0], q[1], q[2], q[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (c + k < Cout) p[k] = q[k];
  }
}

// COUNT: add step t's spikes sp of this thread to its slot cb of the
// block's count slots.
__device__ __forceinline__ void count_step(
    int* cb, const float (&sp)[4], const snn::ConvShape& s, int ct,
    bool active, bool in_rows, int lane, int qd, int ly, int c,
    unsigned same_q, unsigned same_row) {
  int row = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const unsigned fired =
        __ballot_sync(~0u, active && c + k < s.Cout && sp[k] != 0.f);
    const int in_q = __popc(fired & same_q);
    row += __popc(fired & same_row);
    if (in_q && lane == __ffs(same_q) - 1) atomicAdd(cb + 4 * qd + k, in_q);
  }
  if (row && in_rows && lane == __ffs(same_row) - 1)
    atomicAdd(cb + ct + ly, row);
}

// COUNT: after a barrier, add the count slots cs of steps [t0, t1) to
// t_counts and row_nz, and zero them for their next use.
__device__ __forceinline__ void flush_counts(
    const Outs& o, int* cs, int t0, int t1, int N, const snn::ConvShape& s,
    int n, int i, int c0, int ct, int groups) {
  __syncthreads();
  const int per = ct + s.BR;
  for (int e = threadIdx.x; e < (t1 - t0) * per; e += blockDim.x) {
    const int t = t0 + e / per, j = e % per;
    const int k = cs[e];
    cs[e] = 0;
    if (j < ct) {
      if (k) atomicAdd(o.t_counts + (size_t)t * s.Cout + c0 + j, k);
    } else if (i * s.BR + j - ct < s.E_h) {
      int* dst = o.row_nz + ((size_t)t * N + n) * s.E_h + i * s.BR + j - ct;
      if (groups == 1)
        *dst = k;
      else if (k)
        atomicAdd(dst, k);
    }
  }
}

template <int MODE, bool VEC>
__global__ void __launch_bounds__(kMaxThreads)
spiking_conv_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ b, Outs o, int N,
                    snn::ConvShape s, int QT, int groups) {
  constexpr bool COUNT = MODE == kHoistedCount;
  extern __shared__ float4 smem4[];
  const int ct = 4 * QT, w_pad = s.w_pad(), cin_p = s.cin_p();
  float* ws = reinterpret_cast<float*>(smem4);
  float* xs = ws + (size_t)s.R * s.R * s.Cin * ct;
  int* cnt = reinterpret_cast<int*>(xs + (size_t)s.halo_rows() * w_pad *
                                                cin_p);
  // a set of count slots: per step, the channels, then the rows
  const int n_cnt = kCountSteps * (ct + s.BR);
  const int row_blocks = (s.E_h + s.BR - 1) / s.BR;
  const int g = blockIdx.x % groups;
  const int i = blockIdx.x / groups % row_blocks;
  const int n = blockIdx.x / groups / row_blocks;
  const int c0 = g * ct;

  // the weight tile, [tap][ci][c], zeros past Cout
  const int n_w = s.R * s.R * s.Cin * ct;
  for (int e = threadIdx.x; e < n_w; e += blockDim.x) {
    const int co = c0 + e % ct;
    const bool ok = co < s.Cout;
    snn::cp_async4(snn::smem_u32(ws + e),
                   ok ? w + (size_t)(e / ct) * s.Cout + co : w, ok);
  }
  // the halo rows of row-block i, zeros outside the image
  const float* img = x + (size_t)n * s.H * s.W * s.Cin;
  const int row0 = i * s.BR - s.pad_lo;
  const int n_x = s.halo_rows() * w_pad * s.Cin;
  snn::Walk wk(threadIdx.x, blockDim.x, w_pad, s.Cin);
  for (int e = threadIdx.x; e < n_x; e += blockDim.x, wk.next()) {
    const int iy = row0 + wk.row, ix = wk.col - s.pad_lo;
    const bool ok = iy >= 0 && iy < s.H && ix >= 0 && ix < s.W;
    snn::cp_async4(
        snn::smem_u32(xs + (wk.row * w_pad + wk.col) * cin_p + wk.q),
        ok ? img + ((size_t)iy * s.W + ix) * s.Cin + wk.q : img, ok);
  }
  snn::cp_async_commit();
  if (COUNT)
    for (int e = threadIdx.x; e < 2 * n_cnt; e += blockDim.x) cnt[e] = 0;

  // this thread's pixel and quad
  const int qd = threadIdx.x % QT, pix = threadIdx.x / QT;
  const int ly = pix / s.E_w, lx = pix % s.E_w, y = i * s.BR + ly;
  const int c = c0 + 4 * qd;
  const bool in_rows = ly < s.BR && y < s.E_h;
  const bool active = in_rows && c < s.Cout;
  const size_t at = (((size_t)n * s.E_h + y) * s.E_w + lx) * s.Cout + c;
  float v[4] = {};
  if (MODE != kDV && active) load_quad<VEC>(v, o.v0 + at, c, s.Cout);

  snn::cp_async_wait_all();
  __syncthreads();
  // the skip test: nonzero values in the halo, counted by every thread
  int nz = 0;
  for (int e = threadIdx.x; e < n_x; e += blockDim.x)
    nz |= xs[e / s.Cin * cin_p + e % s.Cin] != 0.f;
  const int nonzero = __syncthreads_count(nz);
  // a counting block keeps every thread for its ballots and barriers
  if (!active && !COUNT) return;

  float z[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) z[k] = snn::kSumStart;
  if (nonzero && active) {
    for (int dy = 0; dy < s.R; ++dy)
      for (int dx = 0; dx < s.R; ++dx) {
        const float* xp = xs + ((ly + dy) * w_pad + lx + dx) * cin_p;
        const float4* wp = reinterpret_cast<const float4*>(
                               ws + (dy * s.R + dx) * s.Cin * ct) + qd;
        for (int ci = 0; ci < s.Cin; ++ci) {
          const float xv = xp[ci];
          const float4 wv = wp[ci * QT];
          z[0] = snn::tap_add(z[0], xv, wv.x);
          z[1] = snn::tap_add(z[1], xv, wv.y);
          z[2] = snn::tap_add(z[2], xv, wv.z);
          z[3] = snn::tap_add(z[3], xv, wv.w);
        }
      }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k)
    z[k] = __fadd_rn(z[k], c + k < s.Cout ? __ldg(b + c + k) : 0.f);

  if (MODE == kDV) {
    store_quad<VEC>(o.dv + at, z, c, s.Cout);
    return;
  }
  const size_t plane = (size_t)N * s.E_h * s.E_w * s.Cout;
  // COUNT: the lanes of this warp that hold this thread's quad, and those
  // in its output row
  const int lane = threadIdx.x & 31;
  unsigned same_q = 0, same_row = 0;
  if (COUNT) {
    same_q = __match_any_sync(~0u, qd);
    same_row = __match_any_sync(~0u, in_rows ? ly : -1);
  }
  for (int t = 0; t < o.T; ++t) {
    float sp[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[k] = __fadd_rn(v[k], z[k]);                       // integrate
      sp[k] = __fsub_rn(v[k], o.v_th) >= 0.f ? 1.f : 0.f;  // fire
    }
    if (MODE == kHoistedSaveU)
      store_quad<VEC>(o.u + t * plane + at, v, c, s.Cout);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      v[k] = __fsub_rn(v[k], __fmul_rn(o.v_th, sp[k]));  // reset
    if (active) store_quad<VEC>(o.s + t * plane + at, sp, c, s.Cout);
    if (COUNT) {
      const int set = t / kCountSteps & 1, slot = t % kCountSteps;
      count_step(cnt + set * n_cnt + slot * (ct + s.BR), sp, s, ct, active,
                 in_rows, lane, qd, ly, c, same_q, same_row);
      if (slot == kCountSteps - 1 || t == o.T - 1)
        flush_counts(o, cnt + set * n_cnt, t - slot, t + 1, N, s, n, i, c0,
                     ct, groups);
    }
  }
  if (active) store_quad<VEC>(o.v + at, v, c, s.Cout);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <int MODE, bool VEC>
int launch(const float* x, const float* w, const float* b, const Outs& o,
           int N, const snn::ConvShape& s, int QT, cudaStream_t stream) {
  const int groups = (s.Cout + 4 * QT - 1) / (4 * QT);
  const int threads = (s.BR * s.E_w * QT + 31) / 32 * 32;
  const size_t blocks =
      (size_t)N * ((s.E_h + s.BR - 1) / s.BR) * groups;
  if (threads > kMaxThreads || blocks > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      ((size_t)s.R * s.R * s.Cin * 4 * QT +
       (size_t)s.halo_rows() * s.w_pad() * s.cin_p() +
       (MODE == kHoistedCount ? 2 * kCountSteps * (4 * QT + s.BR) : 0)) *
      sizeof(float);
  cudaError_t err = snn::allow_smem(spiking_conv_kernel<MODE, VEC>, smem);
  if (err != cudaSuccess) return (int)err;
  spiking_conv_kernel<MODE, VEC><<<(unsigned)blocks, threads, smem, stream>>>(
      x, w, b, o, N, s, QT, groups);
  return (int)cudaGetLastError();
}

template <int MODE>
int dispatch(const float* x, const float* w, const float* b, const Outs& o,
             int N, const snn::ConvShape& s, int cout_tile, bool vec,
             cudaStream_t stream) {
  if (cout_tile <= 0 || cout_tile % 4 != 0 || s.BR <= 0)
    return (int)cudaErrorInvalidValue;
  return vec ? launch<MODE, true>(x, w, b, o, N, s, cout_tile / 4, stream)
             : launch<MODE, false>(x, w, b, o, N, s, cout_tile / 4, stream);
}

}  // namespace

// dV mode.  x (N, H, W, Cin), w (R, R, Cin, Cout), b (Cout,) -> out
// (N, E_h, E_w, Cout); float32, contiguous, on the stream's device.
// Returns a cudaError_t.
extern "C" int spiking_conv_launch(const float* x, const float* w,
                                   const float* b, float* out, int N, int H,
                                   int W, int Cin, int Cout, int R, int pad_lo,
                                   int E_h, int E_w, int block_rows,
                                   int cout_tile, void* stream) {
  const snn::ConvShape s{H, W, Cin, Cout, R, pad_lo, E_h, E_w, block_rows};
  const Outs o{out, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 0,
               0.f};
  const bool vec = Cout % 4 == 0 && aligned16(out);
  return dispatch<kDV>(x, w, b, o, N, s, cout_tile, vec,
                       static_cast<cudaStream_t>(stream));
}

// Hoisted mode.  x (N, H, W, Cin) frames, v0 (N, E_h, E_w, Cout) -> s
// (T, N, E_h, E_w, Cout) spikes, v (N, E_h, E_w, Cout) the final membrane,
// and, when u is not null, u (T, N, E_h, E_w, Cout) the pre-reset
// membrane (SAVE_U); or, when t_counts is not null, the counts (COUNT):
// t_counts (T, Cout) int32, zero at launch, and row_nz (T, N, E_h) int32,
// zero at launch where the layer has several channel groups.  T >= 1;
// float32, contiguous, on the stream's device.  Returns a cudaError_t.
extern "C" int spiking_conv_lif_hoisted_launch(
    const float* x, const float* v0, const float* w, const float* b,
    float* s_out, float* v_out, float* u_out, int* t_counts, int* row_nz,
    int T, int N, int H, int W, int Cin, int Cout, int R, int pad_lo,
    int E_h, int E_w, int block_rows, int cout_tile, float v_th,
    void* stream) {
  if (T < 1 || (u_out && t_counts) || (t_counts && !row_nz))
    return (int)cudaErrorInvalidValue;
  const snn::ConvShape s{H, W, Cin, Cout, R, pad_lo, E_h, E_w, block_rows};
  const Outs o{nullptr, v0, s_out, v_out, u_out, t_counts, row_nz, T, v_th};
  const bool vec = Cout % 4 == 0 && aligned16(v0) && aligned16(s_out) &&
                   aligned16(v_out) && (!u_out || aligned16(u_out));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (u_out)
    return dispatch<kHoistedSaveU>(x, w, b, o, N, s, cout_tile, vec, st);
  if (t_counts)
    return dispatch<kHoistedCount>(x, w, b, o, N, s, cout_tile, vec, st);
  return dispatch<kHoisted>(x, w, b, o, N, s, cout_tile, vec, st);
}
