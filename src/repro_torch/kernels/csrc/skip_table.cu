// The skip-table finisher for Hopper (sm_90a): the fraction of a fused
// layer's (T, B, row-block) skip-table cells that hold no input spike, from
// the row counts of its input train.
//
// Replaces no TPU kernel.  The reference computes the table with XLA ops
// on the train (repro/kernels/spiking_conv.py:skip_table_fraction; the
// port's plain version is kernels/spiking_conv.py:skip_table_fraction).
// Here the launch that fired the train already counted the spikes of each
// of its rows (kernel A's hoisted mode and kernel B with COUNT write
// row_nz), so the table needs only those counts: M = T * B planes of H
// rows, 4 bytes a row, about 1 MB at snn-mnist's batch 1024, where the
// trains are 0.47 and 1.07 GB.  The launch is bound by its own start.
//
// A cell (m, i) covers the padded rows [i * BR, i * BR + BR + R - 1) of
// plane m, whose real rows lie at [pad_lo, pad_lo + H); it is skipped when
// those rows hold no spike.  out = skipped cells * inv, with inv the
// float32 reciprocal of the cells: the plain version's exact count of
// skipped cells, rounded once to float32, times the same reciprocal, so
// the same bits at every size (the count is int32: the wrapper refuses
// 2^31 cells or more).
//
// One thread a cell.  Each block counts its skipped cells
// (__syncthreads_count), adds them to scratch[0] and takes a ticket from
// scratch[1]; the block with the last ticket writes out and zeroes the
// scratch again.  The sums are of integers: the bits depend on no order.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
skip_table_kernel(const int* __restrict__ rows, int* scratch, float* out,
                  int M, int H, int pad_lo, int BR, int R, int n_blocks,
                  float inv) {
  const long long cell = (long long)blockIdx.x * kThreads + threadIdx.x;
  int skipped = 0;
  if (cell < (long long)M * n_blocks) {
    const int m = (int)(cell / n_blocks), i = (int)(cell % n_blocks);
    const int lo = max(i * BR - pad_lo, 0);
    const int hi = min(i * BR + BR + R - 1 - pad_lo, H);
    int any = 0;
    for (int y = lo; y < hi; ++y) any |= rows[(size_t)m * H + y];
    skipped = any == 0;
  }
  const int in_block = __syncthreads_count(skipped);
  if (threadIdx.x == 0) {
    atomicAdd(scratch, in_block);
    __threadfence();
    if (atomicAdd(scratch + 1, 1) == (int)gridDim.x - 1) {
      out[0] = __fmul_rn(__int2float_rn(atomicExch(scratch, 0)), inv);
      scratch[1] = 0;
    }
  }
}

}  // namespace

// rows (M, H) int32, each row's spike count; scratch (2,) int32, zero at
// launch (zero again after it); out (1,) float32.  n_blocks row-blocks of
// BR rows a plane, R the layer's kernel size, pad_lo its top padding, inv
// float32(1 / (M * n_blocks)).  Returns a cudaError_t.
extern "C" int skip_table_launch(const int* rows, int* scratch, float* out,
                                 int M, int H, int pad_lo, int block_rows,
                                 int R, int n_blocks, float inv,
                                 void* stream) {
  const long long cells = (long long)M * n_blocks;
  if (cells < 1 || block_rows < 1) return (int)cudaErrorInvalidValue;
  const long long blocks = (cells + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  skip_table_kernel<<<(unsigned)blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      rows, scratch, out, M, H, pad_lo, block_rows, R, n_blocks, inv);
  return (int)cudaGetLastError();
}
