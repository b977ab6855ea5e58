// The kernels' code layout on the card for Hopper (sm_90a).
//
//   transpose_i32_kernel -> dst (C, R) int32, the transpose of src (R, C).
//      Replaces no TPU kernel: the JAX package hands XLA the (B, T) codes
//      and lets it lay them out, and the port transposed them on the host
//      (numpy, a strided walk of the padded library: 1.2-2.3 s a screen for
//      71,200 x 4,132).  swaffine.to_device copies the (B, T) template codes
//      (or the (B, Q) per-lane queries) to the card as they stand and writes
//      the (T, B) layout K1 and K2 read with one launch of this kernel.
//
// What bounds it.  Bytes: each element is read once and written once, 8
// bytes an element, so 2 x 1.18 GB for the FASTA cells' library, 0.70 ms at
// 3.35 TB/s.  Design: a 32 x 32 tile per block of 32 x 8 threads, four
// elements a thread.  A warp reads one tile row, 32 consecutive elements of
// src (coalesced along C), into shared memory, and writes one tile column
// back as 32 consecutive elements of dst (coalesced along R); the tile's
// rows are padded by one element, so the column read hits 32 banks.  The
// four loads of a thread are issued before its first store.  R's tiles lie
// on grid x (up to 2^31 - 1 blocks: libraries of millions of templates),
// C's on grid y, at most 65,535 of them, each block looping over the rest.
// Offsets are size_t: R x C may pass 2^31.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;
constexpr int kRows = 8;          // threads along a tile's rows; 4 elements each
constexpr int kMaxGridY = 65535;

__global__ void __launch_bounds__(kTile * kRows)
transpose_i32_kernel(const int32_t* __restrict__ src,
                     int32_t* __restrict__ dst, int rows, int cols) {
  __shared__ int32_t tile[kTile][kTile + 1];
  const int r0 = blockIdx.x * kTile;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int ytiles = (cols + kTile - 1) / kTile;
  for (int by = blockIdx.y; by < ytiles; by += gridDim.y) {
    const int c0 = by * kTile;
    const int c = c0 + tx;
#pragma unroll
    for (int k = 0; k < kTile; k += kRows) {
      const int r = r0 + ty + k;
      if (r < rows && c < cols)
        tile[ty + k][tx] = src[(size_t)r * cols + c];
    }
    __syncthreads();
    const int r = r0 + tx;
#pragma unroll
    for (int k = 0; k < kTile; k += kRows) {
      const int cc = c0 + ty + k;
      if (r < rows && cc < cols)
        dst[(size_t)cc * rows + r] = tile[tx][ty + k];
    }
    __syncthreads();  // the tile is refilled on the next turn
  }
}

}  // namespace

// dst (cols, rows) <- src (rows, cols)^T on `stream`; no launch when either
// side is 0.  Returns the launch's CUDA error code.
extern "C" int transpose_i32_launch(const int32_t* src, int32_t* dst,
                                    int rows, int cols, void* stream) {
  if (rows < 0 || cols < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0 || cols == 0) return (int)cudaSuccess;
  const int ytiles = (cols + kTile - 1) / kTile;
  const dim3 grid((rows + kTile - 1) / kTile,
                  ytiles < kMaxGridY ? ytiles : kMaxGridY);
  transpose_i32_kernel<<<grid, dim3(kTile, kRows), 0,
                         (cudaStream_t)stream>>>(src, dst, rows, cols);
  return (int)cudaGetLastError();
}
