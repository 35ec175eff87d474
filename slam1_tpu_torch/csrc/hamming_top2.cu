// Fused brute-force Hamming top-2 matcher for Hopper (sm_90a).
//
// Replaces: slam1_tpu/ops/pallas_kernels.py:hamming_top2 (kernel body
// _hamming_kernel), the TPU kernel that forms each (128, M) distance
// tile as a {-1,+1} matrix product and reduces it in VMEM.
//
// What it computes, for packed 256-bit descriptors A (N rows) and B
// (M columns): per row the best distance d1, the second-best d2 (the
// minimum with only the best column removed, so ties give d2 == d1)
// and the best column idx; per column the best row col_best, for the
// cross-check. Invalid rows/columns, and pairs outside an optional
// geometric gate (|y_b - y_a| <= dy_tol and dx_lo <= x_a - x_b <=
// dx_hi), get distance 2^20. Ties go to the lowest index everywhere,
// as lax.top_k / argmin do; an all-2^20 row or column yields index 0.
// The N x M matrix is never stored.
//
// What bounds it on the H100: integer ALU issue. Each pair costs 8
// XOR + 8 POPC + compares (2688^2 pairs ~ 0.1 G popc per call), while
// the bytes are tiny (2 x 86 KB of descriptors, L2-resident). The
// design keeps A's row in registers, streams B through shared memory
// (broadcast reads: every thread of the block reads the same column),
// and splits the columns over grid.y so ~170 blocks fill 132 SMs.
//
// Cross-block reductions (CUDA blocks run in no order, unlike the
// sequential Pallas grid that carried the column argmin in scratch):
//  - column argmin: a warp reduction of the 32-bit key
//    (min(d, 511) << 23) | row, then one atomicMin per warp. Real
//    distances are <= 256 < 511 == the clamped 2^20, so the key orders
//    by (distance, row): deterministic, lowest row on ties.
//  - row top-2 across column splits: each split writes its partial
//    (d1, d2, idx); a second small kernel merges the splits in column
//    order, keeping the lower index on ties.
// Batched entry (slam_hamming_top2_batched): B independent ungated
// problems of the same (N, M) in one launch, problem z on grid.z, each
// with its own descriptors, masks, scratch and outputs. It serves the
// loop-verification slate, the vmapped Pallas call of
// slam1_tpu/models/loop_closure.py:verify_loop_slate. A problem whose
// masks are all false (a padded slate entry) gives idx = 0 and
// d1 = d2 = 2^20 on every row, like an all-sentinel row above.
// Build with --fmad=false: the gate's float compares must see the
// same differences as the plain twin.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 128;      // query rows per block == threads per block
constexpr int COLS = 128;      // columns staged in shared memory per step
constexpr int BIG = 1 << 20;
constexpr int INF = 0x7fffffff;
constexpr unsigned KEY_DIST_CLAMP = 511u;
constexpr int KEY_ROW_BITS = 23;

__global__ void col_init_kernel(unsigned* __restrict__ colkey, int total) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j < total) colkey[j] = 0xffffffffu;
}

__global__ void hamming_kernel(
    const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
    const uint8_t* __restrict__ mask_a, const uint8_t* __restrict__ mask_b,
    const float* __restrict__ uv_a, const float* __restrict__ uv_b,
    int N, int M, int gated, float dy_tol, float dx_lo, float dx_hi,
    int cols_per_split, int* __restrict__ part, unsigned* __restrict__ colkey) {
  __shared__ uint32_t sb[COLS][8];
  __shared__ uint8_t smb[COLS];
  __shared__ float sx[COLS];
  __shared__ float sy[COLS];

  // Problem z of a batch: every array advances by its own problem size.
  const size_t z = blockIdx.z;
  a += z * N * 8;
  b += z * M * 8;
  mask_a += z * N;
  mask_b += z * M;
  part += z * 3 * gridDim.y * static_cast<size_t>(N);
  colkey += z * M;

  const int row = blockIdx.x * ROWS + threadIdx.x;
  const bool row_live = row < N;
  const int split = blockIdx.y;
  const int c_begin = split * cols_per_split;
  const int c_end = min(M, c_begin + cols_per_split);

  uint32_t q[8];
  bool va = false;
  float xa = 0.0f, ya = 0.0f;
  if (row_live) {
#pragma unroll
    for (int k = 0; k < 8; ++k) q[k] = a[static_cast<size_t>(row) * 8 + k];
    va = mask_a[row] != 0;
    if (gated) {
      xa = uv_a[2 * row];
      ya = uv_a[2 * row + 1];
    }
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) q[k] = 0u;
  }

  int d1 = INF, d2 = INF, i1 = 0;
  const unsigned lane = threadIdx.x & 31u;
  for (int c0 = c_begin; c0 < c_end; c0 += COLS) {
    const int nc = min(COLS, c_end - c0);
    __syncthreads();
    for (int i = threadIdx.x; i < nc * 8; i += blockDim.x) {
      sb[i >> 3][i & 7] = b[static_cast<size_t>(c0) * 8 + i];
    }
    for (int i = threadIdx.x; i < nc; i += blockDim.x) {
      smb[i] = mask_b[c0 + i];
      if (gated) {
        sx[i] = uv_b[2 * (c0 + i)];
        sy[i] = uv_b[2 * (c0 + i) + 1];
      }
    }
    __syncthreads();
    for (int j = 0; j < nc; ++j) {
      int d = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) d += __popc(q[k] ^ sb[j][k]);
      if (!va || !smb[j]) d = BIG;
      if (gated) {
        const float dy = fabsf(sy[j] - ya);
        const float dx = xa - sx[j];
        if (dy > dy_tol || dx < dx_lo || dx > dx_hi) d = BIG;
      }
      // Row top-2 in column order: strict < keeps the lowest index.
      if (d < d1) {
        d2 = d1;
        d1 = d;
        i1 = c0 + j;
      } else if (d < d2) {
        d2 = d;
      }
      // Column argmin: warp-reduce (distance, row) keys, one atomic
      // per warp. Rows past N never win.
      const unsigned key =
          row_live ? ((min(static_cast<unsigned>(d), KEY_DIST_CLAMP)
                       << KEY_ROW_BITS) | static_cast<unsigned>(row))
                   : 0xffffffffu;
      const unsigned wmin = __reduce_min_sync(0xffffffffu, key);
      if (lane == 0 && wmin != 0xffffffffu) atomicMin(&colkey[c0 + j], wmin);
    }
  }
  if (row_live) {
    const size_t o = static_cast<size_t>(split) * N + row;
    const size_t plane = static_cast<size_t>(gridDim.y) * N;
    part[o] = d1;
    part[plane + o] = d2;
    part[2 * plane + o] = i1;
  }
}

__global__ void merge_kernel(const int* __restrict__ part,
                             const unsigned* __restrict__ colkey, int N,
                             int M, int splits, int* __restrict__ d1_out,
                             int* __restrict__ d2_out,
                             int* __restrict__ idx_out,
                             int* __restrict__ col_best) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t z = blockIdx.y;
  part += z * 3 * splits * static_cast<size_t>(N);
  colkey += z * M;
  d1_out += z * N;
  d2_out += z * N;
  idx_out += z * N;
  col_best += z * M;
  if (t < N) {
    const size_t plane = static_cast<size_t>(splits) * N;
    int d1 = part[t], d2 = part[plane + t], i1 = part[2 * plane + t];
    for (int s = 1; s < splits; ++s) {
      const size_t o = static_cast<size_t>(s) * N + t;
      const int e1 = part[o], e2 = part[plane + o], j1 = part[2 * plane + o];
      // Split s holds higher columns: on a tie the earlier split wins.
      if (e1 < d1) {
        d2 = min(d1, e2);
        d1 = e1;
        i1 = j1;
      } else {
        d2 = min(d2, e1);
      }
    }
    d1_out[t] = d1;
    d2_out[t] = d2;
    idx_out[t] = i1;
  }
  if (t < M) {
    col_best[t] = static_cast<int>(colkey[t] & ((1u << KEY_ROW_BITS) - 1u));
  }
}

int launch(const uint8_t* a, const uint8_t* b, const uint8_t* mask_a,
           const uint8_t* mask_b, const float* uv_a, const float* uv_b,
           int B, int N, int M, int gated, float dy_tol, float dx_lo,
           float dx_hi, int splits, int* part, unsigned* colkey, int* d1,
           int* d2, int* idx, int* col_best, cudaStream_t st) {
  col_init_kernel<<<(B * M + 255) / 256, 256, 0, st>>>(colkey, B * M);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int tiles = (M + COLS - 1) / COLS;
  const int cols_per_split = ((tiles + splits - 1) / splits) * COLS;
  dim3 grid((N + ROWS - 1) / ROWS, splits, B);
  hamming_kernel<<<grid, ROWS, 0, st>>>(
      reinterpret_cast<const uint32_t*>(a),
      reinterpret_cast<const uint32_t*>(b), mask_a, mask_b, uv_a, uv_b, N,
      M, gated, dy_tol, dx_lo, dx_hi, cols_per_split, part, colkey);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int n = N > M ? N : M;
  dim3 mgrid((n + 255) / 256, B);
  merge_kernel<<<mgrid, 256, 0, st>>>(part, colkey, N, M, splits, d1, d2,
                                      idx, col_best);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a: (N, 32) uint8, b: (M, 32) uint8 packed descriptors (16-byte
// aligned); mask_a (N,), mask_b (M,) uint8; uv_a (N, 2), uv_b (M, 2)
// float32, read only when gated != 0. Scratch: part (3 * splits * N)
// int32 and colkey (M) uint32. Outputs d1, d2, idx (N,) and col_best
// (M,) int32. Returns cudaGetLastError() after the last launch.
extern "C" int slam_hamming_top2(const uint8_t* a, const uint8_t* b,
                                 const uint8_t* mask_a,
                                 const uint8_t* mask_b, const float* uv_a,
                                 const float* uv_b, int N, int M, int gated,
                                 float dy_tol, float dx_lo, float dx_hi,
                                 int splits, int* part, unsigned* colkey,
                                 int* d1, int* d2, int* idx, int* col_best,
                                 void* stream) {
  return launch(a, b, mask_a, mask_b, uv_a, uv_b, 1, N, M, gated, dy_tol,
                dx_lo, dx_hi, splits, part, colkey, d1, d2, idx, col_best,
                static_cast<cudaStream_t>(stream));
}

// The same for B ungated problems: a (B, N, 32), b (B, M, 32), mask_a
// (B, N), mask_b (B, M); scratch part (B * 3 * splits * N), colkey
// (B * M); outputs d1, d2, idx (B, N) and col_best (B, M).
extern "C" int slam_hamming_top2_batched(
    const uint8_t* a, const uint8_t* b, const uint8_t* mask_a,
    const uint8_t* mask_b, int B, int N, int M, int splits, int* part,
    unsigned* colkey, int* d1, int* d2, int* idx, int* col_best,
    void* stream) {
  return launch(a, b, mask_a, mask_b, nullptr, nullptr, B, N, M, 0, 0.0f,
                0.0f, 0.0f, splits, part, colkey, d1, d2, idx, col_best,
                static_cast<cudaStream_t>(stream));
}
