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
// What bounds it on the H100: operations (2 N M 256 one-bit
// multiply-adds; the bytes are two L2-resident descriptor tables). The
// distances come from the tensor cores, straight from the packed words:
// one mma.sync m16n8k256 (b1, and.popc) gives a 16 x 8 tile of
// popc(a & b) over all 256 bits, and
//   d = popc(a) + popc(b) - 2 popc(a & b)
// with the row and column popcounts taken once per block (an invalid
// row or column carries 2^21 there, so its distances clamp to the
// sentinel without a test per pair). What is left per pair is the
// epilogue, and the design keeps it in registers:
//  - a block is 8 warps x 16 rows by a strip of columns staged once in
//    shared memory (descriptors, popcounts, gate coordinates); the
//    wrapper splits the columns so that >= 2 blocks sit on each SM;
//  - every thread keeps, for its two rows, the two smallest 31-bit keys
//    (min(d, 511) << 22) | column it has seen, and per tile the smaller
//    (min(d, 511) << 23) | row key of its two columns. Real distances
//    are <= 256 < 511 == the clamped sentinel, so keys order by
//    (distance, index) and every merge keeps the lowest index: within a
//    thread, across the 4 lanes of a quad (rows) and the 8 row groups
//    of a warp (columns) by shuffles, across warps in shared memory;
//  - then one atomicMin per column per block on the global column keys,
//    one partial (key1, key2) per row per column split, and no atomic in
//    the loop. Integer minima only: the result does not depend on the
//    order in which blocks run.
// One launch (after one cudaMemsetAsync of the scratch): the last block
// to finish a row block merges its splits (top-2 of the union of the
// splits' top-2 keys), and the last block of a problem turns the column
// keys into col_best (a __threadfence() and a counter each).
// Batched entry (slam_hamming_top2_batched): B independent ungated
// problems of the same (N, M) in one launch, problem z on grid.z, each
// with its own descriptors, masks, scratch and outputs. It serves the
// loop-verification slate, the vmapped Pallas call of
// slam1_tpu/models/loop_closure.py:verify_loop_slate. A problem whose
// masks are all false (a padded slate entry) gives idx = 0 and
// d1 = d2 = 2^20 on every row, like an all-sentinel row above.
// Build with --fmad=false: the gate's float compares must see the
// same differences as the plain twin.
//
// Measured (kernel_bench.py, NVIDIA H100 80GB HBM3, 700.00 W, device
// time of a replayed CUDA graph): 2688 x 2688 in 0.0173 ms ungated and
// 0.0211 ms gated, 8 x 1024 x 1024 in 0.0161 ms, against 0.0682, 0.0702
// and 0.0669 ms for the one-thread-per-row popcount kernel this one
// replaced, in the same run. The bound (2 N M 256 operations at the
// int8 tensor-core peak) is 0.0019 ms at 2688 x 2688: 9-11 % of it is
// reached. 56 registers, no spills; the SASS holds BMMA.168256.AND.POPC.
// What is left is the epilogue's ~12 integer operations per pair (the
// gate adds 0.004 ms) and the block's serial head and tail (staging,
// the fence and the counters, the merge).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS = WARPS * 16;   // query rows per block
constexpr int MAX_COLS = 512;      // columns of one split (multiple of 8)
constexpr int BIG = 1 << 20;
constexpr int INVALID_POPC = 1 << 21;
constexpr unsigned DIST_CLAMP = 511u;
constexpr int ROW_KEY_COL_BITS = 22;   // row keys: (dist << 22) | column
constexpr int COL_KEY_ROW_BITS = 23;   // column keys: (dist << 23) | row
constexpr unsigned NONE = 0xffffffffu;

__device__ __forceinline__ void and_popc_16x8(int (&c)[4], const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  // A fragment: a[0], a[2] = 32-bit words t, t + 4 of row g; a[1], a[3]
  // the same words of row g + 8. B fragment: words t, t + 4 of column g.
  // C: c[0], c[1] = (row g, columns 2t, 2t + 1); c[2], c[3] = row g + 8.
  // (g = lane / 4, t = lane % 4.)
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=r"(c[0]), "=r"(c[1]), "=r"(c[2]), "=r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "r"(0));
}

// Two smallest keys of the union of two (k1 <= k2) pairs.
__device__ __forceinline__ void merge_top2(unsigned& k1, unsigned& k2,
                                           unsigned o1, unsigned o2) {
  k2 = min(max(k1, o1), min(k2, o2));
  k1 = min(k1, o1);
}

__device__ __forceinline__ int key_dist(unsigned key, int index_bits) {
  const unsigned d = key >> index_bits;
  return d >= DIST_CLAMP ? BIG : static_cast<int>(d);
}

template <bool GATED>
__global__ void __launch_bounds__(THREADS, 2)
hamming_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
               const uint8_t* __restrict__ mask_a,
               const uint8_t* __restrict__ mask_b,
               const float* __restrict__ uv_a, const float* __restrict__ uv_b,
               int N, int M, float dy_tol, float dx_lo, float dx_hi,
               int cols_per_split, uint2* __restrict__ part,
               unsigned* __restrict__ colkey, unsigned* __restrict__ counters,
               int* __restrict__ d1_out, int* __restrict__ d2_out,
               int* __restrict__ idx_out, int* __restrict__ col_best) {
  __shared__ __align__(16) uint32_t sb[MAX_COLS][8];
  __shared__ int spop[MAX_COLS];
  __shared__ float2 suv[GATED ? MAX_COLS : 1];
  __shared__ unsigned scol[MAX_COLS];
  __shared__ int s_last_row, s_last_problem;

  // Problem z of a batch: every array advances by its own problem size.
  const size_t z = blockIdx.z;
  const int splits = gridDim.y;
  const int row_blocks = gridDim.x;
  a += z * N * 8;
  b += z * M * 8;
  mask_a += z * N;
  mask_b += z * M;
  part += z * splits * static_cast<size_t>(N);
  colkey += z * M;
  counters += z * (row_blocks + 1);
  d1_out += z * N;
  d2_out += z * N;
  idx_out += z * N;
  col_best += z * M;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int split = blockIdx.y;
  const int c_begin = split * cols_per_split;
  const int nc = min(cols_per_split, M - c_begin);   // live columns here
  const int nc8 = (nc + 7) & ~7;                     // padded to whole tiles

  // Stage the strip: descriptors, popcounts (2^21 when the column is
  // invalid or past M), gate coordinates, and empty column keys.
  for (int j = tid; j < nc8; j += THREADS) {
    uint4 lo = make_uint4(0u, 0u, 0u, 0u), hi = lo;
    int pop = INVALID_POPC;
    if (j < nc) {
      const uint4* src =
          reinterpret_cast<const uint4*>(b + static_cast<size_t>(c_begin + j) * 8);
      lo = src[0];
      hi = src[1];
      if (mask_b[c_begin + j]) {
        pop = __popc(lo.x) + __popc(lo.y) + __popc(lo.z) + __popc(lo.w) +
              __popc(hi.x) + __popc(hi.y) + __popc(hi.z) + __popc(hi.w);
      }
      if (GATED) {
        suv[j] = reinterpret_cast<const float2*>(uv_b)[c_begin + j];
      }
    } else if (GATED) {
      suv[j] = make_float2(0.0f, 0.0f);
    }
    reinterpret_cast<uint4*>(sb[j])[0] = lo;
    reinterpret_cast<uint4*>(sb[j])[1] = hi;
    spop[j] = pop;
    scol[j] = NONE;
  }

  // This thread's two rows: g and g + 8 of the warp's 16.
  const int row0 = blockIdx.x * ROWS + warp * 16 + g;
  uint32_t af[4];
  int rpop[2];
  unsigned rowbits[2];          // the row index; all ones past N (key NONE)
  float xa[2], ya[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    const bool live = row < N;
    af[h] = live ? a[static_cast<size_t>(row) * 8 + t] : 0u;
    af[h + 2] = live ? a[static_cast<size_t>(row) * 8 + t + 4] : 0u;
    int p = __popc(af[h]) + __popc(af[h + 2]);
    p += __shfl_xor_sync(0xffffffffu, p, 1);
    p += __shfl_xor_sync(0xffffffffu, p, 2);
    rpop[h] = (live && mask_a[row]) ? p : INVALID_POPC;
    rowbits[h] = live ? static_cast<unsigned>(row) : NONE;
    xa[h] = 0.0f;
    ya[h] = 0.0f;
    if (GATED && live) {
      const float2 uv = reinterpret_cast<const float2*>(uv_a)[row];
      xa[h] = uv.x;
      ya[h] = uv.y;
    }
  }
  __syncthreads();

  unsigned k1[2] = {NONE, NONE}, k2[2] = {NONE, NONE};
  for (int n0 = 0; n0 < nc8; n0 += 8) {
    int acc[4];
    and_popc_16x8(acc, af, sb[n0 + g][t], sb[n0 + g][t + 4]);
    const int cj = n0 + 2 * t;            // this thread's columns cj, cj + 1
    unsigned ck[2] = {NONE, NONE};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int pb = spop[cj + e];
      const unsigned col = static_cast<unsigned>(c_begin + cj + e);
      float xb = 0.0f, yb = 0.0f;
      if (GATED) {
        const float2 uv = suv[cj + e];
        xb = uv.x;
        yb = uv.y;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int d = rpop[h] + pb - 2 * acc[2 * h + e];
        if (GATED) {
          const float dy = fabsf(yb - ya[h]);
          const float dx = xa[h] - xb;
          if (dy > dy_tol || dx < dx_lo || dx > dx_hi) d = BIG;
        }
        const unsigned dc = min(static_cast<unsigned>(d), DIST_CLAMP);
        // Row top-2: columns past M carry a higher index than any live
        // column with the same clamped distance, so they never win.
        merge_top2(k1[h], k2[h], (dc << ROW_KEY_COL_BITS) | col, NONE);
        // Column argmin: rows past N never win.
        ck[e] = min(ck[e], (dc << COL_KEY_ROW_BITS) | rowbits[h]);
      }
    }
    // Columns across the warp's 8 row groups (lanes with equal t).
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      ck[e] = min(ck[e], __shfl_xor_sync(0xffffffffu, ck[e], 4));
      ck[e] = min(ck[e], __shfl_xor_sync(0xffffffffu, ck[e], 8));
      ck[e] = min(ck[e], __shfl_xor_sync(0xffffffffu, ck[e], 16));
    }
    if (g == 0) {
      atomicMin(&scol[cj], ck[0]);
      atomicMin(&scol[cj + 1], ck[1]);
    }
  }

  // Rows across the quad (lanes with equal g hold the same two rows).
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const unsigned o1 = __shfl_xor_sync(0xffffffffu, k1[h], off);
      const unsigned o2 = __shfl_xor_sync(0xffffffffu, k2[h], off);
      merge_top2(k1[h], k2[h], o1, o2);
    }
    const int row = row0 + 8 * h;
    if (t == 0 && row < N) {
      part[static_cast<size_t>(split) * N + row] = make_uint2(k1[h], k2[h]);
    }
  }
  __syncthreads();
  for (int j = tid; j < nc; j += THREADS) {
    atomicMin(&colkey[c_begin + j], scol[j]);
  }

  // Last block of this row block merges the splits; last block of the
  // problem writes col_best.
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    // Counters start at 0xffffffff (the scratch's memset) and wrap.
    const unsigned done_row = atomicAdd(&counters[blockIdx.x], 1u) + 2u;
    const unsigned done_all = atomicAdd(&counters[row_blocks], 1u) + 2u;
    s_last_row = done_row == static_cast<unsigned>(splits);
    s_last_problem =
        done_all == static_cast<unsigned>(splits) * static_cast<unsigned>(row_blocks);
  }
  __syncthreads();
  if (s_last_row) {
    __threadfence();
    const int row = blockIdx.x * ROWS + tid;
    if (tid < ROWS && row < N) {
      unsigned m1 = NONE, m2 = NONE;
      for (int s = 0; s < splits; ++s) {
        const uint2 p = __ldcg(&part[static_cast<size_t>(s) * N + row]);
        merge_top2(m1, m2, p.x, p.y);
      }
      d1_out[row] = key_dist(m1, ROW_KEY_COL_BITS);
      d2_out[row] = key_dist(m2, ROW_KEY_COL_BITS);
      idx_out[row] = static_cast<int>(m1 & ((1u << ROW_KEY_COL_BITS) - 1u));
    }
  }
  if (s_last_problem) {
    __threadfence();
    for (int j = tid; j < M; j += THREADS) {
      col_best[j] = static_cast<int>(__ldcg(&colkey[j]) &
                                     ((1u << COL_KEY_ROW_BITS) - 1u));
    }
  }
}

int launch(const uint8_t* a, const uint8_t* b, const uint8_t* mask_a,
           const uint8_t* mask_b, const float* uv_a, const float* uv_b,
           int B, int N, int M, int gated, float dy_tol, float dx_lo,
           float dx_hi, int cols_per_split, unsigned* scratch, int* d1,
           int* d2, int* idx, int* col_best, cudaStream_t st) {
  if (cols_per_split < 8 || cols_per_split > MAX_COLS || cols_per_split % 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int splits = (M + cols_per_split - 1) / cols_per_split;
  const int row_blocks = (N + ROWS - 1) / ROWS;
  // Scratch: column keys (B, M), counters (B, row_blocks + 1), both
  // starting at 0xffffffff, then the row partials (B, splits, N, 2).
  const size_t n_keys = static_cast<size_t>(B) * M;
  const size_t n_counters = static_cast<size_t>(B) * (row_blocks + 1);
  cudaError_t e = cudaMemsetAsync(scratch, 0xff,
                                  (n_keys + n_counters) * sizeof(unsigned), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  unsigned* colkey = scratch;
  unsigned* counters = scratch + n_keys;
  // Keep the 8-byte partials aligned whatever n_keys + n_counters is.
  uint2* part = reinterpret_cast<uint2*>(
      scratch + ((n_keys + n_counters + 1) & ~static_cast<size_t>(1)));
  dim3 grid(row_blocks, splits, B);
  const uint32_t* a32 = reinterpret_cast<const uint32_t*>(a);
  const uint32_t* b32 = reinterpret_cast<const uint32_t*>(b);
  if (gated) {
    hamming_kernel<true><<<grid, THREADS, 0, st>>>(
        a32, b32, mask_a, mask_b, uv_a, uv_b, N, M, dy_tol, dx_lo, dx_hi,
        cols_per_split, part, colkey, counters, d1, d2, idx, col_best);
  } else {
    hamming_kernel<false><<<grid, THREADS, 0, st>>>(
        a32, b32, mask_a, mask_b, uv_a, uv_b, N, M, dy_tol, dx_lo, dx_hi,
        cols_per_split, part, colkey, counters, d1, d2, idx, col_best);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a: (N, 32) uint8, b: (M, 32) uint8 packed descriptors (16-byte
// aligned); mask_a (N,), mask_b (M,) uint8; uv_a (N, 2), uv_b (M, 2)
// float32 (8-byte aligned), read only when gated != 0. The columns are
// split into strips of cols_per_split (a multiple of 8, at most 512),
// splits = ceil(M / cols_per_split) of them. scratch: 8-byte aligned,
// M + ceil(N / 128) + 1 words rounded up to even, plus 2 * splits * N
// words. Outputs d1, d2, idx (N,) and
// col_best (M,) int32. N < 2^23, M < 2^22. Returns the first CUDA error
// (0: none) after the launch.
extern "C" int slam_hamming_top2(const uint8_t* a, const uint8_t* b,
                                 const uint8_t* mask_a,
                                 const uint8_t* mask_b, const float* uv_a,
                                 const float* uv_b, int N, int M, int gated,
                                 float dy_tol, float dx_lo, float dx_hi,
                                 int cols_per_split, unsigned* scratch,
                                 int* d1, int* d2, int* idx, int* col_best,
                                 void* stream) {
  return launch(a, b, mask_a, mask_b, uv_a, uv_b, 1, N, M, gated, dy_tol,
                dx_lo, dx_hi, cols_per_split, scratch, d1, d2, idx, col_best,
                static_cast<cudaStream_t>(stream));
}

// The same for B ungated problems: a (B, N, 32), b (B, M, 32), mask_a
// (B, N), mask_b (B, M); scratch B * (M + ceil(N / 128) + 1) words
// rounded up to even, plus B * 2 * splits * N words; outputs d1, d2,
// idx (B, N) and col_best (B, M).
extern "C" int slam_hamming_top2_batched(
    const uint8_t* a, const uint8_t* b, const uint8_t* mask_a,
    const uint8_t* mask_b, int B, int N, int M, int cols_per_split,
    unsigned* scratch, int* d1, int* d2, int* idx, int* col_best,
    void* stream) {
  return launch(a, b, mask_a, mask_b, nullptr, nullptr, B, N, M, 0, 0.0f,
                0.0f, 0.0f, cols_per_split, scratch, d1, d2, idx, col_best,
                static_cast<cudaStream_t>(stream));
}
