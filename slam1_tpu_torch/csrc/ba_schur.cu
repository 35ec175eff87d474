// The reduced camera system of bundle adjustment's CG path, for Hopper
// (sm_90a): the product S x = Hcc_d x - sum_o W_o Hll_inv_{l_o} s_{l_o},
// s_l = sum_{o in l} W_o^T x_{c_o}, as two launches, one per half.
//
// Both halves are templates on the camera block's width D: 6 for the
// stereo rig (an SE(3) twist; W_o 6x3, 72 bytes; row 0 held as the
// gauge) and 9 for BAL's cameras (rvec, t, f, k1, k2; W_o 9x3, 108 bytes;
// no row held: LM damping holds BAL's 7-dof gauge). The D = 6
// instantiation is the code written for it, with its float2 loads; at
// D = 9 a row is only 4-byte aligned and is read as 27 floats.
//
// Replaces no TPU kernel. The reference writes the product as einsums
// and segment sums (slam1_tpu/models/ba.py:256-265, `matvec` and `btil`
// in `_schur_solve`) that XLA fuses; in the port the same einsums became
// cuBLAS strided-batched gemvs of one 6x3 matrix per batch and float64
// index_add_s between them, about 85% of a global LM iteration's device
// time at 2048 cameras.
//
//   slam_ba_schur_landmarks  v_l = Hll_inv_l t_l with t = a - s (x and a
//                            given), s (x alone: the product's own
//                            term), a (a alone); one thread a landmark.
//   slam_ba_schur_cameras    out_c = h_c - sum_{o in c} W_o v_{l_o},
//                            h = Hcc_d x (the product) or b (the right
//                            side); row 0, the gauge, x_0 or 0; one block
//                            a camera.
//
// The observations are visited through two orderings the caller makes
// once per LM iteration (`cuda_kernels.schur_order`): their rows sorted
// stably by landmark with offsets (L+1), and by camera with offsets
// (C+1), each with the other index of every row beside it (int32). Any
// order of cam_idx / lm_idx is right, and cameras or landmarks with no
// observation get y = 0 or s = 0. The orderings leave out observations
// of weight zero, whose W blocks are zero (they add zeros): a global
// problem's observation bucket pads tens of thousands of rows onto
// landmark 0, and the thread of that landmark would walk them all, ~12 ms
// a product.
// W is read where it lies, (O,6,3) float32: in the camera order it is
// contiguous wherever cam_idx ascends, as a global BA's problem does.
//
// Precision as the plain twin's: every observation's product in float32
// (--fmad=false: a multiply and an add each, no fused rounding), the sums
// over a landmark's or a camera's observations in float64, rounded once
// to float32. No atomics: a landmark's sum runs in its ordering's order
// in one thread, a camera's as per-thread partial sums (thread t takes
// every CAM_THREADS-th row from t) combined by a fixed shuffle tree and then
// warp by warp, so the same operands give the same bits on every run.
// Against the twin (cuBLAS or the CPU's einsum, sums in index order) the
// products round differently and the float64 sums are associated in
// another order.
//
// What bounds it on the H100: bytes (`bounds.ba_matvec_work`): W read by
// both halves, 72 bytes an observation, and the orderings, 8 bytes an
// observation a half; Hll_inv, Hcc_d, x, v and the output are small
// (L x 48 and C x 192 bytes). At the benchmark's 511 200 observations
// that is ~45 MB per product, ~14 us at 3.35 TB/s; W alone (36.8 MB)
// is below the 50 MB L2 but, measured, is not kept there from one half
// to the next, so each half reads it. The design moves only those bytes,
// with as many loads in flight as the card holds threads:
//  - The landmark half gives a thread to each landmark (~6.5
//    observations): it loads the next row's indices and the next W row
//    while it works on the current one, so each thread keeps two rows of
//    loads in flight; v (L,3) stays in L2 for the camera half. A
//    landmark's observations run serially in its thread, so the most
//    observed landmark sets the half's tail.
//  - The camera half gives a block to each camera, its threads on
//    neighbouring rows of the camera's span, so the warp's loads of W
//    cover whole sectors where cam_idx ascends.
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W, device time of a replayed
// CUDA graph; chip_smoke.py's global-ba phase times the product on its
// own system and at the benchmark's sizes), at the benchmark's 511 144
// observations, 2048 camera rows (1000 observed) and 78 905 landmarks:
// the landmark half 0.0218 ms, the camera half 0.0199 ms, each ~62% of
// its own bytes at 3.35 TB/s, so each reads W from device memory at
// ~2.1 TB/s: W does not stay in L2 from one half to the next. The
// product 0.045 ms, 32% of `ba_matvec_work` (which counts W once),
// against 1.31 ms for the einsums it replaced in the same run. Variants
// that did not help, in one later run: the camera half staging each
// warp's 32 rows through shared memory so that its loads coalesce
// (0.0193 against 0.0204 ms, the same bits), and the landmark half over
// a copy of W in landmark order (0.0208 ms read row by row, 0.0280 staged
// 32 rows at a time through shared memory; the copy costs 0.043 ms an
// LM iteration). 70 and 40 registers, no spills.

#include <cuda_runtime.h>

namespace {

constexpr int LM_THREADS = 128;
constexpr int CAM_THREADS = 128;
constexpr int CAM_WARPS = CAM_THREADS / 32;

// W_o (Dx3, row-major). At D = 6 as 9 float2 loads: 72 bytes an
// observation keep every row 8-byte aligned. At D = 9 (108 bytes) as 27
// float loads.
template <int D>
__device__ __forceinline__ void load_w(const float* __restrict__ W, int row,
                                       float w[3 * D]) {
  if (D == 6) {
    const float2* p = reinterpret_cast<const float2*>(W) +
                      static_cast<size_t>(row) * 9;
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      const float2 q = __ldg(p + i);
      w[2 * i] = q.x;
      w[2 * i + 1] = q.y;
    }
  } else {
    const float* p = W + static_cast<size_t>(row) * (3 * D);
#pragma unroll
    for (int i = 0; i < 3 * D; ++i) w[i] = __ldg(p + i);
  }
}

template <int D>
__device__ __forceinline__ void load_x(const float* __restrict__ x, int c,
                                       float xv[D]) {
  if (D == 6) {
    const float2* p = reinterpret_cast<const float2*>(x) +
                      static_cast<size_t>(c) * 3;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float2 q = __ldg(p + i);
      xv[2 * i] = q.x;
      xv[2 * i + 1] = q.y;
    }
  } else {
    const float* p = x + static_cast<size_t>(c) * D;
#pragma unroll
    for (int i = 0; i < D; ++i) xv[i] = __ldg(p + i);
  }
}

template <int D>
__global__ void __launch_bounds__(LM_THREADS)
schur_landmarks_kernel(const float* __restrict__ W,
                       const int* __restrict__ rows,
                       const int* __restrict__ cams,
                       const int* __restrict__ off,
                       const float* __restrict__ x,
                       const float* __restrict__ a,
                       const float* __restrict__ hinv, int L,
                       float* __restrict__ v) {
  const int l = blockIdx.x * LM_THREADS + threadIdx.x;
  if (l >= L) return;
  float t[3] = {0.0f, 0.0f, 0.0f};
  if (x != nullptr) {
    double s[3] = {0.0, 0.0, 0.0};
    const int beg = __ldg(off + l);
    const int end = __ldg(off + l + 1);
    float w[3 * D], xv[D];
    if (beg < end) {
      load_w<D>(W, __ldg(rows + beg), w);
      load_x<D>(x, __ldg(cams + beg), xv);
    }
    for (int k = beg; k < end; ++k) {
      // The next row's operands are in flight while this one's product
      // is formed.
      float wn[3 * D], xn[D];
      if (k + 1 < end) {
        load_w<D>(W, __ldg(rows + k + 1), wn);
        load_x<D>(x, __ldg(cams + k + 1), xn);
      }
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        float u = w[j] * xv[0];
#pragma unroll
        for (int i = 1; i < D; ++i) u = u + w[3 * i + j] * xv[i];
        s[j] += static_cast<double>(u);
      }
      if (k + 1 < end) {
#pragma unroll
        for (int i = 0; i < 3 * D; ++i) w[i] = wn[i];
#pragma unroll
        for (int i = 0; i < D; ++i) xv[i] = xn[i];
      }
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) t[j] = static_cast<float>(s[j]);
    if (a != nullptr) {
#pragma unroll
      for (int j = 0; j < 3; ++j)
        t[j] = __ldg(a + static_cast<size_t>(l) * 3 + j) - t[j];
    }
  } else {
#pragma unroll
    for (int j = 0; j < 3; ++j) t[j] = __ldg(a + static_cast<size_t>(l) * 3 + j);
  }
  const float* h = hinv + static_cast<size_t>(l) * 9;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float acc = __ldg(h + 3 * i) * t[0];
    acc = acc + __ldg(h + 3 * i + 1) * t[1];
    acc = acc + __ldg(h + 3 * i + 2) * t[2];
    v[static_cast<size_t>(l) * 3 + i] = acc;
  }
}

// At D = 6 (the stereo rig) row 0 is the gauge: x_0, or 0 without x.
template <int D>
__global__ void __launch_bounds__(CAM_THREADS)
schur_cameras_kernel(const float* __restrict__ W,
                     const int* __restrict__ rows,
                     const int* __restrict__ lms,
                     const int* __restrict__ off,
                     const float* __restrict__ v,
                     const float* __restrict__ hcc,
                     const float* __restrict__ x,
                     const float* __restrict__ b,
                     float* __restrict__ out) {
  __shared__ double part[CAM_WARPS][D];
  const int c = blockIdx.x;
  const int beg = __ldg(off + c);
  const int end = __ldg(off + c + 1);
  double y[D];
#pragma unroll
  for (int i = 0; i < D; ++i) y[i] = 0.0;
  for (int k = beg + threadIdx.x; k < end; k += CAM_THREADS) {
    float w[3 * D];
    load_w<D>(W, __ldg(rows + k), w);
    const float* vp = v + static_cast<size_t>(__ldg(lms + k)) * 3;
    const float v0 = __ldg(vp), v1 = __ldg(vp + 1), v2 = __ldg(vp + 2);
#pragma unroll
    for (int i = 0; i < D; ++i) {
      float acc = w[3 * i] * v0;
      acc = acc + w[3 * i + 1] * v1;
      acc = acc + w[3 * i + 2] * v2;
      y[i] += static_cast<double>(acc);
    }
  }
  // Fixed-order tree within the warp, then the warps in order.
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
#pragma unroll
    for (int i = 0; i < D; ++i) y[i] += __shfl_xor_sync(0xffffffffu, y[i], d);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < D; ++i) part[warp][i] = y[i];
  }
  __syncthreads();
  const int i = threadIdx.x;
  if (i >= D) return;
  double sum = part[0][i];
#pragma unroll
  for (int q = 1; q < CAM_WARPS; ++q) sum += part[q][i];
  const size_t at = static_cast<size_t>(c) * D + i;
  if (D == 6 && c == 0) {             // the gauge: camera 0 is held fixed
    out[at] = x != nullptr ? __ldg(x + i) : 0.0f;
    return;
  }
  float h;
  if (hcc != nullptr) {
    const float* hr = hcc + static_cast<size_t>(c) * (D * D) + D * i;
    const float* xc = x + static_cast<size_t>(c) * D;
    h = __ldg(hr) * __ldg(xc);
#pragma unroll
    for (int j = 1; j < D; ++j) h = h + __ldg(hr + j) * __ldg(xc + j);
  } else {
    h = __ldg(b + at);
  }
  out[at] = h - static_cast<float>(sum);
}

}  // namespace

extern "C" {

// v (L,3) = Hll_inv (a - s) / Hll_inv s / Hll_inv a, s from x (C,D) over
// the landmark ordering (rows, cams: (O,) int32; off: (L+1,) int32), W
// (O,D,3), D 6 or 9. x or a may be null, not both. L >= 1.
int slam_ba_schur_landmarks(const float* W, const int* rows, const int* cams,
                            const int* off, const float* x, const float* a,
                            const float* hinv, int L, int D, float* v,
                            cudaStream_t stream) {
  const int blocks = (L + LM_THREADS - 1) / LM_THREADS;
  if (D == 6)
    schur_landmarks_kernel<6><<<blocks, LM_THREADS, 0, stream>>>(
        W, rows, cams, off, x, a, hinv, L, v);
  else if (D == 9)
    schur_landmarks_kernel<9><<<blocks, LM_THREADS, 0, stream>>>(
        W, rows, cams, off, x, a, hinv, L, v);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// out (C,D) = Hcc_d x - y (hcc and x given) or b - y (b given, hcc and x
// null), y_c = sum of W_o v_{l_o} over the camera ordering (rows, lms:
// (O,) int32; off: (C+1,) int32), D 6 or 9; at D = 6 row 0 is x_0, or 0
// without x. C >= 1.
int slam_ba_schur_cameras(const float* W, const int* rows, const int* lms,
                          const int* off, const float* v, const float* hcc,
                          const float* x, const float* b, int C, int D,
                          float* out, cudaStream_t stream) {
  if (D == 6)
    schur_cameras_kernel<6><<<C, CAM_THREADS, 0, stream>>>(
        W, rows, lms, off, v, hcc, x, b, out);
  else if (D == 9)
    schur_cameras_kernel<9><<<C, CAM_THREADS, 0, stream>>>(
        W, rows, lms, off, v, hcc, x, b, out);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
