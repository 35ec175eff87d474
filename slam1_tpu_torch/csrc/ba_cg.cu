// The vector update of bundle adjustment's preconditioned conjugate
// gradients on the CG path, for Hopper (sm_90a): everything one iteration
// does after its product Ap = S p, in one launch, and its start in a second
// entry of the same kernel.
//
// Replaces no TPU kernel. The reference writes the iteration as
// `ops/cg.py`'s scan body with the block-Jacobi preconditioner's einsum
// (slam1_tpu/ops/cg.py `cg`, slam1_tpu/models/ba.py `_schur_solve`), which
// XLA fuses into a few programs. In the port the same body was ~26 small
// PyTorch kernels and a cuBLAS gemv an iteration on (C,6) vectors (48 KB
// at 2048 cameras), each a launch of ~1.5 us waiting on the one before:
// ~40% of a global LM iteration's device time at 2048 cameras, none of it
// bound by bytes or operations.
//
//   slam_ba_cg_update  step (p given): denom = p.Ap; alpha = rz / denom,
//                      eps where |denom| < eps, 0 once rz <= eps;
//                      x' = x + alpha p; r' = r - alpha Ap; z = Minv r'
//                      (a 6x6 block a camera); rz' = r'.z; beta = rz' / rz,
//                      eps where |rz| < eps, 0 once rz <= eps;
//                      p' = z + beta p; written: x', r', p', rz'.
//                      start (p null): z = Minv r; written: p' = z,
//                      rz' = r.z.
// That is `ops/cg.cg`'s iteration, guards and all, and its start after
// r = b - S x0 (`cuda_kernels.ba_cg_step_plain`, `ba_cg_start_plain`).
//
// The kernel is a template on the camera block's width D: 6 for the
// stereo rig's SE(3) twists, 9 for BAL's cameras (9x9 preconditioner
// blocks; a camera's vectors and block read as floats, 36 and 324 bytes,
// 4-byte aligned). The D = 6 instantiation is the code written for it.
//
// Design: the vectors are tiny, so the launch is bound by latency, not by
// bytes (`utils/bounds.ba_cg_work`: p, Ap, x, r and Minv read, x, r and p
// written, 312 bytes a camera, 0.19 us at 2048 cameras and 3.35 TB/s). It
// runs as ONE thread-block cluster (the grid is the cluster): a camera a
// thread where C allows, each thread holding its first camera's operands
// in registers, loaded before the first reduction so that their latency
// overlaps it. The two dot products are cluster-wide reductions through
// distributed shared memory: no second launch, no atomics, no round trip
// through device memory; each block writes its sum into every block's
// shared memory before the barrier, so that after it each block reads
// only its own (two cluster barriers a step, no read across the cluster,
// and none needed before a block may leave). The wrapper sizes the cluster and the blocks from
// C (`cuda_kernels.ba_cg_launch`): up to the card's largest cluster
// (non-portable sizes allowed, at most MAX_CLUSTER) of MAX_THREADS-thread
// blocks at most; past cluster x MAX_THREADS cameras a thread takes every
// (cluster x threads)-th camera from its first, the later ones' z kept in
// p' until beta is known.
//
// Precision: float32 storage, as the plain twin; the vector updates and
// z in float32 in the twin's order of operations (--fmad=false: a multiply
// and an add each; z_i = sum_j Minv_ij r_j from j = 0), the two dot
// products in float64 (each product of two float32 exact in float64),
// rounded once to float32: at least as close as the twin's float32 sums.
// No atomics: a thread sums its cameras in order, a warp by a fixed
// shuffle tree, a block warp by warp, and every block sums the cluster's
// block sums in block order from its own copy of them, so every block
// holds the same total and the same operands give the same bits on every
// run.
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; one step at the benchmark's
// 2048 camera rows, 1000 observed, 64 launches back to back in a CUDA
// graph, two turns): a cluster of 16 blocks of 128 threads (what
// `ba_cg_launch` takes at 2048 rows) 4.65-4.82 us a launch; 12 x 192
// 4.90; 8 x 256 5.13-5.29; 16 x 256 5.49-5.50; 8 x 128 (two cameras a
// thread) 5.76-5.79; 4 x 256 7.39; 2 x 256 11.5; one block of 256 threads
// 19.1; the twin's torch operations 38.6 us. An earlier form of the
// reductions, which read the other blocks' sums across the cluster after
// the barrier and so needed a third barrier before a block could leave,
// took 5.31-5.47 us at 16 x 128. 100 registers, no spills. In a replay
// of the LM iteration the profiler gives it 4.9 us a launch, 0.32 ms of
// the iteration's 3.99 (`PERF.md` §5).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cgrp = cooperative_groups;

namespace {

constexpr int MAX_THREADS = 256;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr int MAX_CLUSTER = 16;

// A camera's D-vector: at D = 6 as 3 float2 (8-byte aligned rows), at
// D = 9 as 9 floats.
template <int D>
__device__ __forceinline__ void load_v(const float* __restrict__ v, int c,
                                       float out[D]) {
  if (D == 6) {
    const float2* q = reinterpret_cast<const float2*>(v) +
                      static_cast<size_t>(c) * 3;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float2 t = __ldg(q + i);
      out[2 * i] = t.x;
      out[2 * i + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < D; ++i) out[i] = __ldg(v + static_cast<size_t>(c) * D + i);
  }
}

template <int D>
__device__ __forceinline__ void store_v(float* v, int c, const float in[D]) {
  if (D == 6) {
    float2* q = reinterpret_cast<float2*>(v) + static_cast<size_t>(c) * 3;
#pragma unroll
    for (int i = 0; i < 3; ++i) q[i] = make_float2(in[2 * i], in[2 * i + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < D; ++i) v[static_cast<size_t>(c) * D + i] = in[i];
  }
}

// Minv_c (DxD, row-major). At D = 6 as 9 float4 loads: 144 bytes a camera
// keep every block 16-byte aligned. At D = 9 as 81 floats.
template <int D>
__device__ __forceinline__ void load_m(const float* __restrict__ m, int c,
                                       float out[D * D]) {
  if (D == 6) {
    const float4* q = reinterpret_cast<const float4*>(m) +
                      static_cast<size_t>(c) * 9;
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      const float4 t = __ldg(q + i);
      out[4 * i] = t.x;
      out[4 * i + 1] = t.y;
      out[4 * i + 2] = t.z;
      out[4 * i + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < D * D; ++i)
      out[i] = __ldg(m + static_cast<size_t>(c) * (D * D) + i);
  }
}

template <int D>
__device__ __forceinline__ void dot(const float a[D], const float b[D],
                                    double& sum) {
#pragma unroll
  for (int i = 0; i < D; ++i)
    sum += static_cast<double>(a[i]) * static_cast<double>(b[i]);
}

// x' = x + alpha p and r' = r - alpha Ap (step), then z = Minv r' and
// r'.z added to `sum`; r holds r' on return.
template <int D>
__device__ __forceinline__ void update(bool step, float alpha,
                                       const float p[D], const float ap[D],
                                       float x[D], float r[D],
                                       const float m[D * D], float z[D],
                                       double& sum) {
  if (step) {
#pragma unroll
    for (int i = 0; i < D; ++i) {
      x[i] = x[i] + alpha * p[i];
      r[i] = r[i] - alpha * ap[i];
    }
  }
#pragma unroll
  for (int i = 0; i < D; ++i) {
    float acc = m[D * i] * r[0];
#pragma unroll
    for (int j = 1; j < D; ++j) acc = acc + m[D * i + j] * r[j];
    z[i] = acc;
  }
  dot<D>(r, z, sum);
}

// The cluster's sum of every thread's v, the same bits in every thread of
// every block: a shuffle tree in each warp, the warps in order, then the
// blocks' sums in block order. Each block pushes its sum into a word of
// its own in every block's `slot` (thread k writes block k's) before the
// cluster barrier, and every thread then sums its own block's copy: no
// read of another block's shared memory, so after the last barrier of
// the launch no block touches another's. `slot` is this reduction's own
// shared memory, so that two reductions of one launch never share a word.
struct Slot {
  double warp[MAX_WARPS];
  double block[MAX_CLUSTER];
};

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ double cluster_sum(double v, Slot& slot) {
  cgrp::cluster_group cluster = cgrp::this_cluster();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = static_cast<int>(cluster.num_blocks());
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
  if (lane == 0) slot.warp[warp] = v;
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < n) {
    double s = slot.warp[0];
    for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w)
      s += slot.warp[w];
    *cluster.map_shared_rank(&slot.block[cluster.block_rank()],
                             threadIdx.x) = s;
  }
  cluster.sync();                     // every block's sum is in every block
  double t = slot.block[0];
  for (int k = 1; k < n; ++k) t += slot.block[k];
  return t;
}

template <int D>
__global__ void __launch_bounds__(MAX_THREADS)
cg_update_kernel(const float* __restrict__ p, const float* __restrict__ ap,
                 const float* __restrict__ x, const float* __restrict__ r,
                 const float* __restrict__ minv,
                 const float* __restrict__ rz, int C, float eps,
                 float* __restrict__ x_out, float* __restrict__ r_out,
                 float* __restrict__ p_out, float* __restrict__ rz_out) {
  __shared__ Slot slots[2];
  // Every block has started (its shared memory exists) before any block
  // writes into it: arrived here, waited for before the first push.
  cluster_arrive_relaxed();
  const bool step = p != nullptr;
  const int stride = gridDim.x * blockDim.x;
  const int c0 = blockIdx.x * blockDim.x + threadIdx.x;
  const bool has0 = c0 < C;
  // The first camera's operands, in flight during the first reduction.
  float p0[D], ap0[D], x0[D], r0[D], m0[D * D], z0[D];
  if (has0) {
    load_v<D>(r, c0, r0);
    load_m<D>(minv, c0, m0);
    if (step) {
      load_v<D>(p, c0, p0);
      load_v<D>(ap, c0, ap0);
      load_v<D>(x, c0, x0);
    }
  }
  float alpha = 0.0f, rz_old = 0.0f;
  bool alive = false;
  cluster_wait();
  if (step) {
    double part = 0.0;
    if (has0) dot<D>(p0, ap0, part);
    for (int c = c0 + stride; c < C; c += stride) {
      float pv[D], av[D];
      load_v<D>(p, c, pv);
      load_v<D>(ap, c, av);
      dot<D>(pv, av, part);
    }
    const float denom = static_cast<float>(cluster_sum(part, slots[0]));
    rz_old = __ldg(rz);
    alpha = rz_old / (fabsf(denom) < eps ? eps : denom);
    alive = rz_old > eps;           // freeze once the residual has vanished
    if (!alive) alpha = 0.0f;
  }
  double part = 0.0;
  if (has0) {
    update<D>(step, alpha, p0, ap0, x0, r0, m0, z0, part);
    if (step) {
      store_v<D>(x_out, c0, x0);
      store_v<D>(r_out, c0, r0);
    } else {
      store_v<D>(p_out, c0, z0);
    }
  }
  for (int c = c0 + stride; c < C; c += stride) {
    float pv[D], av[D], xv[D], rv[D], m[D * D], z[D];
    load_v<D>(r, c, rv);
    load_m<D>(minv, c, m);
    if (step) {
      load_v<D>(p, c, pv);
      load_v<D>(ap, c, av);
      load_v<D>(x, c, xv);
    }
    update<D>(step, alpha, pv, av, xv, rv, m, z, part);
    if (step) {
      store_v<D>(x_out, c, xv);
      store_v<D>(r_out, c, rv);
    }
    store_v<D>(p_out, c, z);            // z, until beta is known (step)
  }
  const float rz_new = static_cast<float>(cluster_sum(part, slots[1]));
  if (step) {
    float beta = rz_new / (fabsf(rz_old) < eps ? eps : rz_old);
    if (!alive) beta = 0.0f;
    if (has0) {
      float pn[D];
#pragma unroll
      for (int i = 0; i < D; ++i) pn[i] = z0[i] + beta * p0[i];
      store_v<D>(p_out, c0, pn);
    }
    for (int c = c0 + stride; c < C; c += stride) {
      float pv[D], pn[D];
      load_v<D>(p, c, pv);
      // This thread's own z, written above: a plain load, not __ldg.
      if (D == 6) {
        const float2* q = reinterpret_cast<const float2*>(p_out) +
                          static_cast<size_t>(c) * 3;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const float2 t = q[i];
          pn[2 * i] = t.x + beta * pv[2 * i];
          pn[2 * i + 1] = t.y + beta * pv[2 * i + 1];
        }
      } else {
#pragma unroll
        for (int i = 0; i < D; ++i)
          pn[i] = p_out[static_cast<size_t>(c) * D + i] + beta * pv[i];
      }
      store_v<D>(p_out, c, pn);
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *rz_out = rz_new;
}

template <int D>
int max_cluster() {
  cudaError_t err = cudaFuncSetAttribute(
      cg_update_kernel<D>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(MAX_CLUSTER);
  cfg.blockDim = dim3(MAX_THREADS);
  int size = 0;
  err = cudaOccupancyMaxPotentialClusterSize(&size, cg_update_kernel<D>,
                                             &cfg);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return size < MAX_CLUSTER ? size : MAX_CLUSTER;
}

}  // namespace

extern "C" {

// The most threads a block of the launch takes.
int slam_ba_cg_max_threads() { return MAX_THREADS; }

// The largest cluster of MAX_THREADS-thread blocks the kernel at width D
// (6 or 9) can launch on the current device, non-portable sizes allowed,
// at most MAX_CLUSTER; -(CUDA error) where a query fails. Called once a
// width, before any launch: it also allows the kernel clusters above the
// portable 8.
int slam_ba_cg_max_cluster(int D) {
  if (D == 6) return max_cluster<6>();
  if (D == 9) return max_cluster<9>();
  return -static_cast<int>(cudaErrorInvalidValue);
}

// One launch over C >= 1 camera rows of width D (6 or 9) as a cluster of
// `blocks` blocks of `threads` threads (a multiple of 32). Step: p, ap,
// x, r (C,D), minv (C,D,D), rz () -> x_out, r_out, p_out (C,D), rz_out
// (); start (p, ap, x, rz, x_out and r_out null): r, minv -> p_out,
// rz_out. Outputs may not alias inputs. At D = 6 vectors 8-byte aligned,
// minv 16-byte aligned.
int slam_ba_cg_update(const float* p, const float* ap, const float* x,
                      const float* r, const float* minv, const float* rz,
                      int C, int D, float eps, int blocks, int threads,
                      float* x_out, float* r_out, float* p_out, float* rz_out,
                      cudaStream_t stream) {
  if (C < 1 || blocks < 1 || blocks > MAX_CLUSTER || threads < 32 ||
      threads > MAX_THREADS || threads % 32 != 0 || (D != 6 && D != 9))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      D == 6 ? cudaLaunchKernelEx(&cfg, cg_update_kernel<6>, p, ap, x, r,
                                  minv, rz, C, eps, x_out, r_out, p_out,
                                  rz_out)
             : cudaLaunchKernelEx(&cfg, cg_update_kernel<9>, p, ap, x, r,
                                  minv, rz, C, eps, x_out, r_out, p_out,
                                  rz_out);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
