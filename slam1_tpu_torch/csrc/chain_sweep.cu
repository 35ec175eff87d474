// Square-root chain preconditioner of the pose-graph CG, for Hopper
// (sm_90a).
//
// Replaces: the two lax.scan sweeps of
// slam1_tpu/models/posegraph.py:_chain_sqrt_solve (an XLA scan in the
// reference, not a Pallas kernel). For pose-indexed rows i in [1, F):
//   backward  s_i = JjInv_i^T (v_i - Ji_{i+1}^T s_{i+1}),  s_F = 0
//   scale     u_i = winv_i s_i
//   forward   x_i = JjInv_i (u_i - Ji_i x_{i-1}),          x_0 = 0
// with x_0 = 0 on output. Rows from `n_live` on must be decoupled from
// the chain (Ji = 0 and JjInv = I there: no chain edge reaches them),
// so their solution is x_i = winv_i v_i exactly and the sweeps stop at
// n_live - 1; with n_live = F this is the reference's recurrence.
//
// The kernels read n_live from device memory (a 0-d int32 tensor), and
// the grids and the shared memory are sized from F alone, so that one
// launch captured in a CUDA graph is right for every n_live the graph is
// replayed with: a pose graph's live rows grow from one relaxation to
// the next while its bucket F stays. A sweep whose n_live lies outside
// [1, F] writes NaN to all of x.
//
// What bounds it on the H100: the latency of a dependent chain (the
// bytes, 2048 x 85 floats, and the 0.2 MFLOP are nothing). The design
// shortens what each row adds to that chain, and then the chain:
//  - Both recurrences are affine in the running 6-vector,
//      s_i = c_i + A_i s_{i+1},  A_i = -JjInv_i^T Ji_{i+1}^T,  c_i = JjInv_i^T v_i
//      x_i = e_i + A'_i x_{i-1}, A'_i = -JjInv_i Ji_i,  e_i = JjInv_i (winv_i s_i)
//    and JjInv, Ji are fixed for a Gauss-Newton iteration while the
//    preconditioner is applied ~65 times. slam_chain_prepare forms the
//    blocks once per iteration; every sweep computes c_i, and after the
//    backward sweep e_i, for all rows at once. The chain carries one
//    6x6 product per row, not two.
//  - The chain is cut into K = 2^(LEVELS-1) = 8 interleaved chains by
//    doubling: y_k = d_k + A_k y_{k-1} gives y_k = d2_k + A2_k y_{k-2}
//    with A2_k = A_k A_{k-1}, d2_k = d_k + A_k d_{k-1}, and so on. The
//    block products of every level are part of the prepared value (they
//    too hold for the whole iteration); a sweep doubles its offsets in
//    LEVELS - 1 steps, all rows at once, and then K warps march the K
//    chains y_k = dK_k + AK_k y_{k-K}, k = w, w + K, ..., side by side.
//    The depth is n_live / K rows and LEVELS - 1 parallel steps.
//  - A warp marches with lane a owning component a of the running vector
//    in a register, fetching the six components by __shfl_sync. It
//    copies the blocks it will need into its shared-memory ring with
//    cp.async, two chunks ahead (the first two before the offsets are
//    ready), and reads each row's operands into registers one row ahead,
//    so no load from device memory sits on the chain. The six products
//    are summed as three short fused chains. A march stores to shared
//    memory only: a store to device memory costs it ~100 clocks a row.
//  - The steps over all rows give a row to 8 neighbouring lanes, 6 of
//    which work. Rows from n_live on are written by the other blocks of
//    the launch. Both sweeps stay in one launch; the offsets live in
//    shared memory (24 bytes per live row, twice where that fits, else
//    they alternate with the output buffer while they are doubled).
//  - Past slam_chain_sweep_max_live() rows (8533) the offsets do not fit
//    in shared memory. For such an F the launch keeps them in a device
//    scratch buffer of (2, F, 6) floats that the caller allocates, and
//    each march copies a chunk's offsets into shared memory with
//    cp.async one chunk ahead, marches them there in place and writes
//    them back after. The choice is made from F alone, so a captured
//    launch stays right for every n_live; the arithmetic is the same,
//    and so are the bits.
// No atomics and no order that depends on scheduling: the same operands
// give the same bits on every run.
//
// Measured (kernel_bench.py, NVIDIA H100 80GB HBM3, 700.00 W, device
// time of a replayed CUDA graph), 2048 poses: 0.0359 ms at 601 live rows
// and 0.1056 ms at 2048, against 0.3496 and 1.1464 ms for the one-thread
// march this design replaced, in the same run. The prepare launches take
// 0.0068 ms together. With the number of chains still an argument, 1 /
// 2 / 4 / 8 / 16 chains took 0.0822 / 0.0499 / 0.0384 / 0.0368 / 0.0399
// ms at 601 rows, so 8 is built in. The bound of the function itself
// (JjInv and Ji of the live rows, winv, v and x moved once: 0.28 MB) is
// 0.00008 ms: 0.2 % of it is reached. What is left is latency inside
// one block: a sweep is ten steps over all rows (five passes of 1024
// threads each at 601 rows) and two marches of 75 rows; from 8 to 16
// chains the two added steps cost more than the halved marches save. 64
// registers, no spills.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 1024;
constexpr int LEVELS = 4;       // block strides 1, 2, 4, 8
constexpr int CHAINS = 1 << (LEVELS - 1);   // interleaved chains, a warp each
constexpr int STAGES = 3;       // chunks in a warp's shared-memory ring
constexpr int MAX_SMEM = 227 * 1024;

// Level 0 of prep (LEVELS, 2, F, 6, 6): [0][i] = A_i (backward, zero
// unless 1 <= i and i + 1 < n_live), [1][i] = A'_i (forward, zero unless
// 2 <= i < n_live: x_0 = 0 takes no block).
__global__ void chain_prepare_kernel(const float* __restrict__ jj_inv,
                                     const float* __restrict__ ji, int F,
                                     const int* __restrict__ live,
                                     float* __restrict__ prep) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= F * 72) return;
  const int n_live = min(*live, F);
  const int i = k / 72;
  const int which = (k % 72) / 36;
  const int a = (k % 36) / 6;
  const int b = k % 6;
  float acc = 0.0f;
  if (i >= 1 && i < n_live) {
    const float* jj = jj_inv + static_cast<size_t>(i) * 36;
    if (which == 0) {
      if (i + 1 < n_live) {
        const float* jn = ji + static_cast<size_t>(i + 1) * 36;
#pragma unroll
        for (int c = 0; c < 6; ++c) acc -= jj[c * 6 + a] * jn[b * 6 + c];
      }
    } else if (i >= 2) {
      const float* jc = ji + static_cast<size_t>(i) * 36;
#pragma unroll
      for (int c = 0; c < 6; ++c) acc -= jj[a * 6 + c] * jc[c * 6 + b];
    }
  }
  prep[(static_cast<size_t>(which) * F + i) * 36 + k % 36] = acc;
}

// One doubling of the blocks: hi_i = lo_i lo_p with p = i + j (backward)
// or i - j (forward), zero where p leaves the live rows [1, n_live).
__global__ void chain_double_kernel(const float* __restrict__ lo, int F,
                                    const int* __restrict__ live, int j,
                                    float* __restrict__ hi) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= F * 72) return;
  const int n_live = min(*live, F);
  const int i = k / 72;
  const int which = (k % 72) / 36;
  const int a = (k % 36) / 6;
  const int b = k % 6;
  const int p = which == 0 ? i + j : i - j;
  float acc = 0.0f;
  if (i >= 1 && i < n_live && p >= 1 && p < n_live) {
    const float* li = lo + (static_cast<size_t>(which) * F + i) * 36;
    const float* lp = lo + (static_cast<size_t>(which) * F + p) * 36;
#pragma unroll
    for (int c = 0; c < 6; ++c) acc += li[a * 6 + c] * lp[c * 6 + b];
  }
  hi[(static_cast<size_t>(which) * F + i) * 36 + k % 36] = acc;
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async8(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
               :: "r"(s), "l"(gmem) : "memory");
}

// One warp's march of `count` rows from `first` in steps of `step`:
//   y_r = vec[r] + B_r y_prev,  y_prev = 0 before the first row,
// B_r the 6x6 block at blocks + 36 r, through the warp's ring of STAGES
// chunks of `chunk` rows.
struct March {
  const float* blocks;
  float* ring;
  int chunk, first, step, count;

  // Start the copy of chunk c into its slot of the ring, 16 bytes per
  // copy, and close the copy group (an empty one past the last chunk,
  // so the groups stay in step).
  __device__ __forceinline__ void stage(int c, int lane) const {
    const int k0 = c * chunk;
    const int rows = min(chunk, count - k0);
    float* slot = ring + (c % STAGES) * (chunk * 36);
    for (int q = lane; q < rows * 9; q += 32) {
      const int kk = q / 9, part = q % 9;
      const int r = first + (k0 + kk) * step;
      cp_async16(slot + kk * 36 + part * 4,
                 blocks + static_cast<size_t>(r) * 36 + part * 4);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  // The copies that can start before the offsets are known.
  __device__ __forceinline__ void begin(int lane) const {
#pragma unroll
    for (int c = 0; c < STAGES - 1; ++c) stage(c, lane);
  }

  // The march, in place in vec (shared memory), after begin(). Lane l
  // works on component l % 6 (lanes from 6 on repeat the first six, so
  // the warp never diverges) and lanes 0..5 store y_r over vec[r]. Each
  // row's operands are in registers one row ahead; vec is read ahead of
  // the row being written.
  __device__ __forceinline__ void run(float* vec, int lane) const {
    const int a = lane % 6;
    const int chunks = (count + chunk - 1) / chunk;
    float y = 0.0f;
    for (int c = 0; c < chunks; ++c) {
      // All but the newest STAGES - 2 groups are done: chunk c is in.
      asm volatile("cp.async.wait_group %0;\n" :: "n"(STAGES - 2) : "memory");
      __syncwarp();
      // The slot of chunk c - 1, which every lane has left.
      stage(c + STAGES - 1, lane);
      const float* slot = ring + (c % STAGES) * (chunk * 36) + a * 6;
      const int k0 = c * chunk;
      const int rows = min(chunk, count - k0);
      const float2* p = reinterpret_cast<const float2*>(slot);
      float2 m0 = p[0], m1 = p[1], m2 = p[2];
      float d = vec[(first + k0 * step) * 6 + a];
#pragma unroll 4
      for (int kk = 0; kk < rows; ++kk) {
        const int r = first + (k0 + kk) * step;
        // Next row's operands (the slot's row past the chunk is never
        // used; vec's index stays inside the live rows).
        const int kn = min(kk + 1, rows - 1);
        const float2* pn = reinterpret_cast<const float2*>(slot + kn * 36);
        const float2 n0 = pn[0], n1 = pn[1], n2 = pn[2];
        const float dn = vec[(first + (k0 + kn) * step) * 6 + a];
        const float y0 = __shfl_sync(0xffffffffu, y, 0);
        const float y1 = __shfl_sync(0xffffffffu, y, 1);
        const float y2 = __shfl_sync(0xffffffffu, y, 2);
        const float y3 = __shfl_sync(0xffffffffu, y, 3);
        const float y4 = __shfl_sync(0xffffffffu, y, 4);
        const float y5 = __shfl_sync(0xffffffffu, y, 5);
        const float s0 = __fmaf_rn(m0.y, y1, __fmaf_rn(m0.x, y0, d));
        const float s1 = __fmaf_rn(m1.y, y3, m1.x * y2);
        const float s2 = __fmaf_rn(m2.y, y5, m2.x * y4);
        y = s0 + (s1 + s2);
        if (lane < 6) vec[r * 6 + a] = y;
        m0 = n0;
        m1 = n1;
        m2 = n2;
        d = dn;
      }
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncwarp();
  }

  // Start the copy of chunk c's offsets (rows of 6 floats in vec, 8
  // bytes per copy) into its half of `offs`, the warp's two slots of
  // `chunk` rows in shared memory, and close the copy group (an empty
  // one past the last chunk).
  __device__ __forceinline__ void stage_offsets(int c, const float* vec,
                                                float* offs, int lane) const {
    const int k0 = c * chunk;
    const int rows = min(chunk, count - k0);
    float* slot = offs + (c & 1) * (chunk * 6);
    for (int q = lane; q < rows * 3; q += 32) {
      const int kk = q / 3, part = q % 3;
      const int r = first + (k0 + kk) * step;
      cp_async8(slot + kk * 6 + part * 2,
                vec + static_cast<size_t>(r) * 6 + part * 2);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  // run() with the offsets in device memory (vec), after begin(): a
  // chunk's offsets reach their slot of `offs` one chunk ahead, in the
  // copy group before the blocks two chunks ahead, so that the wait of
  // run() covers them too; each chunk is marched in its slot exactly as
  // run() marches it in vec, then written back to vec.
  __device__ __forceinline__ void run_staged(float* vec, float* offs,
                                             int lane) const {
    const int a = lane % 6;
    const int chunks = (count + chunk - 1) / chunk;
    for (int q = lane; q < min(chunk, count) * 6; q += 32) {
      offs[q] = vec[static_cast<size_t>(first + (q / 6) * step) * 6 + q % 6];
    }
    float y = 0.0f;
    for (int c = 0; c < chunks; ++c) {
      // Chunk c's blocks and offsets are in, and every lane has left the
      // slots that the copies below refill.
      asm volatile("cp.async.wait_group %0;\n" :: "n"(STAGES - 2) : "memory");
      __syncwarp();
      stage_offsets(c + 1, vec, offs, lane);
      stage(c + STAGES - 1, lane);
      const float* slot = ring + (c % STAGES) * (chunk * 36) + a * 6;
      float* ys = offs + (c & 1) * (chunk * 6);
      const int k0 = c * chunk;
      const int rows = min(chunk, count - k0);
      const float2* p = reinterpret_cast<const float2*>(slot);
      float2 m0 = p[0], m1 = p[1], m2 = p[2];
      float d = ys[a];
#pragma unroll 4
      for (int kk = 0; kk < rows; ++kk) {
        const int kn = min(kk + 1, rows - 1);
        const float2* pn = reinterpret_cast<const float2*>(slot + kn * 36);
        const float2 n0 = pn[0], n1 = pn[1], n2 = pn[2];
        const float dn = ys[kn * 6 + a];
        const float y0 = __shfl_sync(0xffffffffu, y, 0);
        const float y1 = __shfl_sync(0xffffffffu, y, 1);
        const float y2 = __shfl_sync(0xffffffffu, y, 2);
        const float y3 = __shfl_sync(0xffffffffu, y, 3);
        const float y4 = __shfl_sync(0xffffffffu, y, 4);
        const float y5 = __shfl_sync(0xffffffffu, y, 5);
        const float s0 = __fmaf_rn(m0.y, y1, __fmaf_rn(m0.x, y0, d));
        const float s1 = __fmaf_rn(m1.y, y3, m1.x * y2);
        const float s2 = __fmaf_rn(m2.y, y5, m2.x * y4);
        y = s0 + (s1 + s2);
        if (lane < 6) ys[kk * 6 + a] = y;
        m0 = n0;
        m1 = n1;
        m2 = n2;
        d = dn;
      }
      __syncwarp();
      for (int q = lane; q < rows * 6; q += 32) {
        vec[static_cast<size_t>(first + (k0 + q / 6) * step) * 6 + q % 6] =
            ys[q];
      }
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncwarp();
  }
};

// For every live row i and component a:
//   dst_i[a] = (base ? base_i[a] : 0) + sum_b M_i[a][b] scale_i vecs_p[b]
// with M_i the 6x6 block at mats + 36 i (its transpose if TRANSPOSED),
// p = i + shift, scale_i = scale ? scale[i] : 1; the sum is left out
// where p leaves [1, n_live). A row goes to 8 neighbouring lanes, of
// which 6 work, one per component: a warp reads 4 rows of blocks in one
// piece, and since a row's lanes sit in one warp, dst may be vecs when
// shift == 0.
template <bool TRANSPOSED>
__device__ __forceinline__ void rows_step(const float* __restrict__ mats,
                                          const float* vecs, int shift,
                                          const float* base,
                                          const float* __restrict__ scale,
                                          float* dst, int n_live, int tid) {
  for (int first = 0; first < (n_live - 1) * 8; first += THREADS) {
    const int i = 1 + ((first + tid) >> 3);
    const int a = tid & 7;
    const bool live = i < n_live && a < 6;
    const int p = i + shift;
    float out = 0.0f;
    if (live && base) out = base[i * 6 + a];
    if (live && p >= 1 && p < n_live) {
      const float* block = mats + static_cast<size_t>(i) * 36;
      const float* vp = vecs + p * 6;
      const float sc = scale ? scale[i] : 1.0f;
#pragma unroll
      for (int b = 0; b < 6; ++b) {
        const float m = __ldg(TRANSPOSED ? block + b * 6 + a : block + a * 6 + b);
        out = __fmaf_rn(m, sc * vp[b], out);
      }
    }
    __syncwarp();
    if (live) dst[i * 6 + a] = out;
  }
}

// Double the offsets in `cur` LEVELS - 1 times, alternating between vec
// and alt and ending in vec, then march them there: backward (from row
// n_live - 1 down, a row's step reaching up) or forward (from row 1).
// `prep` is the direction's half of level 0. STAGED: vec is in device
// memory and the march stages it through the warp's `offs`.
template <bool STAGED>
__device__ __forceinline__ void solve(const float* __restrict__ prep, int F,
                                      bool backward, const March& march,
                                      float* cur, float* vec, float* alt,
                                      float* offs, int n_live, int tid) {
  const size_t level = static_cast<size_t>(F) * 72;
  for (int l = 0; l + 1 < LEVELS; ++l) {
    float* nxt = cur == vec ? alt : vec;
    rows_step<false>(prep + l * level, cur, backward ? (1 << l) : -(1 << l),
                     cur, nullptr, nxt, n_live, tid);
    __syncthreads();
    cur = nxt;
  }
  if (march.count > 0) {
    if constexpr (STAGED) {
      march.run_staged(vec, offs, tid & 31);
    } else {
      march.run(vec, tid & 31);
    }
  }
  __syncthreads();
}

// STAGED: the offsets in `scratch` (2, F, 6) in device memory (see the
// head of the file); else in shared memory, and scratch is not read.
template <bool STAGED>
__global__ void __launch_bounds__(THREADS)
chain_sweep_kernel(const float* __restrict__ jj_inv,
                   const float* __restrict__ prep,
                   const float* __restrict__ winv,
                   const float* __restrict__ v, int F,
                   const int* __restrict__ live, int rows, int chunk,
                   int alt_in_smem, float* scratch, float* x) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int n_live = *live;
  if (n_live < 1 || n_live > rows) {
    for (int k = blockIdx.x * THREADS + tid; k < F * 6;
         k += gridDim.x * THREADS) {
      x[k] = __int_as_float(0x7fc00000);
    }
    return;
  }

  // The decoupled rows, on the blocks after the first (as many as
  // n_live = 1 needs); the sweeps never read them.
  if (blockIdx.x > 0) {
    const int k = n_live * 6 + (blockIdx.x - 1) * THREADS + tid;
    if (k < F * 6) x[k] = winv[k / 6] * v[k];
    return;
  }
  if (tid < 6) x[tid] = 0.0f;
  if (n_live < 2) return;

  constexpr int K = CHAINS;
  const int ring_floats = STAGES * chunk * 36;
  float* vec = STAGED ? scratch : smem + K * ring_floats;  // (n_live, 6)
  float* alt = STAGED ? scratch + static_cast<size_t>(F) * 6
                      : (alt_in_smem ? vec + n_live * 6 : x);
  // Where the offsets start, so that LEVELS - 1 doublings end in vec.
  float* start = ((LEVELS - 1) & 1) ? alt : vec;
  // Warp w < K marches the chain of positions w, w + K, ... of the
  // n_live - 1 live rows; the other warps march nothing.
  const int w = tid >> 5;
  // The warp's two offset slots after the rings (STAGED only).
  float* offs = smem + K * ring_floats + w * (2 * chunk * 6);
  const int total = n_live - 1;
  const size_t last = static_cast<size_t>(LEVELS - 1) * F * 72;
  March march{prep + last, smem + w * ring_floats, chunk, n_live - 1 - w, -K,
              w < K && w < total ? (total - w + K - 1) / K : 0};
  if (w < K) march.begin(tid & 31);

  // c_i = JjInv_i^T v_i.
  rows_step<true>(jj_inv, v, 0, nullptr, nullptr, start, n_live, tid);
  __syncthreads();
  // Backward sweep: s_i = c_i + A_i s_{i+1}.
  solve<STAGED>(prep, F, true, march, start, vec, alt, offs, n_live, tid);

  march.blocks += static_cast<size_t>(F) * 36;
  march.first = 1 + w;
  march.step = K;
  if (w < K) march.begin(tid & 31);
  // e_i = JjInv_i (winv_i s_i), in place when the offsets start in vec.
  rows_step<false>(jj_inv, vec, 0, nullptr, winv, start, n_live, tid);
  __syncthreads();
  // Forward sweep: x_i = e_i + A'_i x_{i-1}, then out of shared memory.
  solve<STAGED>(prep + static_cast<size_t>(F) * 36, F, false, march, start,
                vec, alt, offs, n_live, tid);
  for (int k = 6 + tid; k < n_live * 6; k += THREADS) x[k] = vec[k];
}

// How a launch for up to `rows` live rows lays out shared memory: rows
// per chunk of a warp's ring (16 or 8; 0 if `rows` does not fit),
// whether the second offsets buffer is in shared memory too, and the
// bytes. The layout only places data: every layout gives the same bits.
int shared_layout(int rows, int* alt_in_smem, size_t* bytes) {
  const size_t rings = static_cast<size_t>(STAGES) * CHAINS;
  for (int alt = 1; alt >= 0; --alt) {
    for (int chunk = 16; chunk >= 8; chunk /= 2) {
      *bytes = (rings * chunk * 36 + (1 + alt) * rows * 6) * sizeof(float);
      *alt_in_smem = alt;
      if (*bytes <= MAX_SMEM) return chunk;
    }
  }
  return 0;
}

}  // namespace

// jj_inv, ji: (F, 6, 6) float32 row-major; n_live: one int32 in device
// memory, 1 <= *n_live <= F (larger values count as F); output prep
// (LEVELS, 2, F, 6, 6): level l holds the blocks that step 2^l rows.
// LEVELS launches. Returns the first CUDA error (0: none).
extern "C" int slam_chain_prepare(const float* jj_inv, const float* ji,
                                  int F, const int* n_live, float* prep,
                                  void* stream) {
  const int total = F * 72;
  const int blocks = (total + 255) / 256;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  chain_prepare_kernel<<<blocks, 256, 0, st>>>(jj_inv, ji, F, n_live, prep);
  for (int l = 1; l < LEVELS; ++l) {
    chain_double_kernel<<<blocks, 256, 0, st>>>(
        prep + static_cast<size_t>(l - 1) * total, F, n_live, 1 << (l - 1),
        prep + static_cast<size_t>(l) * total);
  }
  return static_cast<int>(cudaGetLastError());
}

// Levels of the prepared blocks (the leading extent of prep).
extern "C" int slam_chain_levels() { return LEVELS; }

// Largest F whose offsets one launch holds in shared memory; a larger F
// needs the scratch buffer of slam_chain_sweep.
extern "C" int slam_chain_sweep_max_live() {
  const int rings = STAGES * CHAINS * 8 * 36;
  return (MAX_SMEM - rings * static_cast<int>(sizeof(float))) / 24;
}

// jj_inv (F, 6, 6), prep (LEVELS, 2, F, 6, 6) from slam_chain_prepare
// with the same jj_inv, ji and n_live; winv (F,); v (F, 6); n_live: one
// int32 in device memory, 1 <= *n_live <= F (else x is all NaN);
// scratch: (2, F, 6) floats in device memory where F >
// slam_chain_sweep_max_live(), else not read (may be null); output x
// (F, 6). Returns the first CUDA error (0: none) after the launch.
extern "C" int slam_chain_sweep(const float* jj_inv, const float* prep,
                                const float* winv, const float* v, int F,
                                const int* n_live, float* scratch, float* x,
                                void* stream) {
  int alt_in_smem = 0;
  size_t smem = 0;
  int chunk = 0;
  const bool staged = F > slam_chain_sweep_max_live();
  if (!staged) {
    chunk = shared_layout(F, &alt_in_smem, &smem);
  } else if (scratch != nullptr) {
    chunk = 16;
    smem = static_cast<size_t>(CHAINS) * (STAGES * chunk * 36 + 2 * chunk * 6) *
           sizeof(float);
  }
  if (chunk == 0) return static_cast<int>(cudaErrorInvalidValue);
  // The kernels' shared-memory limit is raised once on each device.
  constexpr int MAX_DEVICES = 64;
  static bool sized[MAX_DEVICES] = {};
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (device >= MAX_DEVICES || !sized[device]) {
    e = cudaFuncSetAttribute(chain_sweep_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             MAX_SMEM);
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(chain_sweep_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               MAX_SMEM);
    }
    if (e != cudaSuccess) return static_cast<int>(e);
    if (device < MAX_DEVICES) sized[device] = true;
  }
  const int blocks = 1 + ((F - 1) * 6 + THREADS - 1) / THREADS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (staged) {
    chain_sweep_kernel<true><<<blocks, THREADS, smem, st>>>(
        jj_inv, prep, winv, v, F, n_live, F, chunk, 0, scratch, x);
  } else {
    chain_sweep_kernel<false><<<blocks, THREADS, smem, st>>>(
        jj_inv, prep, winv, v, F, n_live, F, chunk, alt_in_smem, nullptr, x);
  }
  return static_cast<int>(cudaGetLastError());
}
