// Masked-Laplacian conjugate gradient: the Poisson blend's solve, one launch
// per blend.  Two kernels: one image per thread-block cluster with the CG
// state in shared memory (the route of every shape a cluster can hold), and
// one cooperative launch over the whole card with the state in global
// memory (every other shape).
//
// Replaces ctrlhair_tpu/ops/poisson_pallas.py:pallas_masked_cg.  For each of
// N images it runs `iterations` steps of CG on
//     A v = lap(v * unk) * unk,   lap v = 4v - (up + down + left + right),
// over the image's [C, H, W] float32 values, neighbours outside the image
// being 0, from the start x0, with the +1e-20 guards of the reference:
//     r = (b - A x0) * unk;  p = r;  rs = r.r
//     repeat: ap = A p;  alpha = rs / (p.ap + 1e-20);  x += alpha p;
//             r -= alpha ap;  rs' = r.r;  p = r + rs' / (rs + 1e-20) p
// Each image's dot products run over all its channels and pixels.
//
// Bound.  Per iteration and element about 17 float operations (stencil 7,
// two dot products 4, three axpys 6).  At N=1, 3x256x256, 200 iterations
// that is 0.67 GFLOP: 10 us at the H100's 67 TFLOP/s float32 peak, while the
// compulsory traffic (b, unk, x0 read, x written: 4 x 786 KB) takes 1 us at
// 3.35 TB/s.  The arithmetic bounds it on paper, with all 132 SMs on one
// image.  What a solve really pays is its chain of 2 x 200 dependent
// reductions: each is a barrier, and between two barriers the SMs that hold
// the image read its state once.  So the design picks the cheapest barrier
// that still spans one image, and keeps the state where that barrier's
// blocks can read it fastest.
//
// Design of the cluster kernel.  The TPU kernel keeps one image's CG state
// in VMEM.  One block's shared memory (227 KB) cannot hold it (786 KB an
// array), a cluster's can: 16 blocks on 16 SMs of one GPC have 3.6 MB, and a
// cluster barrier is a hardware barrier, not a trip through L2 by the whole
// card.  One cluster owns one image (clusters never talk; with more images
// than resident clusters a cluster takes image after image), and block k of
// the cluster owns a band of rows of every channel:
//   - thread t owns column t % W of channel t / W and walks its rows top to
//     bottom, so the up and down neighbours of the stencil are values the
//     thread already holds, and the left and right ones come from the
//     neighbouring lanes by warp shuffle (the first and the last lane of a
//     warp read theirs from shared memory);
//   - the thread keeps the r and x of its column in registers; p, the copy
//     of r the neighbours read, ap and unk live in the block's shared
//     memory, one row of 768 thread slots after the other, so that every
//     address of the unrolled passes is the thread's index plus a constant
//     (a row stride taken from the image's width cost a register per row
//     and array, and spills);
//   - the row above and the row below the band are read from the
//     neighbouring blocks' shared memory (distributed shared memory,
//     cluster.map_shared_rank); beyond the image the value is 0;
//   - p = r + beta p_old is formed on the fly at the element and at its
//     neighbours from the r and p of the previous iteration, and written
//     back only after the first barrier (every reader has passed it), so p
//     needs one buffer and an iteration two barriers, not three:
//       phase X: ap = A p, partial sums of p.ap;   barrier; alpha;
//       phase Y: p, x += alpha p, r -= alpha ap, partial sums of r.r;
//                barrier; beta;
//   - a dot product is deterministic and free of atomics: the warps sum
//     their lanes (butterfly), the first warp sums the warps' values in
//     one order and writes the block's sum into slot [rank] of every
//     block's shared memory, and after the cluster barrier every thread
//     adds the slots in rank order.  All blocks hold bit-identical alpha
//     and beta, and two runs give bit-identical x.  The barrier that
//     publishes the sums is the iteration's barrier.
// No global scratch, no cooperative launch.  What the solve pays on one
// cluster: 2 x iterations cluster barriers, and between two of them one
// SM's pass over a sixteenth of the image; with 16 of the card's 132 SMs
// on an image it stays far above the bound, which lets all of them work.
//
// Design of the grid kernel (shapes a cluster cannot hold).  The state
// lives in global memory and stays L2-resident, every element of every
// image belongs to one thread (grid-strided), p is double-buffered, and
// each iteration takes two grid barriers; each block writes one partial per
// image into a [N, grid] buffer, and after the barrier every block sums them
// in the same fixed order.  Buffers written inside the launch are read with
// __ldcg (from L2, never a stale L1 line).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

struct Problem {
  const float* b;     // [N, M] right-hand side (zero on Dirichlet pixels)
  const float* unk;   // [N, M] 1 on unknown pixels, 0 on Dirichlet pixels
  const float* x0;    // [N, M] start
  float* x;           // [N, M] solution (output)
  float* r;           // [N, M] residual
  float* p[2];        // [N, M] search direction, double-buffered
  float* ap;          // [N, M] A p
  float* part_pap;    // [N, grid] per-block partial sums of p.ap
  float* part_rr;     // [N, grid] per-block partial sums of r.r
  int n, h, w, m;     // images, rows, columns, elements per image (C*H*W)
  int iterations;
};

__device__ __forceinline__ float warp_sum(float v) {
  // butterfly: every lane ends with the same sum, in a fixed order
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// lap(f * unk) * unk at element e of one image, f read through `field`.
template <class Field>
__device__ __forceinline__ float masked_lap(Field field, const float* unk,
                                            int e, int w, int h) {
  const int col = e % w;
  const int row = (e / w) % h;
  float y = 4.0f * (field(e) * __ldg(unk + e));
  if (row > 0) y -= field(e - w) * __ldg(unk + e - w);          // up
  if (row < h - 1) y -= field(e + w) * __ldg(unk + e + w);      // down
  if (col > 0) y -= field(e - 1) * __ldg(unk + e - 1);          // left
  if (col < w - 1) y -= field(e + 1) * __ldg(unk + e + 1);      // right
  return y * __ldg(unk + e);
}

// Reduce each thread's per-image sums (already warp-summed into red) to one
// partial per image and block, in a fixed order.
__device__ __forceinline__ void write_partials(const float* red, float* part,
                                               int n, int grid) {
  __syncthreads();
  for (int img = threadIdx.x; img < n; img += blockDim.x) {
    float s = 0.0f;
    for (int k = 0; k < kWarps; ++k) s += red[img * kWarps + k];
    part[img * grid + blockIdx.x] = s;
  }
}

// After a grid barrier: every block sums all partials of each image, in the
// same order, into tot[img].
__device__ __forceinline__ void sum_partials(const float* part, float* tot,
                                             int n, int grid) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int img = warp; img < n; img += kWarps) {
    float s = 0.0f;
    for (int k = lane; k < grid; k += 32) s += __ldcg(part + img * grid + k);
    s = warp_sum(s);
    if (lane == 0) tot[img] = s;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
masked_cg_kernel(Problem prob) {
  cg::grid_group grid_g = cg::this_grid();
  extern __shared__ float smem[];
  float* red = smem;                    // [n * kWarps]
  float* rs = red + prob.n * kWarps;    // [n] current r.r
  float* coef = rs + prob.n;            // [n] alpha, then beta
  float* tot = coef + prob.n;           // [n] summed partials

  const int grid = gridDim.x;
  const int stride = grid * kThreads;
  const int gtid = blockIdx.x * kThreads + threadIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m = prob.m, w = prob.w, h = prob.h;

  // setup: x = x0, r = (b - A x0) * unk, p_old = 0, partials of r.r
  for (int img = 0; img < prob.n; ++img) {
    const size_t base = static_cast<size_t>(img) * m;
    const float* x0 = prob.x0 + base;
    const float* unk = prob.unk + base;
    float s = 0.0f;
    for (int e = gtid; e < m; e += stride) {
      const float ax = masked_lap([&](int i) { return __ldg(x0 + i); },
                                  unk, e, w, h);
      const float re = (__ldg(prob.b + base + e) - ax) * __ldg(unk + e);
      prob.x[base + e] = __ldg(x0 + e);
      prob.r[base + e] = re;
      prob.p[0][base + e] = 0.0f;
      s += re * re;
    }
    s = warp_sum(s);
    if (lane == 0) red[img * kWarps + warp] = s;
  }
  write_partials(red, prob.part_rr, prob.n, grid);
  grid_g.sync();
  sum_partials(prob.part_rr, tot, prob.n, grid);
  for (int img = threadIdx.x; img < prob.n; img += kThreads) {
    rs[img] = tot[img];
    coef[img] = 0.0f;               // beta of the first step: p = r
  }
  __syncthreads();

  for (int it = 0; it < prob.iterations; ++it) {
    // constant indices keep the two pointers out of local memory
    const float* p_old = (it & 1) ? prob.p[1] : prob.p[0];
    float* p_new = (it & 1) ? prob.p[0] : prob.p[1];

    // phase X: p = r + beta p_old (here and at the neighbours), ap = A p
    for (int img = 0; img < prob.n; ++img) {
      const size_t base = static_cast<size_t>(img) * m;
      const float* r = prob.r + base;
      const float* po = p_old + base;
      const float beta = coef[img];
      auto p_at = [&](int i) {
        return __fmaf_rn(beta, __ldcg(po + i), __ldcg(r + i));
      };
      float s = 0.0f;
      for (int e = gtid; e < m; e += stride) {
        const float pe = p_at(e);
        const float ape = masked_lap(p_at, prob.unk + base, e, w, h);
        p_new[base + e] = pe;
        prob.ap[base + e] = ape;
        s += pe * ape;
      }
      s = warp_sum(s);
      if (lane == 0) red[img * kWarps + warp] = s;
    }
    write_partials(red, prob.part_pap, prob.n, grid);
    grid_g.sync();
    sum_partials(prob.part_pap, tot, prob.n, grid);
    for (int img = threadIdx.x; img < prob.n; img += kThreads)
      coef[img] = rs[img] / (tot[img] + 1e-20f);
    __syncthreads();

    // phase Y: x += alpha p, r -= alpha ap
    for (int img = 0; img < prob.n; ++img) {
      const size_t base = static_cast<size_t>(img) * m;
      const float alpha = coef[img];
      float s = 0.0f;
      for (int e = gtid; e < m; e += stride) {
        const size_t i = base + e;
        const float pe = __ldcg(p_new + i);
        const float re =
            __fmaf_rn(-alpha, __ldcg(prob.ap + i), __ldcg(prob.r + i));
        prob.x[i] = __fmaf_rn(alpha, pe, __ldcg(prob.x + i));
        prob.r[i] = re;
        s += re * re;
      }
      s = warp_sum(s);
      if (lane == 0) red[img * kWarps + warp] = s;
    }
    write_partials(red, prob.part_rr, prob.n, grid);
    grid_g.sync();
    sum_partials(prob.part_rr, tot, prob.n, grid);
    for (int img = threadIdx.x; img < prob.n; img += kThreads) {
      coef[img] = tot[img] / (rs[img] + 1e-20f);   // beta
      rs[img] = tot[img];
    }
    __syncthreads();
  }
}

size_t smem_bytes(int n) {
  return static_cast<size_t>(n) * (kWarps + 3) * sizeof(float);
}


// ---------------------------------------------------------------------------
// The cluster kernel.

constexpr int kClusterSize = 16;       // blocks of a cluster
constexpr int kBandRows = 16;          // the most rows a block's band may have
constexpr int kClusterThreads = 768;   // at most C*W columns, one a thread
// a band's arrays are laid out at kBandRows rows of kClusterThreads slots
constexpr int kBandElems = kBandRows * kClusterThreads;

struct ClusterProblem {
  const float* b;     // [N, C, H, W]
  const float* unk;
  const float* x0;
  float* x;           // [N, C, H, W] output
  int n, c, h, w;
  int rows;           // rows of a full band: ceil(H / cluster size)
  int working;        // blocks of the cluster that own at least one row
  int iterations;
};

// A block's dynamic shared memory.  The element of row `row` of the band
// that thread t owns (column t % W of channel t / W) lies at
// row * kClusterThreads + t, whatever the image's shape, so that every
// address of the unrolled passes is the thread's index plus a constant.  A
// band is laid out with the kBandRows rows the kernel unrolls, whatever it
// owns: the rows beyond its own hold r = p = unk = 0 and go through every
// pass as zeros, so no pass tests a row count.
struct Band {
  float r[kBandElems];     // the copy of the residual the neighbours read
  float p[kBandElems];     // the search direction of the previous iteration
  float ap[kBandElems];    // A p
  float unk[kBandElems];
  float warp_part[32];     // the reductions
  float slots_pap[kClusterSize];
  float slots_rr[kClusterSize];
};
static_assert(sizeof(Band) <= 232448, "a block's dynamic shared memory");

// Sum of `v` over every thread of the cluster, the same bits in every
// thread.  The block's warps sum through warp_part (fixed order), the
// block's sum goes to slot [rank] of every block of the cluster, the
// cluster barrier publishes it, and every thread adds the slots in rank
// order.
__device__ __forceinline__ float cluster_sum(cg::cluster_group& cluster,
                                             float* warp_part, float* slots,
                                             float v, int rank, int warps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  v = warp_sum(v);
  if (lane == 0) warp_part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const float s = warp_sum(lane < warps ? warp_part[lane] : 0.0f);
    if (lane < kClusterSize) cluster.map_shared_rank(slots, lane)[rank] = s;
  }
  cluster.sync();
  float total = 0.0f;
#pragma unroll
  for (int k = 0; k < kClusterSize; ++k) total += slots[k];
  return total;
}

// A thread keeps the r and x of its column in registers; shared memory holds
// p, the copy of r its neighbours read, ap and unk.
__global__ void __launch_bounds__(kClusterThreads, 1)
masked_cg_cluster_kernel(ClusterProblem prob) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char cluster_smem[];
  Band* band = reinterpret_cast<Band*>(cluster_smem);
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_clusters = gridDim.x / kClusterSize;
  const int cluster_id = blockIdx.x / kClusterSize;
  const int tid = threadIdx.x, lane = tid % 32, warps = blockDim.x / 32;
  const int c = prob.c, h = prob.h, w = prob.w, rows = prob.rows;
  constexpr int E = kBandRows;
  constexpr int S = kClusterThreads;        // the stride of a row

  float* s_r = band->r;
  float* s_p = band->p;
  float* s_ap = band->ap;
  float* s_u = band->unk;

  const bool has_prev = rank > 0 && rank < prob.working;
  const bool has_next = rank + 1 < prob.working;
  // a block with no neighbour on a side maps itself there and never reads it
  const Band* prev = cluster.map_shared_rank(band, has_prev ? rank - 1 : rank);
  const Band* next = cluster.map_shared_rank(band, has_next ? rank + 1 : rank);

  // This block's rows, and this thread's column.  The threads beyond the
  // last column (the tail of the last warp) own no row: their columns of
  // the band hold zeros like the rows beyond the band's own, and they go
  // through every pass with the others, so that a warp's shuffles are whole.
  const int row0 = rank * rows;
  const bool active = tid < c * w;
  const int my_rows = active ? max(0, min(rows, h - row0)) : 0;
  const int ch = active ? tid / w : 0, col = active ? tid % w : 0;
  const int base = tid;                       // row 0 of this column
  const bool has_left = active && col > 0;
  const bool has_right = active && col < w - 1;
  // left and right neighbours come from the neighbouring lanes; the first
  // and the last lane of a warp read theirs from shared memory
  const bool edge_left = has_left && lane == 0;
  const bool edge_right = has_right && lane == 31;
  const int edge_step = edge_left ? -1 : 1;
  constexpr unsigned kFull = 0xffffffffu;

  float rr[E], xr[E];

  for (int img = cluster_id; img < prob.n; img += n_clusters) {
    const size_t img_base = static_cast<size_t>(img) * c * h * w;
    const float* g_unk = prob.unk + img_base;
    const float* g_x0 = prob.x0 + img_base;
    // this thread's column of x0 and x, from the band's first row down
    const int col_off = (ch * h + row0) * w + col;
    const float* g_col0 = g_x0 + col_off;
    float* g_col = prob.x + img_base + col_off;

    // setup: x = x0, r = (b - A x0) * unk, p = 0, r.r; zeros in the rows
    // the band does not own
    float part = 0.0f;
#pragma unroll 1
    for (int lr = 0; lr < E; ++lr) {
      const int i = base + lr * S;
      float re = 0.0f, u = 0.0f;
      if (lr < my_rows) {
        const int e = (ch * h + row0 + lr) * w + col;
        const float ax = masked_lap([&](int k) { return __ldg(g_x0 + k); },
                                    g_unk, e, w, h);
        u = __ldg(g_unk + e);
        re = (__ldg(prob.b + img_base + e) - ax) * u;
      }
      s_r[i] = re;
      s_p[i] = 0.0f;
      s_u[i] = u;
      part += re * re;
    }
#pragma unroll
    for (int lr = 0; lr < E; ++lr) {
      rr[lr] = s_r[base + lr * S];
      xr[lr] = lr < my_rows ? __ldg(g_col0 + lr * w) : 0.0f;
    }
    float rs = cluster_sum(cluster, band->warp_part, band->slots_rr, part,
                           rank, warps);
    float beta = 0.0f;                      // the first step: p = r

    for (int it = 0; it < prob.iterations; ++it) {
      // phase X: p = r + beta p_old here and at the neighbours, ap = A p.
      // *_pe is p at an element, *_u is unk there, *_m is p * unk.
      part = 0.0f;
      float up_m = 0.0f, below_m = 0.0f;
      if (has_prev) {
        const int i = base + (rows - 1) * S;
        up_m = __fmaf_rn(beta, prev->p[i], prev->r[i]) * prev->unk[i];
      }
      if (has_next)
        below_m = __fmaf_rn(beta, next->p[base], next->r[base]) *
                  next->unk[base];
      float cur_pe = __fmaf_rn(beta, s_p[base], rr[0]);
      float cur_u = s_u[base];
#pragma unroll
      for (int lr = 0; lr < E; ++lr) {
        const int i = base + lr * S;
        float nxt_pe = 0.0f, nxt_u = 0.0f;
        if (lr + 1 < E) {
          nxt_pe = __fmaf_rn(beta, s_p[i + S], rr[lr + 1 < E ? lr + 1 : lr]);
          nxt_u = s_u[i + S];
        }
        // the band's last row has the next block's first row below it
        const float down_m = lr + 1 == rows ? below_m : nxt_pe * nxt_u;
        const float c_m = cur_pe * cur_u;
        float left_m = __shfl_up_sync(kFull, c_m, 1);
        float right_m = __shfl_down_sync(kFull, c_m, 1);
        if (edge_left || edge_right) {
          const int j = i + edge_step;
          const float m = __fmaf_rn(beta, s_p[j], s_r[j]) * s_u[j];
          if (edge_left) left_m = m;
          else right_m = m;
        }
        if (!has_left) left_m = 0.0f;
        if (!has_right) right_m = 0.0f;
        float y = 4.0f * c_m;
        y -= up_m;
        y -= down_m;
        y -= left_m;
        y -= right_m;
        const float ape = y * cur_u;
        s_ap[i] = ape;
        part += cur_pe * ape;
        up_m = c_m;
        cur_pe = nxt_pe;
        cur_u = nxt_u;
      }
      const float pap = cluster_sum(cluster, band->warp_part, band->slots_pap,
                                    part, rank, warps);
      const float alpha = rs / (pap + 1e-20f);

      // phase Y: every reader of the old p and r has passed the barrier
      part = 0.0f;
#pragma unroll
      for (int lr = 0; lr < E; ++lr) {
        const int i = base + lr * S;
        const float pe = __fmaf_rn(beta, s_p[i], rr[lr]);
        const float re = __fmaf_rn(-alpha, s_ap[i], rr[lr]);
        rr[lr] = re;
        xr[lr] = __fmaf_rn(alpha, pe, xr[lr]);
        s_p[i] = pe;
        s_r[i] = re;
        part += re * re;
      }
      const float rr_sum = cluster_sum(cluster, band->warp_part,
                                       band->slots_rr, part, rank, warps);
      beta = rr_sum / (rs + 1e-20f);
      rs = rr_sum;
    }

#pragma unroll
    for (int lr = 0; lr < E; ++lr)
      if (lr < my_rows) g_col[lr * w] = xr[lr];
    // no block may start the next image's set-up (or leave) while another
    // still reads this image's slots or its rows
    cluster.sync();
  }
}

// `count` cluster barriers and nothing else: the yardstick of the solve's
// dependency chain.
__global__ void __launch_bounds__(kClusterThreads)
cluster_barrier_probe(int count, int* sink) {
  cg::cluster_group cluster = cg::this_cluster();
  for (int k = 0; k < count; ++k) cluster.sync();
  if (sink != nullptr && threadIdx.x == 0 && blockIdx.x == 0) *sink = count;
}

// One launch of `clusters` clusters of kClusterSize blocks.
cudaError_t launch_clusters(const void* kernel, int clusters, int threads,
                            size_t smem, void* stream, void** args) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kClusterSize;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(clusters * kClusterSize);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = smem;
  config.stream = static_cast<cudaStream_t>(stream);
  config.attrs = &attr;
  config.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelExC(&config, kernel, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest co-resident grid for N images on the current device.
cudaError_t masked_cg_grid(int n, int* grid) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, masked_cg_kernel, kThreads, smem_bytes(n));
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  *grid = per_sm * sms;
  return cudaSuccess;
}

// work: 4 * n * m + 2 * n * grid floats (r, p[2], ap, two partial buffers).
cudaError_t masked_cg_launch(const float* b, const float* unk,
                             const float* x0, float* x, float* work, int n,
                             int c, int h, int w, int iterations, int grid,
                             void* stream) {
  Problem prob;
  const size_t nm = static_cast<size_t>(n) * c * h * w;
  prob.b = b;
  prob.unk = unk;
  prob.x0 = x0;
  prob.x = x;
  prob.r = work;
  prob.p[0] = work + nm;
  prob.p[1] = work + 2 * nm;
  prob.ap = work + 3 * nm;
  prob.part_pap = work + 4 * nm;
  prob.part_rr = prob.part_pap + static_cast<size_t>(n) * grid;
  prob.n = n;
  prob.h = h;
  prob.w = w;
  prob.m = c * h * w;
  prob.iterations = iterations;
  void* args[] = {&prob};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(masked_cg_kernel), dim3(grid), dim3(kThreads),
      args, smem_bytes(n), static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The cluster route.  ops/poisson_pallas.cluster_plan is the one statement
// of how an image is split over a cluster; these constants are what it is
// held against when the library is loaded.
void masked_cg_cluster_layout(int* cluster_size, int* band_rows, int* threads,
                              int* smem) {
  *cluster_size = kClusterSize;
  *band_rows = kBandRows;
  *threads = kClusterThreads;
  *smem = static_cast<int>(sizeof(Band));
}

// Prepare the current device for the cluster kernel (its shared memory, its
// cluster size) and ask how many clusters of blocks of `threads` threads it
// runs at once.  Called once per device, before its first launch.
cudaError_t masked_cg_cluster_active(int threads, int* active) {
  const void* kernel =
      reinterpret_cast<const void*>(masked_cg_cluster_kernel);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(Band)));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  // the grid a query is asked about: one cluster on every SM it could take
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kClusterSize;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(sms / kClusterSize * kClusterSize);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = sizeof(Band);
  config.attrs = &attr;
  config.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(active, kernel, &config);
}

// `rows`, `working` and `threads` are cluster_plan's for [c, h, w].
cudaError_t masked_cg_cluster_launch(const float* b, const float* unk,
                                     const float* x0, float* x, int n, int c,
                                     int h, int w, int iterations,
                                     int clusters, int rows, int working,
                                     int threads, void* stream) {
  if (rows < 1 || rows > kBandRows || working < 1 || working > kClusterSize ||
      c * w > threads || threads > kClusterThreads || clusters < 1 || n < 1)
    return cudaErrorInvalidValue;
  ClusterProblem prob;
  prob.b = b;
  prob.unk = unk;
  prob.x0 = x0;
  prob.x = x;
  prob.n = n;
  prob.c = c;
  prob.h = h;
  prob.w = w;
  prob.rows = rows;
  prob.working = working;
  prob.iterations = iterations;
  void* args[] = {&prob};
  return launch_clusters(
      reinterpret_cast<const void*>(masked_cg_cluster_kernel), clusters,
      threads, sizeof(Band), stream, args);
}

// One cluster of blocks of `threads` threads passing `count` cluster
// barriers: what the solve's chain of reductions costs at least.
cudaError_t masked_cg_barrier_probe(int threads, int count, void* stream) {
  if (threads < 32 || threads > kClusterThreads)
    return cudaErrorInvalidValue;
  const void* kernel = reinterpret_cast<const void*>(cluster_barrier_probe);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  int* sink = nullptr;
  void* args[] = {&count, &sink};
  return launch_clusters(kernel, 1, threads, 0, stream, args);
}

const char* masked_cg_error_string(cudaError_t err) {
  return cudaGetErrorString(err);
}

}  // extern "C"
