// Masked-Laplacian conjugate gradient: the Poisson blend's solve, in one
// cooperative launch.
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
// 3.35 TB/s.  The arithmetic bounds it on paper; what the solve really pays
// is its 2 x 200 grid-wide reductions, each a barrier across the card.
//
// Design.  The TPU kernel keeps one image's CG state in VMEM.  One image's
// state is 5 x 786 KB here, far beyond a block's 227 KB of shared memory,
// but well inside the 50 MB L2.  So the whole solve is ONE persistent
// cooperative launch: every element of every image belongs to one thread
// (grid-strided), the state lives in global memory and stays L2-resident,
// and each iteration takes exactly two grid barriers:
//   phase X: p = r + beta p_old is formed on the fly at the element AND at
//            its four neighbours (p double-buffered, so no block reads a p
//            another block is writing), ap = A p, partial sums of p.ap;
//   barrier; alpha from the partials;
//   phase Y: x += alpha p, r -= alpha ap, partial sums of r.r;
//   barrier; beta from the partials.
// Each block writes one partial per image into a [N, grid] buffer, and
// after the barrier EVERY block sums those partials in the same fixed order,
// so all blocks hold bit-identical alpha and beta, the result repeats from
// run to run, and no atomics are used.  Buffers written inside the launch
// are read with __ldcg (from L2, never a stale L1 line).
// Shared-memory tiling, clusters with distributed shared memory, and fewer
// barriers are later work.

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

const char* masked_cg_error_string(cudaError_t err) {
  return cudaGetErrorString(err);
}

}  // extern "C"
