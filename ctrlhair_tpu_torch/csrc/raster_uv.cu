// raster_uv.cu — tiled UV rasteriser of the deformed warp mesh (kernel K2).
//
// Replaces the TPU kernel ctrlhair_tpu/ops/raster_pallas.py:_kernel (launched
// by _rasterize_binned).  Same function: for every pixel of an H x W image,
// walk the triangles binned to the pixel's tile in ascending triangle index;
// the first triangle whose three orientation-normalised edge functions are
// all >= -1e-6 wins and the pixel takes its barycentric UV; a pixel no
// triangle covers keeps the identity UV (px/W, py/H).
//
// What differs from the TPU kernel, and why.  There one grid step owns a
// 16x128 VMEM tile and walks a dense [max_bin, 8] table with a pad flag,
// every pixel paying for every row.  Here one block of 128 threads owns a
// 16x32 pixel tile, four pixels a thread (rows ty, ty + 4, ty + 8, ty + 12
// of the tile; a warp is one 32-pixel row, so the float2 stores of a warp
// are 256 contiguous bytes).  A thread's pixels share their column, so the
// x terms of a triangle's three edge functions are computed once for the
// four of them, and the four tests are independent work for the pipeline.
// With 128 threads of at most 64 registers the card holds 8 blocks an SM,
// 1,056 at once on 132 SMs: the 882 tiles of a 672 x 672 map are one wave.
// The bins are packed: `offsets` [G+1] gives a tile the start and the count
// of its triangle INDICES (int32, ascending) in one array of all tiles'
// indices, read in one hop.  An index names one 64-byte row of `rows`
// [T,16]:
//     ax ay bx by | cx cy s inv_area | ua va ub vb | uc vc 0 0
// with the orientation sign s and the reciprocal area computed once per
// mesh by the host, in float32 with the plain version's operations.  The
// block stages its triangles' rows in shared memory in chunks of
// RASTER_CHUNK, every thread copying float4s (four threads a row); then
// every thread walks the staged rows for its own pixels, each pixel
// stopping at its first hit, and the block stops as soon as all its pixels
// are found (__syncthreads_and).
//
// Bound.  At the main path's shape (672 x 672, ~1,300 triangles) a tile
// meets a few tens of triangles: ~20 float operations per pixel and
// triangle tested, 3.6 MB written.  Both the byte time and the operation
// time are of the order of a microsecond, below what any launch takes, so
// the kernel is launch- and latency-bound; the design keeps it to one
// launch of one wave with no global scratch and a chain of three loads
// (offsets, index, row) paid once per block.
//
// Arithmetic.  The formulas are those of the TPU kernel and of the plain
// version ops/warp.rasterize_uv, term for term, in float32.  This file must
// be compiled with -fmad=false: a fused multiply-add in an edge function
// rounds once where the plain version rounds twice, which can flip the
// `>= -1e-6` test for a pixel on a shared edge and hand it to the
// neighbouring triangle.  Divisions are IEEE (__fdiv_rn), so the identity
// UV equals the plain version's px / W bit for bit.
//
// Plain C interface for ctypes; launches on the given stream, allocates
// nothing, does not synchronise.

#include <cuda_runtime.h>

#define RASTER_TILE_H 16
#define RASTER_TILE_W 32
#define RASTER_PPT 4            // pixels a thread: rows ty + 4 j of the tile
#define RASTER_THREADS_Y (RASTER_TILE_H / RASTER_PPT)
#define RASTER_THREADS (RASTER_THREADS_Y * RASTER_TILE_W)
#define RASTER_BLOCKS_PER_SM 8
#define RASTER_CHUNK 128

namespace {

__global__ void __launch_bounds__(RASTER_THREADS, RASTER_BLOCKS_PER_SM)
raster_uv_kernel(const float4* __restrict__ rows,    // [T,4] float4
                 const int* __restrict__ offsets,    // [G+1]
                 const int* __restrict__ indices,    // [offsets[G]]
                 float* __restrict__ out,            // [H,W,2]
                 int n_tris, int n_indices, int height, int width) {
  __shared__ float4 s_rows[RASTER_CHUNK][4];

  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  const int tid = threadIdx.y * RASTER_TILE_W + threadIdx.x;
  const int x = blockIdx.x * RASTER_TILE_W + threadIdx.x;
  const int y0 = blockIdx.y * RASTER_TILE_H + threadIdx.y;

  // the tile's start and count, in one hop
  const int start = offsets[tile];
  const int count = min(offsets[tile + 1], n_indices) - start;

  const float px = (float)x;
  const float u_id = __fdiv_rn(px, (float)width);
  float py[RASTER_PPT], u[RASTER_PPT], v[RASTER_PPT];
  // bit j: pixel j lies in the image and has not been found yet
  unsigned todo = 0;
#pragma unroll
  for (int j = 0; j < RASTER_PPT; ++j) {
    const int y = y0 + j * RASTER_THREADS_Y;
    py[j] = (float)y;
    u[j] = u_id;
    v[j] = __fdiv_rn(py[j], (float)height);
    if (x < width && y < height) todo |= 1u << j;
  }
  const unsigned in_image = todo;
  const float eps = -1e-6f;
  const float qnan = __int_as_float(0x7fc00000);

  for (int base = 0; base < count; base += RASTER_CHUNK) {
    const int n = min(RASTER_CHUNK, count - base);
    for (int k = tid; k < 4 * n; k += RASTER_THREADS) {
      const int t = indices[start + base + k / 4];
      // not a triangle of the table: a row of NaNs, which no pixel's
      // inside test passes
      s_rows[k / 4][k % 4] = (t >= 0 && t < n_tris)
                                 ? rows[4 * (size_t)t + k % 4]
                                 : make_float4(qnan, qnan, qnan, qnan);
    }
    __syncthreads();

    for (int k = 0; k < n && todo != 0; ++k) {
      const float4 q1 = s_rows[k][1];
      const float cx = q1.x, cy = q1.y, s = q1.z, inv_area = q1.w;
      const float4 q0 = s_rows[k][0];
      const float ax = q0.x, ay = q0.y, bx = q0.z, by = q0.w;
      // w_a = ((cx - bx) * (py - by) - (cy - by) * (px - bx)) * s and its
      // two likes: the factors without py are the same for all the
      // thread's pixels
      const float ea = cx - bx, fa = (cy - by) * (px - bx);
      const float eb = ax - cx, fb = (ay - cy) * (px - cx);
      const float ec = bx - ax, fc = (by - ay) * (px - ax);
      float w_a[RASTER_PPT], w_b[RASTER_PPT], w_c[RASTER_PPT];
      unsigned hits = 0;
#pragma unroll
      for (int j = 0; j < RASTER_PPT; ++j) {
        w_a[j] = (ea * (py[j] - by) - fa) * s;
        w_b[j] = (eb * (py[j] - cy) - fb) * s;
        w_c[j] = (ec * (py[j] - ay) - fc) * s;
        if (w_a[j] >= eps && w_b[j] >= eps && w_c[j] >= eps) hits |= 1u << j;
      }
      hits &= todo;
      if (hits != 0) {
        const float4 q2 = s_rows[k][2], q3 = s_rows[k][3];
#pragma unroll
        for (int j = 0; j < RASTER_PPT; ++j) {
          if (hits >> j & 1u) {
            const float alpha = w_a[j] * inv_area;
            const float beta = w_b[j] * inv_area;
            const float gamma = w_c[j] * inv_area;
            u[j] = alpha * q2.x + beta * q2.z + gamma * q3.x;
            v[j] = alpha * q2.y + beta * q2.w + gamma * q3.y;
          }
        }
        todo &= ~hits;
      }
    }
    // also the barrier before the next chunk overwrites the staged rows
    if (__syncthreads_and(todo == 0)) break;
  }

#pragma unroll
  for (int j = 0; j < RASTER_PPT; ++j) {
    if (in_image >> j & 1u) {
      const size_t y = y0 + j * RASTER_THREADS_Y;
      *reinterpret_cast<float2*>(out + 2 * (y * width + x)) =
          make_float2(u[j], v[j]);
    }
  }
}

__global__ void empty_kernel() {}

}  // namespace

extern "C" {

// rows: [n_tris, 16] float32; offsets: [grid_h*grid_w + 1] int32; indices:
// [n_indices] int32; out: [height, width, 2] float32; all on the current
// device, contiguous, rows 16-byte aligned.  grid_h x grid_w must be the
// tiling of height x width by raster_uv_tile().  Returns cudaGetLastError().
int raster_uv_launch(const void* rows, const void* offsets,
                     const void* indices, void* out, int n_tris,
                     int n_indices, int height, int width, int grid_h,
                     int grid_w, void* stream) {
  if (height <= 0 || width <= 0 || n_tris < 0 || n_indices < 0 ||
      grid_h != (height + RASTER_TILE_H - 1) / RASTER_TILE_H ||
      grid_w != (width + RASTER_TILE_W - 1) / RASTER_TILE_W)
    return (int)cudaErrorInvalidValue;
  const dim3 block(RASTER_TILE_W, RASTER_THREADS_Y);
  const dim3 grid(grid_w, grid_h);
  raster_uv_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float4*)rows, (const int*)offsets, (const int*)indices,
      (float*)out, n_tris, n_indices, height, width);
  return (int)cudaGetLastError();
}

// The pixel tile of one block, for the host binning.
void raster_uv_tile(int* tile_h, int* tile_w) {
  *tile_h = RASTER_TILE_H;
  *tile_w = RASTER_TILE_W;
}

// Blocks of the kernel the current device holds at once.
int raster_uv_resident_blocks(int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, raster_uv_kernel, RASTER_THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  *blocks = per_sm * sms;
  return (int)cudaSuccess;
}

// An empty kernel: what any launch takes on this card, the yardstick of a
// kernel whose bound lies below it.
int raster_uv_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

const char* raster_uv_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
