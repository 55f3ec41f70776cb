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
// every pixel paying for every row.  Here one CTA owns a 16x32 pixel tile,
// one thread per pixel (a warp is one 32-pixel row, so the float2 stores of
// a warp are 256 contiguous bytes).  The per-tile table holds triangle
// INDICES (int32, ascending, `counts[tile]` of them) into one [T,8] table
// of vertices and one of UVs, so the upload per mesh is the two small
// tables plus 4 bytes per bin slot, not 64.  The CTA stages its triangles'
// rows in shared memory in chunks of RASTER_CHUNK (the staging thread also
// computes the row's orientation sign and reciprocal area, once per tile
// and not once per pixel); then every thread walks the staged rows for its
// own pixel and stops at its first hit, and the CTA stops as soon as all
// its pixels are found (__syncthreads_and).
//
// Bound.  At the main path's shape (672 x 672, ~1,500 triangles of ~400
// px) a tile meets a few tens of triangles: ~20 float operations per pixel
// and triangle tested, 3.6 MB written.  Both the byte time and the
// operation time are of the order of a microsecond, so the kernel is
// launch- and latency-bound; the design keeps it to one launch with no
// global scratch.
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
#define RASTER_CHUNK 256

namespace {

__global__ void __launch_bounds__(RASTER_TILE_H * RASTER_TILE_W)
raster_uv_kernel(const float* __restrict__ tri,    // [T,8] ax ay bx by cx cy
                 const float* __restrict__ uvt,    // [T,8] ua va ub vb uc vc
                 const int* __restrict__ bins,     // [G,max_bin] indices
                 const int* __restrict__ counts,   // [G]
                 float* __restrict__ out,          // [H,W,2]
                 int n_tris, int max_bin, int height, int width) {
  // staged rows: ax ay bx by cx cy s inv_area / ua va ub vb uc vc
  __shared__ float s_tri[RASTER_CHUNK][8];
  __shared__ float s_uv[RASTER_CHUNK][6];

  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  const int tid = threadIdx.y * RASTER_TILE_W + threadIdx.x;
  const int x = blockIdx.x * RASTER_TILE_W + threadIdx.x;
  const int y = blockIdx.y * RASTER_TILE_H + threadIdx.y;
  const bool in_image = x < width && y < height;

  const float px = (float)x, py = (float)y;
  float u = __fdiv_rn(px, (float)width);
  float v = __fdiv_rn(py, (float)height);
  // a thread outside the image has nothing to find
  int found = in_image ? 0 : 1;

  int count = counts[tile];
  if (count > max_bin) count = max_bin;
  const int* tile_bins = bins + (size_t)tile * max_bin;
  const float eps = -1e-6f;

  for (int base = 0; base < count; base += RASTER_CHUNK) {
    const int n = min(RASTER_CHUNK, count - base);
    for (int k = tid; k < n; k += RASTER_TILE_H * RASTER_TILE_W) {
      const int t = tile_bins[base + k];
      if (t < 0 || t >= n_tris) {
        // not a triangle of the table: inv_area == 0 marks the row as one
        // to skip (a real row's is +-1 / max(|area|, 1e-12), never 0)
        s_tri[k][7] = 0.f;
        continue;
      }
      const float4 p0 = *reinterpret_cast<const float4*>(tri + 8 * (size_t)t);
      const float2 p1 =
          *reinterpret_cast<const float2*>(tri + 8 * (size_t)t + 4);
      const float ax = p0.x, ay = p0.y, bx = p0.z, by = p0.w;
      const float cx = p1.x, cy = p1.y;
      const float area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax);
      const float s = area >= 0.f ? 1.f : -1.f;
      s_tri[k][0] = ax; s_tri[k][1] = ay;
      s_tri[k][2] = bx; s_tri[k][3] = by;
      s_tri[k][4] = cx; s_tri[k][5] = cy;
      s_tri[k][6] = s;
      s_tri[k][7] = __fdiv_rn(s, fmaxf(fabsf(area), 1e-12f));
      const float4 q0 = *reinterpret_cast<const float4*>(uvt + 8 * (size_t)t);
      const float2 q1 =
          *reinterpret_cast<const float2*>(uvt + 8 * (size_t)t + 4);
      s_uv[k][0] = q0.x; s_uv[k][1] = q0.y;
      s_uv[k][2] = q0.z; s_uv[k][3] = q0.w;
      s_uv[k][4] = q1.x; s_uv[k][5] = q1.y;
    }
    __syncthreads();

    if (!found) {
      for (int k = 0; k < n; ++k) {
        const float inv_area = s_tri[k][7];
        if (inv_area == 0.f) continue;      // an out-of-range index
        const float ax = s_tri[k][0], ay = s_tri[k][1];
        const float bx = s_tri[k][2], by = s_tri[k][3];
        const float cx = s_tri[k][4], cy = s_tri[k][5];
        const float s = s_tri[k][6];
        const float w_a = ((cx - bx) * (py - by) - (cy - by) * (px - bx)) * s;
        const float w_b = ((ax - cx) * (py - cy) - (ay - cy) * (px - cx)) * s;
        const float w_c = ((bx - ax) * (py - ay) - (by - ay) * (px - ax)) * s;
        if (w_a >= eps && w_b >= eps && w_c >= eps) {
          const float alpha = w_a * inv_area;
          const float beta = w_b * inv_area;
          const float gamma = w_c * inv_area;
          u = alpha * s_uv[k][0] + beta * s_uv[k][2] + gamma * s_uv[k][4];
          v = alpha * s_uv[k][1] + beta * s_uv[k][3] + gamma * s_uv[k][5];
          found = 1;
          break;
        }
      }
    }
    // also the barrier before the next chunk overwrites the staged rows
    if (__syncthreads_and(found)) break;
  }

  if (in_image)
    *reinterpret_cast<float2*>(out + 2 * ((size_t)y * width + x)) =
        make_float2(u, v);
}

}  // namespace

extern "C" {

// tri, uvt: [n_tris, 8] float32; bins: [grid_h*grid_w, max_bin] int32;
// counts: [grid_h*grid_w] int32; out: [height, width, 2] float32; all on the
// current device, contiguous, 16-byte aligned.  grid_h x grid_w must be the
// tiling of height x width by raster_uv_tile().  Returns cudaGetLastError().
int raster_uv_launch(const void* tri, const void* uvt, const void* bins,
                     const void* counts, void* out, int n_tris, int max_bin,
                     int height, int width, int grid_h, int grid_w,
                     void* stream) {
  if (height <= 0 || width <= 0 || max_bin <= 0 || n_tris < 0 ||
      grid_h != (height + RASTER_TILE_H - 1) / RASTER_TILE_H ||
      grid_w != (width + RASTER_TILE_W - 1) / RASTER_TILE_W)
    return (int)cudaErrorInvalidValue;
  const dim3 block(RASTER_TILE_W, RASTER_TILE_H);
  const dim3 grid(grid_w, grid_h);
  raster_uv_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)tri, (const float*)uvt, (const int*)bins,
      (const int*)counts, (float*)out, n_tris, max_bin, height, width);
  return (int)cudaGetLastError();
}

// The pixel tile of one CTA, for the host binning.
void raster_uv_tile(int* tile_h, int* tile_w) {
  *tile_h = RASTER_TILE_H;
  *tile_w = RASTER_TILE_W;
}

const char* raster_uv_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
