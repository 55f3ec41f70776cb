// Triangle-mesh UV rasterizer + warp compositor on the host.
//
// The port's own copy of ctrlhair_tpu/native/raster.cpp: the `raster='host'`
// route of ops/warp.hair_mask_transfer_warp.  One bbox scan per triangle
// over the padded image, in double precision, fused with the bilinear
// sample and the naive_transfer composite.  The reference rasterizes on
// the host too (Cython mesh_core,
// ref: external_code/my_cython/mesh_core.cpp:150-215 + cv2.remap
// sampling, step_4/get_pixelValue.py:24-51); this is an independent
// implementation fused with the composite
// (ref: wrap_codes/mask_adaptor.py:63-73).
//
// Semantics mirror ops/warp.rasterize_uv + _rasterize_composite:
//   * first-hit in triangle order, orientation-normalised edge functions,
//     eps = -1e-6 inclusive boundaries;
//   * uncovered pixels keep the identity UV;
//   * bilinear sample of the padded mask, out-of-bounds -> 0;
//   * threshold >= 1 - 1e-6 (the reference's uint8 truncation);
//   * composite: old hair -> 255, warped hair -> HAIR_IDX;
//   * optional strided decimation to out_size (cv2.INTER_NEAREST grid).

#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

// verts: [V,2] doubles (pixel coords in the padded domain, size big x big)
// tris:  [T,3] int32 (rows with any index < 0 are padding and skipped)
// uv:    [V,2] doubles (normalised source coords)
// total: [big,big] float32 padded+smeared hair mask
// face:  [size,size] int32 target parsing (size = big - 2*pad)
// out:   [out_n,out_n] int32 composite parsing.  out_n is chosen by the
//        caller (ctrlhair_tpu_torch/native/__init__.py) and must decimate size
//        evenly; out_n <= 0 means "no decimation" (out_n = size).
int rasterize_warp_composite(
    const double* verts, int n_verts,
    const int* tris, int n_tris,
    const double* uv,
    const float* total, int big,
    const int* face, int size,
    int pad, int hair_idx, int unknown_label, int out_n,
    int* out) {
  if (big <= 0 || size <= 0 || big != size + 2 * pad) return 1;

  // UV map, identity-initialised; claimed[] enforces first-hit semantics.
  std::vector<double> uvx(static_cast<size_t>(big) * big);
  std::vector<double> uvy(static_cast<size_t>(big) * big);
  std::vector<uint8_t> claimed(static_cast<size_t>(big) * big, 0);
  for (int y = 0; y < big; ++y)
    for (int x = 0; x < big; ++x) {
      uvx[(size_t)y * big + x] = (double)x / big;
      uvy[(size_t)y * big + x] = (double)y / big;
    }

  const double eps = -1e-6;
  for (int t = 0; t < n_tris; ++t) {
    int i0 = tris[3 * t], i1 = tris[3 * t + 1], i2 = tris[3 * t + 2];
    if (i0 < 0 || i1 < 0 || i2 < 0) continue;
    if (i0 >= n_verts || i1 >= n_verts || i2 >= n_verts) return 2;
    const double ax = verts[2 * i0], ay = verts[2 * i0 + 1];
    const double bx = verts[2 * i1], by = verts[2 * i1 + 1];
    const double cx = verts[2 * i2], cy = verts[2 * i2 + 1];
    double area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax);
    double s = area >= 0 ? 1.0 : -1.0;
    double abs_area = std::fabs(area);
    if (abs_area < 1e-12) abs_area = 1e-12;
    const double inv_area = s / abs_area;

    int x0 = (int)std::floor(std::fmin(ax, std::fmin(bx, cx)));
    int x1 = (int)std::ceil(std::fmax(ax, std::fmax(bx, cx)));
    int y0 = (int)std::floor(std::fmin(ay, std::fmin(by, cy)));
    int y1 = (int)std::ceil(std::fmax(ay, std::fmax(by, cy)));
    if (x0 < 0) x0 = 0;
    if (y0 < 0) y0 = 0;
    if (x1 >= big) x1 = big - 1;
    if (y1 >= big) y1 = big - 1;

    const double u0 = uv[2 * i0], v0 = uv[2 * i0 + 1];
    const double u1 = uv[2 * i1], v1 = uv[2 * i1 + 1];
    const double u2 = uv[2 * i2], v2 = uv[2 * i2 + 1];

    for (int y = y0; y <= y1; ++y) {
      const double py = (double)y;
      for (int x = x0; x <= x1; ++x) {
        const size_t k = (size_t)y * big + x;
        if (claimed[k]) continue;
        const double px = (double)x;
        // edge functions, orientation-normalised (matches warp.py)
        const double wa = ((cx - bx) * (py - by)
                           - (cy - by) * (px - bx)) * s;
        if (wa < eps) continue;
        const double wb = ((ax - cx) * (py - cy)
                           - (ay - cy) * (px - cx)) * s;
        if (wb < eps) continue;
        const double wc = ((bx - ax) * (py - ay)
                           - (by - ay) * (px - ax)) * s;
        if (wc < eps) continue;
        const double alpha = wa * inv_area, beta = wb * inv_area,
                     gamma = wc * inv_area;
        uvx[k] = alpha * u0 + beta * u1 + gamma * u2;
        uvy[k] = alpha * v0 + beta * v1 + gamma * v2;
        claimed[k] = 1;
      }
    }
  }

  // bilinear-sample the mask at uv*big, threshold, crop, composite.
  if (out_n <= 0) out_n = size;
  if (out_n > size || size % out_n != 0) return 2;
  const int stride = size / out_n;
  for (int oy = 0; oy < out_n; ++oy) {
    const int yy = oy * stride;           // coords in the cropped domain
    const int y = yy + pad;               // coords in the padded domain
    for (int ox = 0; ox < out_n; ++ox) {
      const int xx = ox * stride;
      const int x = xx + pad;
      const size_t k = (size_t)y * big + x;
      const double sx = uvx[k] * big, sy = uvy[k] * big;
      double val = 0.0;
      if (sx >= 0.0 && sx <= big - 1 && sy >= 0.0 && sy <= big - 1) {
        int fx = (int)std::floor(sx), fy = (int)std::floor(sy);
        if (fx > big - 1) fx = big - 1;
        if (fy > big - 1) fy = big - 1;
        const int fx1 = fx + 1 > big - 1 ? big - 1 : fx + 1;
        const int fy1 = fy + 1 > big - 1 ? big - 1 : fy + 1;
        double dx = sx - fx, dy = sy - fy;
        if (dx < 0) dx = 0; if (dx > 1) dx = 1;
        if (dy < 0) dy = 0; if (dy > 1) dy = 1;
        const double v00 = total[(size_t)fy * big + fx];
        const double v01 = total[(size_t)fy * big + fx1];
        const double v10 = total[(size_t)fy1 * big + fx];
        const double v11 = total[(size_t)fy1 * big + fx1];
        val = v00 * (1 - dx) * (1 - dy) + v01 * dx * (1 - dy)
              + v10 * (1 - dx) * dy + v11 * dx * dy;
      }
      const int f = face[(size_t)yy * size + xx];
      int o = (f == hair_idx) ? unknown_label : f;
      if (val >= 1.0 - 1e-6) o = hair_idx;
      out[(size_t)oy * out_n + ox] = o;
    }
  }
  return 0;
}

}  // extern "C"
