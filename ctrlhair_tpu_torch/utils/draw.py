# Filled polygons and ellipses and the 3x3 Gaussian blur on uint8 images,
# as OpenCV draws them, without OpenCV.
#
# The landmark net's synthetic faces (data/landmark_dataset.py) are painted
# with cv2.fillPoly, cv2.ellipse(thickness=-1) and cv2.GaussianBlur in the
# JAX package; the port imports no cv2, so these are reproduced here in
# numpy from OpenCV's drawing code (imgproc/drawing.cpp), integer for
# integer:
#   fill_poly     cv2.fillPoly(img, [pts], color) at shift 0, LINE_8: every
#                 edge drawn as an 8-connected Bresenham line (clipped as
#                 clipLine clips it, left to right), then the even-odd scan
#                 fill of CollectPolyEdges' edge table in 16.16 fixed point:
#                 an edge (x0,y0)-(x1,y1), y0 < y1, covers rows y0..y1-1 at
#                 x = x0 + (y-y0) dx, dx = (x1-x0)*65536 / (y1-y0) truncated
#                 toward zero; an edge that leaves the image takes x0 and dx
#                 from its clipped segment, extrapolated back to row y0; a
#                 row fills from ceil(left) to floor(right) between sorted
#                 pairs of crossings;
#   fill_ellipse  cv2.ellipse(img, center, axes, angle, 0, 360, color, -1)
#                 at shift 0: the outline of ellipse2Poly (OpenCV's table of
#                 sines to 7 places, in float32; one vertex every 5, 18, 30
#                 or 90 degrees by the larger axis) in 16.16 fixed point, its
#                 edges drawn by Line2 and the inside by FillConvexPoly;
#   blur3         cv2.GaussianBlur(img, (3, 3), 0) on uint8: the kernel
#                 [1,2,1]/4 per axis, exact in OpenCV's fixed point, the sum
#                 rounded half up, borders BORDER_REFLECT_101.
# Measured against OpenCV 5.0 on random shapes (tests/
# test_torch_landmark_trainer.py): the ellipse and the blur equal it
# exactly; a polygon equals it wherever it stays inside the image, and for
# about 1 in 75 random polygons that cross the border OpenCV also paints a
# run of pixels of the border column that the polygon does not cover, which
# this fill leaves as they were.
# Colours are given as floats and rounded half to even and saturated, as
# OpenCV's scalar conversion does.  Each function paints `img` in place.

from __future__ import annotations

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


def _color(color, channels: int) -> np.ndarray:
    c = np.clip(np.rint(np.asarray(color, np.float64)), 0, 255)
    c = np.broadcast_to(c, (max(channels, len(np.atleast_1d(c))),))
    return c[:channels].astype(np.uint8)


def _put(img: np.ndarray, ys: np.ndarray, xs: np.ndarray,
         color: np.ndarray) -> None:
    keep = (xs >= 0) & (xs < img.shape[1]) & (ys >= 0) & (ys < img.shape[0])
    img[ys[keep], xs[keep]] = color


def _trunc_div(a, b):
    """C integer division (toward zero) of int64 arrays or ints."""
    q = np.abs(a) // np.abs(b)
    return np.where((np.asarray(a) < 0) != (np.asarray(b) < 0), -q, q)


def clip_line(w: int, h: int, p1, p2, partial: bool = False):
    """OpenCV's clipLine on a w x h image: the endpoints moved onto its
    border, or None when the line misses it (with `partial`, the endpoints
    as clipLine leaves them then too)."""
    x1, y1 = int(p1[0]), int(p1[1])
    x2, y2 = int(p2[0]), int(p2[1])
    right, bottom = w - 1, h - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    if (c1 | c2) and not partial:
        return None
    return (x1, y1), (x2, y2)


def line_pixels(w: int, h: int, p1, p2):
    """(ys, xs) of the 8-connected line p1-p2 that cv2.line draws
    (LineIterator, left to right), clipped to a w x h image."""
    empty = (np.zeros(0, np.int64), np.zeros(0, np.int64))
    if not (0 <= p1[0] < w and 0 <= p2[0] < w and 0 <= p1[1] < h
            and 0 <= p2[1] < h):
        clipped = clip_line(w, h, p1, p2)
        if clipped is None:
            return empty
        p1, p2 = clipped
    (x1, y1), (x2, y2) = p1, p2
    dx, dy = x2 - x1, y2 - y1
    if dx < 0:                      # left to right
        x1, y1, x2, y2 = x2, y2, x1, y1
        dx, dy = -dx, -dy
    sy = 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    major, minor = (dy, dx) if vert else (dx, dy)
    k = np.arange(major + 1, dtype=np.int64)
    if major == 0:
        steps = np.zeros(1, np.int64)
    else:
        # Bresenham's error term keeps the minor offset after k steps at the
        # one integer m with 2*major*m in [2*minor*k - major,
        # 2*minor*k + major)
        steps = -((major - 2 * minor * k) // (2 * major))
    if vert:
        return y1 + sy * k, x1 + steps
    return y1 + sy * steps, x1 + k


def _poly_edges(w: int, h: int, v: np.ndarray):
    """The edge table of CollectPolyEdges: (y0, y1, x at y0, dx) int64
    arrays of the edges that are not horizontal.  An edge that leaves the
    image takes its x and slope from its clipped segment (clipLine's),
    extrapolated back to its own first row."""
    y0s, y1s, xs, dxs = [], [], [], []
    for (xa, ya), (xb, yb) in zip(np.roll(v, 1, axis=0), v):
        xa, ya, xb, yb = int(xa), int(ya), int(xb), int(yb)
        c0, c1 = (xa << XY_SHIFT, ya), (xb << XY_SHIFT, yb)
        if not (0 <= xa < w and 0 <= xb < w and 0 <= ya < h
                and 0 <= yb < h):
            clipped = clip_line(w, h, (xa, ya), (xb, yb), partial=True)
            (ta, tya), (tb, tyb) = clipped
            if tya != tyb:
                c0, c1 = (ta << XY_SHIFT, tya), (tb << XY_SHIFT, tyb)
        if ya == yb:
            continue
        dx = int(_trunc_div(c1[0] - c0[0], c1[1] - c0[1]))
        if ya < yb:
            y0s.append(ya), y1s.append(yb)
            xs.append(c0[0] + (ya - c0[1]) * dx)
        else:
            y0s.append(yb), y1s.append(ya)
            xs.append(c1[0] + (yb - c1[1]) * dx)
        dxs.append(dx)
    return tuple(np.asarray(a, np.int64) for a in (y0s, y1s, xs, dxs))


def fill_poly(img: np.ndarray, pts, color) -> None:
    """cv2.fillPoly(img, [pts], color): pts [K,2] int (x, y), shift 0,
    LINE_8."""
    h, w = img.shape[:2]
    col = _color(color, img.shape[2] if img.ndim == 3 else 1)
    v = np.asarray(pts, np.int64).reshape(-1, 2)
    for (xa, ya), (xb, yb) in zip(np.roll(v, 1, axis=0), v):
        ys, xs = line_pixels(w, h, (xa, ya), (xb, yb))
        _put(img, ys, xs, col)
    ey0, ey1, ex, edx = _poly_edges(w, h, v)
    if len(ey0) < 2:
        return
    x_end = ex + (ey1 - ey0) * edx
    if ey1.max() < 0 or ey0.min() >= h or max(ex.max(), x_end.max()) < 0 \
            or min(ex.min(), x_end.min()) >= (w << XY_SHIFT):
        return
    rows = np.arange(max(int(ey0.min()), 0), min(int(ey1.max()), h))
    if len(rows) == 0:
        return
    r = rows[:, None]
    big = np.iinfo(np.int64).max
    active = (ey0[None] <= r) & (r < ey1[None])               # [R,E]
    xs = np.sort(np.where(active, ex[None] + (r - ey0[None]) * edx[None],
                          big), axis=1)
    m = xs.shape[1] // 2
    left, right = xs[:, 0:2 * m:2], xs[:, 1:2 * m:2]
    ok = right != big
    rr = np.broadcast_to(r, left.shape)[ok]
    xa = (left[ok] + XY_ONE - 1) >> XY_SHIFT          # the first pixel in
    xb = right[ok] >> XY_SHIFT
    vis = (xa < w) & (xb >= 0)
    rr, xa, xb = rr[vis], np.maximum(xa[vis], 0), np.minimum(xb[vis], w - 1)
    if len(rr) == 0:
        return
    span = np.zeros((h, w + 1), np.int32)
    np.add.at(span, (rr, xa), 1)
    np.add.at(span, (rr, xb + 1), -1)
    img[np.cumsum(span[:, :w], axis=1) > 0] = col


# OpenCV's table of sines at whole degrees, 0..450, to 7 places in float32
SIN_TABLE = np.round(np.sin(np.deg2rad(np.arange(451))), 7).astype(np.float32)


def _cv_round(x: float) -> int:
    """cvRound: to the nearest integer, half to even."""
    return int(np.rint(x))


def ellipse_poly(center, axes, angle: int, delta: int):
    """ellipse2Poly of a whole ellipse on doubles: [(x, y)] float."""
    while angle < 0:
        angle += 360
    while angle > 360:
        angle -= 360
    alpha = float(SIN_TABLE[450 - angle])          # cos
    beta = float(SIN_TABLE[angle])                 # sin
    pts = []
    for i in range(0, 360 + delta, delta):
        a = min(i, 360)
        x = axes[0] * float(SIN_TABLE[450 - a])
        y = axes[1] * float(SIN_TABLE[a])
        pts.append((center[0] + x * alpha - y * beta,
                    center[1] + x * beta + y * alpha))
    if len(pts) == 1:
        pts = [tuple(center)] * 2
    return pts


def _line2(img: np.ndarray, p1, p2, color) -> None:
    """OpenCV's Line2: an 8-connected line between 16.16 fixed-point
    points."""
    h, w = img.shape[:2]
    clipped = clip_line(w << XY_SHIFT, h << XY_SHIFT, p1, p2)
    if clipped is None:
        return
    (x1, y1), (x2, y2) = clipped
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            dy = -dy
            x1, y1, x2, y2 = x2, y2, x1, y1
        y_step = int(_trunc_div(dy << XY_SHIFT, ax | 1))
        ecount = (x2 - x1) >> XY_SHIFT
    else:
        if dy < 0:
            dx = -dx
            x1, y1, x2, y2 = x2, y2, x1, y1
        x_step = int(_trunc_div(dx << XY_SHIFT, ay | 1))
        ecount = (y2 - y1) >> XY_SHIFT
    x1 += XY_ONE >> 1
    y1 += XY_ONE >> 1
    ys = [(y2 + (XY_ONE >> 1)) >> XY_SHIFT]
    xs = [(x2 + (XY_ONE >> 1)) >> XY_SHIFT]
    k = np.arange(max(ecount + 1, 0), dtype=np.int64)
    if ax > ay:
        xs.extend((x1 >> XY_SHIFT) + k)
        ys.extend((y1 + k * y_step) >> XY_SHIFT)
    else:
        ys.extend((y1 >> XY_SHIFT) + k)
        xs.extend((x1 + k * x_step) >> XY_SHIFT)
    _put(img, np.asarray(ys, np.int64), np.asarray(xs, np.int64), color)


def _fill_convex(img: np.ndarray, v, color) -> None:
    """OpenCV's FillConvexPoly for 16.16 fixed-point vertices, LINE_8."""
    h, w = img.shape[:2]
    npts = len(v)
    delta = XY_ONE >> 1
    ymin_i = 0
    xmin = xmax = v[0][0]
    ymin = ymax = v[0][1]
    p0 = v[-1]
    for i, p in enumerate(v):
        if p[1] < ymin:
            ymin, ymin_i = p[1], i
        ymax = max(ymax, p[1])
        xmax = max(xmax, p[0])
        xmin = min(xmin, p[0])
        _line2(img, p0, p, color)
        p0 = p
    xmin, xmax = (xmin + delta) >> XY_SHIFT, (xmax + delta) >> XY_SHIFT
    ymin, ymax = (ymin + delta) >> XY_SHIFT, (ymax + delta) >> XY_SHIFT
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edges = [{'idx': ymin_i, 'di': 1, 'x': -XY_ONE, 'dx': 0, 'ye': ymin},
             {'idx': ymin_i, 'di': npts - 1, 'x': -XY_ONE, 'dx': 0,
              'ye': ymin}]
    remaining = npts
    y = ymin
    while True:
        for e in edges:
            if y >= e['ye']:
                idx0 = e['idx']
                idx = (idx0 + e['di']) % npts
                while remaining > 0:
                    remaining -= 1
                    ty = (v[idx][1] + delta) >> XY_SHIFT
                    if ty > y:
                        xs, xe = v[idx0][0], v[idx][0]
                        e['ye'] = ty
                        e['dx'] = int(_trunc_div((xe - xs) * 2 + (ty - y),
                                                 2 * (ty - y)))
                        e['x'] = xs
                        e['idx'] = idx
                        break
                    idx0 = idx
                    idx = (idx + e['di']) % npts
                else:
                    remaining -= 1
        if remaining < 0:
            break
        if y >= 0:
            a, b = edges
            left, right = (b, a) if a['x'] > b['x'] else (a, b)
            x1 = (left['x'] + delta) >> XY_SHIFT
            x2 = (right['x'] + delta) >> XY_SHIFT
            if x2 >= 0 and x1 < w:
                img[y, max(x1, 0):min(x2, w - 1) + 1] = color
        for e in edges:
            e['x'] += e['dx']
        y += 1
        if y > ymax:
            break


def fill_ellipse(img: np.ndarray, center, axes, angle: float, color) -> None:
    """cv2.ellipse(img, center, axes, angle, 0, 360, color, -1): center and
    axes int pixels, shift 0, LINE_8."""
    col = _color(color, img.shape[2] if img.ndim == 3 else 1)
    cx, cy = int(center[0]) << XY_SHIFT, int(center[1]) << XY_SHIFT
    aw, ah = abs(int(axes[0])) << XY_SHIFT, abs(int(axes[1])) << XY_SHIFT
    r = (max(aw, ah) + (XY_ONE >> 1)) >> XY_SHIFT
    delta = 90 if r < 3 else 30 if r < 10 else 18 if r < 15 else 5
    v = []
    for x, y in ellipse_poly((float(cx), float(cy)), (float(aw), float(ah)),
                             _cv_round(angle), delta):
        px = _cv_round(x / XY_ONE) << XY_SHIFT
        py = _cv_round(y / XY_ONE) << XY_SHIFT
        pt = (px + _cv_round(x - px), py + _cv_round(y - py))
        if not v or pt != v[-1]:
            v.append(pt)
    if len(v) == 1:
        v = [(cx, cy), (cx, cy)]
    _fill_convex(img, v, col)


def blur3(img: np.ndarray) -> np.ndarray:
    """cv2.GaussianBlur(img, (3, 3), 0) of a uint8 [H,W] or [H,W,C]
    image."""
    x = np.asarray(img).astype(np.int32)
    pad = [(1, 1), (1, 1)] + [(0, 0)] * (x.ndim - 2)
    p = np.pad(x, pad, mode='reflect')          # BORDER_REFLECT_101
    rows = p[:-2] + 2 * p[1:-1] + p[2:]
    s = rows[:, :-2] + 2 * rows[:, 1:-1] + rows[:, 2:]
    return ((s + 8) >> 4).astype(np.uint8)
