"""The host geometry of binary masks that the mask path takes from OpenCV,
in numpy and plain Python, pixel for pixel as OpenCV computes it (the
card's machine has no cv2).

- ``fill_poly``: ``cv2.fillPoly(mask, [pts], 1)`` (8-connected outline,
  integer vertices, no shift): each edge drawn as OpenCV's 8-connected
  Bresenham line, then the scan-line fill over the edge list in 16.16 fixed
  point, each row from the first pixel centre at or right of the left edge
  to the last at or left of the right edge; an edge with an end outside the
  image is first clipped to it (cv2.clipLine) and runs through the clipped
  ends' x (a COCO polygon vertex may round to x = w or y = h);
- ``resize_nearest``: ``cv2.resize(..., INTER_NEAREST)``, the source index
  ``min(floor(dst * (1 / (dst_size / src_size))), src_size - 1)``;
- ``find_contours``: ``cv2.findContours(mask, RETR_TREE,
  CHAIN_APPROX_NONE)``'s contours, Suzuki-Abe border following on a
  zero-framed copy, each from OpenCV's start pixel in its point order, the
  list in OpenCV's order (a pre-order walk of the border tree, siblings
  last-found first);
- ``contour_area``, ``contour_moments`` (m00, m10, m01) and
  ``point_polygon_test`` (``measureDist=False``): OpenCV's shoelace, Green's
  theorem sums and crossing test for a point set, in its float types;
- ``contour_outline``: the pixels ``cv2.drawContours(img, contours, -1,
  color, 2)`` sets for contours inside the image: each closed polyline's
  segments as OpenCV's thick lines (a convex quad filled in 16.16 fixed
  point with its fixed-point edges, and a radius-1 round cap at each end
  point).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

_XY_SHIFT = 16
_XY_ONE = 1 << _XY_SHIFT
# OpenCV's chain code: direction s -> (dx, dy), counter-clockwise from +x
_CODE_DELTAS = ((1, 0), (1, -1), (0, -1), (-1, -1), (-1, 0), (-1, 1), (0, 1),
                (1, 1))


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """cv2.clipLine to the image rectangle: (inside, x1, y1, x2, y2)."""
    right, bottom = w - 1, h - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _line(img: np.ndarray, x1: int, y1: int, x2: int, y2: int,
          color: int) -> None:
    """OpenCV's 8-connected line (LineIterator, left to right)."""
    h, w = img.shape
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        inside, x1, y1, x2, y2 = _clip_line(w, h, x1, y1, x2, y2)
        if not inside:
            return
    dx, dy = x2 - x1, y2 - y1
    if dx < 0:
        dx, dy, x1, y1 = -dx, -dy, x2, y2
    sy = 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err, plus, minus = dx - 2 * dy, 2 * dx, -2 * dy
    x, y = x1, y1
    for _ in range(dx + 1):
        img[y, x] = color
        step = err < 0
        err += minus + (plus if step else 0)
        if vert:
            y += sy
            x += step
        else:
            x += 1
            y += sy if step else 0


class _Edge:
    __slots__ = ("y0", "y1", "x", "dx", "next")


def _trunc_div(a: int, b: int) -> int:
    """C's integer division, toward zero."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def fill_poly(img: np.ndarray, polys: Sequence[np.ndarray],
              color: int = 1) -> np.ndarray:
    """cv2.fillPoly(img, polys, color) with integer vertices [N, 2] (x, y),
    8-connected, in place; returns ``img``."""
    h, w = img.shape
    edges: List[_Edge] = []
    for poly in polys:
        pts = [(int(x) << _XY_SHIFT, int(y)) for x, y in
               np.asarray(poly).reshape(-1, 2)]
        if not pts:
            continue
        pt0 = pts[-1]
        for pt1 in pts:
            t0 = ((pt0[0] + (_XY_ONE >> 1)) >> _XY_SHIFT, pt0[1])
            t1 = ((pt1[0] + (_XY_ONE >> 1)) >> _XY_SHIFT, pt1[1])
            _line(img, t0[0], t0[1], t1[0], t1[1], color)
            p0c, p1c = list(pt0), list(pt1)
            if not (0 <= t0[0] < w and 0 <= t1[0] < w and 0 <= t0[1] < h
                    and 0 <= t1[1] < h):
                # an edge with an end outside runs through the clipped ends'
                # x, and their y unless the clipped line is horizontal
                _, cx0, cy0, cx1, cy1 = _clip_line(w, h, *t0, *t1)
                p0c[0], p1c[0] = cx0 << _XY_SHIFT, cx1 << _XY_SHIFT
                if cy0 != cy1:
                    p0c[1], p1c[1] = cy0, cy1
            if pt0[1] != pt1[1]:
                e = _Edge()
                e.dx = _trunc_div(p1c[0] - p0c[0], p1c[1] - p0c[1])
                if pt0[1] < pt1[1]:
                    e.y0, e.y1 = pt0[1], pt1[1]
                    e.x = p0c[0] + (pt0[1] - p0c[1]) * e.dx
                else:
                    e.y0, e.y1 = pt1[1], pt0[1]
                    e.x = p1c[0] + (pt1[1] - p1c[1]) * e.dx
                edges.append(e)
            pt0 = pt1
    _fill_edges(img, edges, color)
    return img


def _fill_edges(img: np.ndarray, edges: List[_Edge], color: int) -> None:
    """OpenCV's FillEdgeCollection for the non-antialiased line types."""
    h, w = img.shape
    total = len(edges)
    if total < 2:
        return
    y_min = min(e.y0 for e in edges)
    y_max = max(e.y1 for e in edges)
    ends = [e.x + (e.y1 - e.y0) * e.dx for e in edges]
    x_min = min(min(e.x for e in edges), min(ends))
    x_max = max(max(e.x for e in edges), max(ends))
    if y_max < 0 or y_min >= h or x_max < 0 or x_min >= (w << _XY_SHIFT):
        return
    edges.sort(key=lambda e: (e.y0, e.x, e.dx))
    sentinel = _Edge()
    sentinel.y0 = 2 ** 31 - 1
    edges.append(sentinel)
    head = _Edge()
    head.next = None
    i = 0
    e = edges[0]
    y_max = min(y_max, h)
    for y in range(e.y0, y_max):
        draw = False
        prelast, last = head, head.next
        while last is not None or e.y0 == y:
            if last is not None and last.y1 == y:
                prelast.next = last.next  # the edge ends above this row
                last = last.next
                continue
            keep_prelast = prelast
            if last is not None and (e.y0 > y or last.x < e.x):
                prelast, last = last, last.next
            elif i < total:  # the next edge starts on this row
                prelast.next = e
                e.next = last
                prelast = e
                i += 1
                e = edges[i]
            else:
                break
            if draw:
                if y >= 0:
                    if keep_prelast.x > prelast.x:
                        x1 = (prelast.x + _XY_ONE - 1) >> _XY_SHIFT
                        x2 = keep_prelast.x >> _XY_SHIFT
                    else:
                        x1 = (keep_prelast.x + _XY_ONE - 1) >> _XY_SHIFT
                        x2 = prelast.x >> _XY_SHIFT
                    if x1 < w and x2 >= 0:
                        img[y, max(x1, 0):min(x2, w - 1) + 1] = color
                keep_prelast.x += keep_prelast.dx
                prelast.x += prelast.dx
            draw = not draw
        # bubble sort of the active list by x
        keep_prelast = None
        while True:
            prelast, last = head, head.next
            last_exchange = None
            while last is not keep_prelast and last.next is not None:
                te = last.next
                if last.x > te.x:
                    prelast.next = te
                    last.next = te.next
                    te.next = last
                    prelast = te
                    last_exchange = prelast
                else:
                    prelast, last = last, te
            if last_exchange is None:
                break
            keep_prelast = last_exchange
            if keep_prelast is head.next or keep_prelast is head:
                break


def resize_nearest(img: np.ndarray, wh: Tuple[int, int]) -> np.ndarray:
    """cv2.resize(img, (w, h), interpolation=cv2.INTER_NEAREST)."""
    h, w = img.shape[:2]
    dw, dh = wh
    ifx, ify = 1.0 / (dw / w), 1.0 / (dh / h)
    xs = np.minimum(np.floor(np.arange(dw) * ifx).astype(np.int64), w - 1)
    ys = np.minimum(np.floor(np.arange(dh) * ify).astype(np.int64), h - 1)
    return img[ys[:, None], xs[None, :]]


def _trace(flat: list, marks: np.ndarray, width: int, i0: int,
           is_hole: bool, label: int,
           simple: bool = False) -> List[Tuple[int, int]]:
    """Follows the border through flat index ``i0`` of the framed image
    (OpenCV's icvFetchContourEx with CHAIN_APPROX_NONE, or with ``simple``
    CHAIN_APPROX_SIMPLE's turning points only), marking its pixels
    ``label`` (``-label`` on the right bound) in ``flat`` and in its array
    copy ``marks``; returns the points in the unframed image's
    coordinates."""
    d = (1, -width + 1, -width, -width - 1, -1, width - 1, width, width + 1)
    deltas = d + d
    pt = [i0 % width - 1, i0 // width - 1]
    s_end = s = 0 if is_hole else 4
    while True:
        s = (s - 1) & 7
        i1 = i0 + deltas[s]
        if flat[i1] != 0 or s == s_end:
            break
    if s == s_end:  # a single pixel
        flat[i0] = marks[i0] = -label
        return [tuple(pt)]
    pts = []
    i3, prev_s = i0, s ^ 4
    while True:
        s_end = s
        i4 = i3
        while s < 15:
            s += 1
            i4 = i3 + deltas[s]
            if flat[i4] != 0:
                break
        s &= 7
        if 0 <= s - 1 < s_end:
            flat[i3] = marks[i3] = -label
        elif flat[i3] == 1:
            flat[i3] = marks[i3] = label
        if s != prev_s or not simple:
            pts.append((pt[0], pt[1]))
            prev_s = s
        pt[0] += _CODE_DELTAS[s][0]
        pt[1] += _CODE_DELTAS[s][1]
        if i4 == i0 and i3 == i1:
            return pts
        i3 = i4
        s = (s + 4) & 7


def find_contours(mask: np.ndarray, external: bool = False,
                  simple: bool = False) -> List[np.ndarray]:
    """cv2.findContours(mask, cv2.RETR_TREE, cv2.CHAIN_APPROX_NONE)[0] as a
    list of int32 [N, 2] (x, y) point arrays (nonzero pixels are the
    foreground); ``external``: the outer borders that no hole holds
    (RETR_EXTERNAL's contours, in the tree's order); ``simple``:
    CHAIN_APPROX_SIMPLE's points."""
    h, w = mask.shape
    width = w + 2
    framed = np.zeros((h + 2, width), np.int64)
    framed[1:-1, 1:-1] = mask != 0
    live_rows = framed.any(axis=1)  # a row of zeros holds no border
    marks = framed.ravel()  # the scan's view of the marks
    flat = marks.tolist()  # the tracer's
    # per contour: points, is_hole, parent (-1: the frame, a hole)
    contours: List[Tuple[list, bool, int]] = []
    label_of = {}  # pixel label -> contour index
    next_label = 2
    for y in np.flatnonzero(live_rows).tolist():
        base = y * width
        row = framed[y]
        x, prev, lnbd = 1, 0, 0
        while x < width:
            # the next pixel whose value differs from prev
            step = np.flatnonzero(row[x:] != prev)
            if not step.size:
                break
            x += int(step[0])
            p = flat[base + x]
            if (prev == 0 and p == 1) or (p == 0 and prev >= 1):
                is_hole = p == 0
                if is_hole and prev not in (0, 1):
                    lnbd = x - 1
                if lnbd <= 0:
                    parent = -1
                else:
                    parent = label_of[abs(flat[base + lnbd])]
                    parent_hole = True if parent < 0 else \
                        contours[parent][1]
                    if parent_hole == is_hole:
                        parent = -1 if parent < 0 else contours[parent][2]
                lnbd = x - is_hole
                label = next_label
                next_label += 1
                label_of[label] = len(contours)
                pts = _trace(flat, marks, width, base + x - is_hole, is_hole,
                             label, simple)
                contours.append((pts, is_hole, parent))
                prev = flat[base + x]
                x += 1
                continue
            prev = p
            if p not in (0, 1):
                lnbd = x
            x += 1
    children = {}
    for i, (_, _, parent) in enumerate(contours):
        children.setdefault(parent, []).append(i)
    order, stack = [], list(children.get(-1, []))
    while stack:  # pre-order, each node's last-found child first
        i = stack.pop()
        order.append(i)
        if not external:
            stack.extend(children.get(i, []))
    return [np.asarray(contours[i][0], np.int32).reshape(-1, 2)
            for i in order]


def contour_area(contour: np.ndarray) -> float:
    """cv2.contourArea(contour) (unsigned shoelace over the points)."""
    pts = np.asarray(contour, np.float64).reshape(-1, 2)
    if len(pts) == 0:
        return 0.0
    prev = np.roll(pts, 1, axis=0)
    a00 = 0.0
    for (px, py), (x, y) in zip(prev.tolist(), pts.tolist()):
        a00 += px * y - py * x
    return abs(a00 * 0.5)


def contour_moments(contour: np.ndarray) -> Tuple[float, float, float]:
    """(m00, m10, m01) of cv2.moments(contour) for an int point set: the
    polygon's, by Green's theorem, in OpenCV's order of float operations."""
    pts = np.asarray(contour, np.float64).reshape(-1, 2).tolist()
    if not pts:
        return 0.0, 0.0, 0.0
    a00 = a10 = a01 = 0.0
    xi_1, yi_1 = pts[-1]
    for xi, yi in pts:
        dxy = xi_1 * yi - xi * yi_1
        a00 += dxy
        a10 += dxy * (xi_1 + xi)
        a01 += dxy * (yi_1 + yi)
        xi_1, yi_1 = xi, yi
    if abs(a00) <= np.finfo(np.float32).eps:
        return 0.0, 0.0, 0.0
    sign = 1.0 if a00 > 0 else -1.0
    db1_2, db1_6 = sign * 0.5, sign * 0.16666666666666666
    return a00 * db1_2, a10 * db1_6, a01 * db1_6


def point_polygon_test(contour: np.ndarray, pt) -> float:
    """cv2.pointPolygonTest(contour, pt, False): +1 inside, -1 outside, 0
    on an edge; ``pt`` is rounded to float32, as OpenCV's Point2f."""
    v = np.asarray(contour, np.float32).reshape(-1, 2)
    if len(v) == 0:
        return -1.0
    px, py = (np.float32(c) for c in pt)
    counter = 0
    v0 = v[-1]
    for vv in v:
        x0, y0 = v0
        x1, y1 = vv
        v0 = vv
        if (y0 <= py and y1 <= py) or (y0 > py and y1 > py) or \
                (x0 < px and x1 < px):
            if py == y1 and (px == x1 or (py == y0 and (
                    (x0 <= px <= x1) or (x1 <= px <= x0)))):
                return 0.0
            continue
        dist = (float(np.float32(py - y0)) * float(np.float32(x1 - x0))
                - float(np.float32(px - x0)) * float(np.float32(y1 - y0)))
        if dist == 0:
            return 0.0
        if y1 < y0:
            dist = -dist
        counter += dist > 0
    return -1.0 if counter % 2 == 0 else 1.0


def _clip_put(img: np.ndarray, x: int, y: int) -> None:
    h, w = img.shape
    if 0 <= x < w and 0 <= y < h:
        img[y, x] = True


def _line_fixed(img: np.ndarray, x1: int, y1: int, x2: int, y2: int) -> None:
    """OpenCV's Line2: an 8-connected line between 16.16 fixed-point
    ends."""
    h, w = img.shape
    inside, x1, y1, x2, y2 = _clip_line(w << _XY_SHIFT, h << _XY_SHIFT,
                                        x1, y1, x2, y2)
    if not inside:
        return
    dx, dy = x2 - x1, y2 - y1
    if abs(dx) > abs(dy):
        if dx < 0:
            x1, x2, y1, y2, dy = x2, x1, y2, y1, -dy
        x_step, y_step = _XY_ONE, _trunc_div(dy << _XY_SHIFT, abs(dx) | 1)
        count = (x2 - x1) >> _XY_SHIFT
    else:
        if dy < 0:
            x1, x2, y1, y2, dx = x2, x1, y2, y1, -dx
        x_step, y_step = _trunc_div(dx << _XY_SHIFT, abs(dy) | 1), _XY_ONE
        count = (y2 - y1) >> _XY_SHIFT
    x1 += _XY_ONE >> 1
    y1 += _XY_ONE >> 1
    _clip_put(img, (x2 + (_XY_ONE >> 1)) >> _XY_SHIFT,
              (y2 + (_XY_ONE >> 1)) >> _XY_SHIFT)
    if x_step == _XY_ONE:
        x1 >>= _XY_SHIFT
        for _ in range(count + 1):
            _clip_put(img, x1, y1 >> _XY_SHIFT)
            x1 += 1
            y1 += y_step
    else:
        y1 >>= _XY_SHIFT
        for _ in range(count + 1):
            _clip_put(img, x1 >> _XY_SHIFT, y1)
            x1 += x_step
            y1 += 1


def _fill_convex(img: np.ndarray, v: List[Tuple[int, int]]) -> None:
    """OpenCV's FillConvexPoly for 16.16 fixed-point vertices, 8-connected:
    the edges as fixed-point lines, then the rows between the two chains."""
    h, w = img.shape
    half = _XY_ONE >> 1
    n = len(v)
    p0 = v[-1]
    for p in v:
        _line_fixed(img, p0[0], p0[1], p[0], p[1])
        p0 = p
    xs, ys = [p[0] for p in v], [p[1] for p in v]
    imin = min(range(n), key=lambda k: (ys[k], k))
    xmin, xmax = (min(xs) + half) >> _XY_SHIFT, (max(xs) + half) >> _XY_SHIFT
    ymin, ymax = (min(ys) + half) >> _XY_SHIFT, (max(ys) + half) >> _XY_SHIFT
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edge = [{"idx": imin, "di": 1, "x": -_XY_ONE, "dx": 0, "ye": ymin},
            {"idx": imin, "di": n - 1, "x": -_XY_ONE, "dx": 0, "ye": ymin}]
    y, edges = ymin, n
    while True:
        for e in edge:
            if y < e["ye"]:
                continue
            idx0, di = e["idx"], e["di"]
            idx = (idx0 + di) % n
            while True:
                edges -= 1
                if edges < 0:
                    break
                ty = (v[idx][1] + half) >> _XY_SHIFT
                if ty > y:
                    e["ye"] = ty
                    e["dx"] = _trunc_div((v[idx][0] - v[idx0][0]) * 2
                                         + (ty - y), 2 * (ty - y))
                    e["x"] = v[idx0][0]
                    e["idx"] = idx
                    break
                idx0, idx = idx, (idx + di) % n
        if edges < 0:
            break
        if y >= 0:
            left, right = ((edge[1], edge[0]) if edge[0]["x"] > edge[1]["x"]
                           else (edge[0], edge[1]))
            x1 = (left["x"] + half) >> _XY_SHIFT
            x2 = (right["x"] + half) >> _XY_SHIFT
            if x2 >= 0 and x1 < w:
                img[y, max(x1, 0):min(x2, w - 1) + 1] = True
        edge[0]["x"] += edge[0]["dx"]
        edge[1]["x"] += edge[1]["dx"]
        y += 1
        if y > ymax:
            break


def contour_outline(shape: Tuple[int, int],
                    contours: Sequence[np.ndarray]) -> np.ndarray:
    """bool [h, w]: the pixels of cv2.drawContours(img, contours, -1, color,
    thickness=2, cv2.LINE_8) for int contours inside the image."""
    out = np.zeros(shape, bool)
    for c in contours:
        pts = np.asarray(c).reshape(-1, 2).tolist()
        x0, y0 = pts[-1]
        for x1, y1 in pts:  # closed: the last point to the first, then on
            px0, py0 = x0 << _XY_SHIFT, y0 << _XY_SHIFT
            px1, py1 = x1 << _XY_SHIFT, y1 << _XY_SHIFT
            dx, dy = (px0 - px1) / _XY_ONE, (py1 - py0) / _XY_ONE
            r = dx * dx + dy * dy
            if abs(r) > np.finfo(np.float64).eps:
                r = _XY_ONE / np.sqrt(r)  # half the thickness, 16.16
                dpx, dpy = int(np.rint(dy * r)), int(np.rint(dx * r))
                _fill_convex(out, [(px0 + dpx, py0 + dpy),
                                   (px0 - dpx, py0 - dpy),
                                   (px1 - dpx, py1 - dpy),
                                   (px1 + dpx, py1 + dpy)])
            for cx, cy in ((x1, y1 - 1), (x1 - 1, y1), (x1, y1), (x1 + 1, y1),
                           (x1, y1 + 1)):  # the round cap, radius 1
                _clip_put(out, cx, cy)
            x0, y0 = x1, y1
    return out
