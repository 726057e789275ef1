"""The pixel half of the data pipeline, on the loader's device.

``transforms`` decides on the host what happens to each image and records
it in ``s["pixel_ops"]``; here the decoded image (``image_file.decode_image``:
nvJPEG or the PNG kernel on the card, oriented) goes through those operations
where it lies, on the card (or on the CPU for the tests):

1. each recorded op in turn: a bilinear resize, rounded back to uint8, or
   a crop (a slice); VGTRAugment's ops (``data/vgtr_aug.py``) below;
2. BGR->RGB and (x - mean) / std in float32 when the pipeline normalises;
3. into the batch canvas at the top left, over the pad value.

The JAX module resamples twice on the jitter path (the jitter rescale, then
``Resize``), each time in uint8 with rounding, through ``cv2.resize``
(``INTER_LINEAR``); the same sequence is kept, because one fused resample
would move pixels further than the rounding does.  ``F.interpolate``
(bilinear, ``align_corners=False``) samples at the same half-pixel centres
as cv2 but in float where cv2 uses fixed point, so a pixel may land one
level away from cv2's at each resampling.

VGTRAugment's ops follow OpenCV's 8-bit arithmetic, so each lands within
one level of its cv2 call (tests/test_torch_vgtr.py):

- ``("hsv", (a_s, a_v))``: ``COLOR_BGR2HSV``'s fixed-point tables (H in
  [0, 180)), S and V scaled in float32, clipped and truncated, then
  ``COLOR_HSV2BGR``'s float32 sectors (its vector and scalar code);
- ``("jitter", (b, c))``: brightness b, then contrast c about the
  per-channel mean, in float32, clipped and truncated;
- ``("blur", None)``: ``GaussianBlur`` 3x3, sigma 0.8, on its 8-bit
  fixed-point kernel (Q8 taps, rows then columns, reflect-101 border);
- ``("resize_area", (h, w))``: ``INTER_AREA``: the area tables' float32
  sums on a downscale, the linear path's fixed point otherwise;
- ``("border", (top, bottom, left, right, fill))``: ``copyMakeBorder``
  with a constant uint8 fill;
- ``("warp", (m_inv, (h, w), fill))``: ``warpAffine`` INTER_LINEAR with a
  constant border, on the inverted 2x3 matrix: OpenCV's float32 source
  coordinates and bilinear blend;
- ``("flip", None)``: the horizontal flip.
"""

from __future__ import annotations

import functools
import math
from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F


def resize_u8(image: torch.Tensor, size) -> torch.Tensor:
    """Bilinear resize of a uint8 [h, w, 3] image to ``size`` = (h, w),
    rounded back to uint8, as ``cv2.resize(..., INTER_LINEAR)``."""
    if tuple(image.shape[:2]) == tuple(size):
        return image
    x = image.permute(2, 0, 1)[None].float()
    x = F.interpolate(x, size=tuple(size), mode="bilinear",
                      align_corners=False)
    return x[0].round_().clamp_(0, 255).to(torch.uint8).permute(1, 2, 0)


# -- VGTRAugment's ops -------------------------------------------------------

_HSV_SHIFT = 12


@functools.lru_cache(maxsize=None)
def _hsv_tables():
    """OpenCV's 8-bit BGR2HSV division tables (``sdiv_table``,
    ``hdiv_table180``): round(255 << 12 / i), round(180 << 12 / 6i)."""
    i = np.arange(256, dtype=np.float64)
    with np.errstate(divide="ignore"):
        sdiv = np.where(i > 0, np.rint((255 << _HSV_SHIFT) / i), 0)
        hdiv = np.where(i > 0, np.rint((180 << _HSV_SHIFT) / (6.0 * i)), 0)
    return sdiv.astype(np.int64), hdiv.astype(np.int64)


def bgr_to_hsv_u8(image: torch.Tensor) -> torch.Tensor:
    """``cv2.cvtColor(image, COLOR_BGR2HSV)`` of a uint8 [h, w, 3] image:
    H in [0, 180), S and V in [0, 255], from the fixed-point tables."""
    sdiv, hdiv = (torch.from_numpy(t).to(image.device)
                  for t in _hsv_tables())
    px = image.to(torch.int64)
    b, g, r = px.unbind(-1)
    v = px.amax(-1)
    diff = v - px.amin(-1)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * sdiv[v] + half) >> _HSV_SHIFT
    h = torch.where(v == r, g - b,
                    torch.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * hdiv[diff] + half) >> _HSV_SHIFT
    h = torch.where(h < 0, h + 180, h)
    return torch.stack([h, s, v], -1).to(torch.uint8)


# OpenCV's HSV2RGB sector table: (b, g, r) as indices into
# (v, v(1 - s), v(1 - s f), v(1 - s (1 - f)))
_SECTORS = ((1, 3, 0), (1, 0, 2), (3, 0, 1), (0, 2, 1), (0, 1, 3), (2, 1, 0))


def _round_u8(x: torch.Tensor) -> torch.Tensor:
    """OpenCV's ``saturate_cast<uchar>`` of a float: round half to even,
    clamp to [0, 255]."""
    return torch.round(x).clamp_(0, 255).to(torch.uint8)


def _fma32(a: torch.Tensor, b: torch.Tensor, c) -> torch.Tensor:
    """float32 a * b + c with one rounding, as a fused multiply-add: the
    product of two float32 values is exact in float64."""
    return (a.double() * b.double() + c).float()


# OpenCV converts HSV->BGR in vectors of this many pixels of a row, then
# the row's remaining pixels one by one
_HSV_LANES = 32


def hsv_to_bgr_u8(hsv: torch.Tensor) -> torch.Tensor:
    """``cv2.cvtColor(hsv, COLOR_HSV2BGR)`` of a uint8 [h, w, 3] image, in
    OpenCV's float32 sectors: the first multiple of 32 pixels of each row
    as its vector code does (v (1 - s f) with a fused multiply-add, times
    255, truncated), the rest of the row as its scalar code (rounded half
    to even)."""
    x = hsv.to(torch.float32)
    h = x[..., 0] * (6.0 / 180.0)
    s = x[..., 1] * (1.0 / 255.0)
    v = x[..., 2] * (1.0 / 255.0)
    h = torch.fmod(h, 6.0)
    sector = torch.floor(h)
    f = h - sector
    sector = sector.to(torch.int64)
    bad = (sector < 0) | (sector >= 6)
    sector = torch.where(bad, 0, sector)
    f = torch.where(bad, 0.0, f)
    idx = torch.tensor(_SECTORS, device=hsv.device)[sector]
    zero_s = (s == 0)[..., None]

    def bgr(t2, t3):
        tab = torch.stack([v, v * (1.0 - s), t2, t3], -1)
        out = torch.gather(tab, -1, idx)
        return torch.where(zero_s, v[..., None], out) * 255.0

    vec = bgr(v * _fma32(-s, f, 1.0), v * _fma32(-s, 1.0 - f, 1.0))
    out = vec.clamp(0, 255).to(torch.uint8)
    tail = hsv.shape[1] // _HSV_LANES * _HSV_LANES
    if tail < hsv.shape[1]:
        scalar = bgr(v * (1.0 - s * f), v * (1.0 - s * (1.0 - f)))
        out[:, tail:] = _round_u8(scalar[:, tail:])
    return out


def hsv_jitter(image: torch.Tensor, a_s: float, a_v: float) -> torch.Tensor:
    """VGTR's saturation/value jitter: S and V times their factor in
    float32, clipped to [0, 255] and truncated to uint8."""
    hsv = bgr_to_hsv_u8(image).to(torch.float32)
    sv = torch.stack([hsv[..., 1] * a_s, hsv[..., 2] * a_v], -1)
    sv = sv.clamp_(0, 255).to(torch.uint8)
    return hsv_to_bgr_u8(torch.cat([hsv[..., :1].to(torch.uint8), sv], -1))


def color_jitter(image: torch.Tensor, b: float, c: float) -> torch.Tensor:
    """Brightness b, then contrast c about each channel's mean, float32,
    clipped to [0, 255] and truncated to uint8."""
    out = image.to(torch.float32) * b
    mean = out.mean(dim=(0, 1), keepdim=True)
    out = (out - mean) * c + mean
    return out.clamp_(0, 255).to(torch.uint8)


@functools.lru_cache(maxsize=None)
def gaussian_taps_q8(sigma: float = 0.8) -> tuple:
    """OpenCV's 3-tap Gaussian for 8-bit images in Q8 fixed point
    (``getGaussianKernelBitExact`` then error diffusion to a sum of 256):
    (61, 134, 61) at sigma 0.8."""
    t = math.exp(4.0 * (-0.125 / (sigma * sigma)))
    side = int(np.rint(t / (2.0 * t + 1.0) * 256.0))
    return side, 256 - 2 * side, side


def _reflect101(n: int, device) -> torch.Tensor:
    """Indices of a length-n axis padded by one on each side, reflect-101."""
    idx = torch.arange(-1, n + 1, device=device)
    idx[0], idx[-1] = (1, n - 2) if n > 1 else (0, 0)
    return idx


def gaussian_blur_u8(image: torch.Tensor, sigma: float = 0.8) -> torch.Tensor:
    """``cv2.GaussianBlur(image, (3, 3), sigma)`` of a uint8 image: the Q8
    taps along rows (Q8 sums), then along columns (Q16 sums), rounded half
    up to uint8."""
    k0, k1, _ = gaussian_taps_q8(sigma)
    h, w = image.shape[:2]
    x = image.to(torch.int64)
    xs = x[:, _reflect101(w, x.device)]
    x = k0 * (xs[:, :-2] + xs[:, 2:]) + k1 * xs[:, 1:-1]
    ys = x[_reflect101(h, x.device)]
    y = k0 * (ys[:-2] + ys[2:]) + k1 * ys[1:-1]
    return ((y + (1 << 15)) >> 16).clamp_(0, 255).to(torch.uint8)


def _area_taps(src: int, dst: int, scale: float):
    """OpenCV's ``computeResizeAreaTab`` along one axis, in its order:
    (index [dst, K], float32 alpha [dst, K]), padded with zero alphas."""
    taps = []
    for dx in range(dst):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, src - fsx1)
        sx1, sx2 = math.ceil(fsx1), math.floor(fsx2)
        sx2 = min(sx2, src - 1)
        sx1 = min(sx1, sx2)
        row = []
        if sx1 - fsx1 > 1e-3:
            row.append((sx1 - 1, (sx1 - fsx1) / cell))
        row += [(sx, 1.0 / cell) for sx in range(sx1, sx2)]
        if fsx2 - sx2 > 1e-3:
            row.append((sx2, min(min(fsx2 - sx2, 1.0), cell) / cell))
        taps.append(row)
    k = max(len(row) for row in taps)
    idx = np.zeros((dst, k), np.int64)
    alpha = np.zeros((dst, k), np.float32)
    for dx, row in enumerate(taps):
        for j, (i, a) in enumerate(row):
            idx[dx, j], alpha[dx, j] = i, a
    return idx, alpha


def _linear_taps(src: int, dst: int, scale: float, inv_scale: float):
    """INTER_AREA's linear path along one axis (an axis that is not
    downscaled): OpenCV's area-mode offsets and 11-bit weights, (i0, i1,
    a0, a1) int64 [dst]."""
    out = np.zeros((4, dst), np.int64)
    for dx in range(dst):
        sx = math.floor(dx * scale)
        fx = float(np.float32((dx + 1) - (sx + 1) * inv_scale))
        fx = 0.0 if fx <= 0 else float(np.float32(fx - math.floor(fx)))
        if sx >= src - 1:
            sx, fx = src - 1, 0.0
        out[:, dx] = (sx, min(sx + 1, src - 1),
                      np.rint(np.float32(1.0 - fx) * np.float32(2048.0)),
                      np.rint(np.float32(fx) * np.float32(2048.0)))
    return tuple(out)


@functools.lru_cache(maxsize=64)
def _resize_area_plan(h: int, w: int, out_h: int, out_w: int):
    """How ``cv2.resize(INTER_AREA)`` maps (h, w) to (out_h, out_w):
    ("fast", (ky, kx)) for integer factors on both axes, ("area", (y
    taps, x taps)) for a downscale, else ("linear", (y taps, x taps))."""
    inv_x, inv_y = out_w / w, out_h / h
    sx, sy = 1.0 / inv_x, 1.0 / inv_y
    if sx >= 1 and sy >= 1:
        kx, ky = int(round(sx)), int(round(sy))
        if abs(sx - kx) < 2.220446049250313e-16 and \
                abs(sy - ky) < 2.220446049250313e-16:
            return "fast", (ky, kx)
        return "area", (_area_taps(h, out_h, sy), _area_taps(w, out_w, sx))
    return "linear", (_linear_taps(h, out_h, sy, inv_y),
                      _linear_taps(w, out_w, sx, inv_x))


def resize_area_u8(image: torch.Tensor, size) -> torch.Tensor:
    """``cv2.resize(image, (w, h), interpolation=INTER_AREA)`` of a uint8
    image to ``size`` = (h, w), in OpenCV's arithmetic: on a downscale the
    area tables' float32 sums, rows then columns, in their order, rounded
    half to even (integer factors: the block sum times 1/area, or plus 2
    and shifted by 2 for 2x2 blocks); otherwise
    the linear path's 11-bit taps, its rows' integer sums and its column
    blend's truncating 16-bit steps."""
    h, w = image.shape[:2]
    if (h, w) == tuple(size):
        return image
    kind, plan = _resize_area_plan(h, w, *size)
    dev = image.device
    if kind == "fast":
        ky, kx = plan
        x = image.to(torch.int64)[:size[0] * ky, :size[1] * kx]
        x = x.reshape(size[0], ky, size[1], kx, -1).sum((1, 3))
        if (ky, kx) == (2, 2):  # OpenCV's 2x2 path rounds half up
            return ((x + 2) >> 2).to(torch.uint8)
        return _round_u8(x.float() * np.float32(1.0 / (kx * ky)))
    if kind == "area":
        (yi, ya), (xi, xa) = [
            (torch.from_numpy(i).to(dev), torch.from_numpy(a).to(dev))
            for i, a in plan]
        src = image.to(torch.float32)
        rows = torch.zeros(h, size[1], image.shape[2], device=dev)
        for k in range(xi.shape[1]):
            rows = rows + src[:, xi[:, k]] * xa[:, k, None]
        out = torch.zeros(size[0], size[1], image.shape[2], device=dev)
        for k in range(yi.shape[1]):
            out = out + ya[:, k, None, None] * rows[yi[:, k]]
        return _round_u8(out)
    (y0, y1, b0, b1), (x0, x1, a0, a1) = [
        [torch.from_numpy(t).to(dev) for t in taps] for taps in plan]
    src = image.to(torch.int64)
    rows = src[:, x0] * a0[:, None] + src[:, x1] * a1[:, None]
    # OpenCV's vertical pass: (S >> 4) * beta >> 16 per row, summed, then
    # a rounding shift by 2
    out = ((((rows[y0] >> 4) * b0[:, None, None]) >> 16)
           + (((rows[y1] >> 4) * b1[:, None, None]) >> 16))
    return ((out + 2) >> 2).clamp_(0, 255).to(torch.uint8)


def border_u8(image: torch.Tensor, top: int, bottom: int, left: int,
              right: int, fill) -> torch.Tensor:
    """``cv2.copyMakeBorder(..., BORDER_CONSTANT, value=fill)``; ``fill``
    is the uint8 triple."""
    h, w, ch = image.shape
    out = torch.empty((h + top + bottom, w + left + right, ch),
                      dtype=image.dtype, device=image.device)
    out[:] = torch.as_tensor(fill, dtype=image.dtype, device=image.device)
    out[top:top + h, left:left + w] = image
    return out


def warp_affine_u8(image: torch.Tensor, m_inv, size, fill) -> torch.Tensor:
    """``cv2.warpAffine(image, m, (w, h), flags=INTER_LINEAR,
    borderValue=fill)`` given ``m_inv``, OpenCV's inverse of ``m`` (2x3):
    OpenCV's float32 source coordinates (x m0 + (y m1 + m2), the x term
    fused), the four taps (the fill off the image) blended in float32 and
    rounded half to even."""
    out_h, out_w = size
    dev = image.device
    m = torch.as_tensor(np.asarray(m_inv, np.float64).reshape(6),
                        dtype=torch.float32, device=dev)
    xs = torch.arange(out_w, dtype=torch.float32, device=dev)
    ys = torch.arange(out_h, dtype=torch.float32, device=dev)
    sx = _fma32(xs[None, :], m[0], (ys * m[1] + m[2])[:, None].double())
    sy = _fma32(xs[None, :], m[3], (ys * m[4] + m[5])[:, None].double())
    ix, iy = torch.floor(sx), torch.floor(sy)
    ax, ay = (sx - ix)[..., None], (sy - iy)[..., None]
    ix, iy = ix.to(torch.int64), iy.to(torch.int64)
    h, w = image.shape[:2]
    src = image.to(torch.float32)
    fill_t = torch.as_tensor(fill, dtype=torch.float32, device=dev)

    def tap(dy, dx):
        tx, ty = ix + dx, iy + dy
        inside = (tx >= 0) & (tx < w) & (ty >= 0) & (ty < h)
        px = src[ty.clamp(0, h - 1), tx.clamp(0, w - 1)]
        return torch.where(inside[..., None], px, fill_t)

    p00, p01, p10, p11 = tap(0, 0), tap(0, 1), tap(1, 0), tap(1, 1)
    v0 = p00 + ax * (p01 - p00)
    v1 = p10 + ax * (p11 - p10)
    return _round_u8(v0 + ay * (v1 - v0))


def apply_pixel_ops(image: torch.Tensor, ops: Sequence) -> torch.Tensor:
    """Replays a sample's recorded pixel ops on its image."""
    for kind, arg in ops:
        if kind == "resize":
            image = resize_u8(image, arg)
        elif kind == "crop":
            y0, y1, x0, x1 = arg
            image = image[y0:y1, x0:x1]
        elif kind == "hsv":
            image = hsv_jitter(image, *arg)
        elif kind == "jitter":
            image = color_jitter(image, *arg)
        elif kind == "blur":
            image = gaussian_blur_u8(image)
        elif kind == "resize_area":
            image = resize_area_u8(image, arg)
        elif kind == "border":
            image = border_u8(image, *arg)
        elif kind == "warp":
            image = warp_affine_u8(image, *arg)
        elif kind == "flip":
            image = image.flip(1)
        else:
            raise ValueError(f"unknown pixel op {kind!r}")
    return image


def normalize(image: torch.Tensor, norm_cfg) -> torch.Tensor:
    """float32 (img - mean) / std, BGR->RGB first when ``to_rgb``: the JAX
    ``Normalize``, element for element."""
    x = image.float()
    if norm_cfg.get("to_rgb", True):
        x = x.flip(-1)
    mean = torch.as_tensor(norm_cfg["mean"], dtype=torch.float32,
                           device=x.device)
    std = torch.as_tensor(norm_cfg["std"], dtype=torch.float32,
                          device=x.device)
    return (x - mean) / std


def render(sample: dict, decoded: torch.Tensor) -> torch.Tensor:
    """A sample's image after its pipeline, unpadded: uint8 [h, w, 3], or
    float32 when the pipeline normalises, from its decoded image (on the
    device where it lies)."""
    image = apply_pixel_ops(decoded, sample["pixel_ops"])
    if tuple(image.shape) != tuple(sample["img_shape"]):
        raise AssertionError(f"pixel ops gave {tuple(image.shape)}, the "
                             f"geometry {sample['img_shape']}")
    if "img_norm_cfg" in sample:
        image = normalize(image, sample["img_norm_cfg"])
    return image


def collate_images(samples: List[dict], canvas: int, device,
                   decoded: Sequence[torch.Tensor]) -> torch.Tensor:
    """The batch's image [B, canvas, canvas, 3] on ``device`` from the
    samples' decoded images: each sample's rendered image at the top left,
    its pad region at the pad value and the rest of the canvas 0 (the JAX
    collate's layout).  float32 when the pipeline normalises, else
    uint8."""
    norm = bool(samples) and "img_norm_cfg" in samples[0]
    out = torch.zeros((len(samples), canvas, canvas, 3),
                      dtype=torch.float32 if norm else torch.uint8,
                      device=device)
    for i, s in enumerate(samples):
        ph, pw = s["pad_shape"][:2]
        if ph > canvas or pw > canvas:
            raise AssertionError((s["pad_shape"], canvas))
        if s.get("pad_val", 0):
            out[i, :ph, :pw] = s["pad_val"]
        image = render(s, decoded[i])
        h, w = image.shape[:2]
        out[i, :h, :w] = image
    return out
