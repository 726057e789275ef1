"""Image streams of every format the port reads besides JPEG and PNG, made
from a seed: by cv2 and PIL where they write the case, else by the small
writers here (BMP with any header, depth and RLE; Sun raster with RLE and
a colormap; ASCII PNM; PFM; TIFF in tiles or planes; GIF with a frame
inside its screen).  ``cases()`` lists the CPU tests' cases by format;
``tests/fixtures/make_format_fixtures.py`` writes them, and one 480 x 640
image of each format, for ``chip_smoke.py``.
"""

import io
import struct
import zlib

import numpy as np


def smooth(h, w, seed=0, levels=0):
    """A smooth BGR uint8 image (gradients, a disc and a bar), quantised to
    ``levels`` steps a channel when given, so that it codes small."""
    yy, xx = np.mgrid[:h, :w] / np.array([max(h, 1), max(w, 1)]).reshape(
        2, 1, 1)
    ph = np.random.default_rng(seed).uniform(0, 3, 3)
    img = np.dstack([128 + 100 * np.sin(5 * xx + 3 * yy + ph[0]),
                     128 + 90 * np.cos(4 * yy - 2 * xx + ph[1]),
                     128 + 80 * np.sin(3 * xx * yy + ph[2])])
    img[(yy - 0.5) ** 2 + (xx - 0.4) ** 2 < 0.04] = (40, 200, 90)
    img[int(0.7 * h):int(0.8 * h), int(0.1 * w):int(0.6 * w)] = (230, 30, 60)
    if levels:
        img = np.round(img / (256 / levels)) * (256 / levels)
    return np.clip(img, 0, 255).astype(np.uint8)


def textured(h, w, seed=0, beta=1.2):
    """A BGR uint8 image with a natural image's spectrum: random phases
    under an amplitude falling as 1 / f**beta (photographs sit near
    beta = 1-1.4; a larger beta is smoother), the channels correlated as a
    photograph's are, with no flat or posterised areas."""
    rng = np.random.default_rng(seed)
    f = np.hypot(np.fft.fftfreq(h)[:, None], np.fft.rfftfreq(w)[None])
    f[0, 0] = 1
    amp = f ** -beta

    def field():
        phase = np.exp(2j * np.pi * rng.random(amp.shape))
        return np.fft.irfft2(amp * phase, (h, w))

    base = field()
    img = np.dstack([0.8 * base + 0.35 * field() for _ in range(3)])
    img = (img - img.mean()) / img.std() * 45 + 120
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def noise(h, w, seed=0, channels=3):
    return np.random.default_rng(seed).integers(0, 256, (h, w, channels),
                                                np.uint8)


def _pil(arr, fmt, mode=None, **kw):
    from PIL import Image

    im = Image.fromarray(arr)
    if mode:
        im = im.convert(mode)
    b = io.BytesIO()
    im.save(b, fmt, **kw)
    return b.getvalue()


def _cv2(ext, img, params=()):
    import cv2

    ok, buf = cv2.imencode(ext, img, list(params))
    assert ok, ext
    return buf.tobytes()


# ---- BMP --------------------------------------------------------------------

def _rle8(rows, four):
    """BI_RLE8/RLE4 runs of index rows (bottom-up order given), each row
    ended by an end of line, the image by an end of bitmap; short
    literals and odd runs both used."""
    out = bytearray()
    for row in rows:
        x, n = 0, len(row)
        while x < n:
            run = 1
            while x + run < n and run < 255 and row[x + run] == row[x]:
                run += 1
            if run >= 3 or n - x < 3:
                v = row[x]
                out += bytes((run, (v << 4 | v) if four else v))
                x += run
            else:  # a literal of up to 8 pixels
                k = min(8, n - x)
                lit = row[x:x + k]
                out += bytes((0, k))
                if four:
                    packed = [(lit[i] << 4) | (lit[i + 1] if i + 1 < k else 0)
                              for i in range(0, k, 2)]
                    data = bytes(packed)
                else:
                    data = bytes(lit)
                out += data + b"\x00" * (len(data) & 1)
                x += k
        out += b"\x00\x00"
    out += b"\x00\x01"
    return bytes(out)


def bmp(img=None, bpp=24, rle=False, top_down=False, header=40, seed=0,
        palette=None, index=None, bitfields=None):
    """A BMP of ``img`` (BGR) at ``bpp``; 1/4/8 bits take ``index`` and a
    BGR ``palette``; ``header`` 12 (OS/2 core), 40 or 124 (V5);
    ``bitfields`` (red, green, blue) masks for 16 bits."""
    h, w = (index if index is not None else img).shape[:2]
    if bpp <= 8:
        rows = [list(map(int, r)) for r in index]
    if rle:
        comp = 2 if bpp == 4 else 1
        data = _rle8(rows[::-1], bpp == 4)
    else:
        comp = 3 if bitfields else 0
        stride = (w * bpp + 31) // 32 * 4
        out = bytearray()
        order = range(h) if top_down else range(h - 1, -1, -1)
        for y in order:
            if bpp <= 8:
                bits = np.asarray(rows[y], np.uint8)
                if bpp < 8:
                    per = 8 // bpp
                    pad = (-w) % per
                    bits = np.concatenate([bits, np.zeros(pad, np.uint8)])
                    bits = bits.reshape(-1, per)
                    sh = (8 - bpp) - bpp * np.arange(per)
                    bits = (bits.astype(np.int64) << sh).sum(1).astype(
                        np.uint8)
                line = bits.tobytes()
            elif bpp == 16:
                b, g, r = (img[y, :, k].astype(np.int64) for k in range(3))
                if bitfields == (0xF800, 0x7E0, 0x1F):
                    v = (r >> 3) << 11 | (g >> 2) << 5 | b >> 3
                else:
                    v = (r >> 3) << 10 | (g >> 3) << 5 | b >> 3
                line = v.astype("<u2").tobytes()
            elif bpp == 24:
                line = img[y].tobytes()
            else:
                alpha = np.random.default_rng(seed + y).integers(0, 256, w)
                line = np.dstack([img[y:y + 1], alpha[None, :, None]]
                                 ).astype(np.uint8).tobytes()
            out += line + b"\x00" * (stride - len(line))
        data = bytes(out)
    hh = -h if top_down else h
    if header == 12:
        dib = struct.pack("<IHHHH", 12, w, h, 1, bpp)
        pal = b"" if bpp > 8 else np.asarray(palette, np.uint8)[
            :1 << bpp, :3].tobytes()
    else:
        n = 0 if bpp > 8 else len(palette)
        dib = struct.pack("<IiiHHIIiiII", header, w, hh, 1, bpp, comp,
                          len(data), 2835, 2835, n, 0)
        if header > 40:
            masks = struct.pack("<IIII", 0xFF0000, 0xFF00, 0xFF, 0xFF000000)
            dib += masks + b"\x00" * (header - 40 - len(masks))
        if bitfields:
            dib += struct.pack("<III", *bitfields)
        pal = b"" if bpp > 8 else np.hstack(
            [np.asarray(palette, np.uint8),
             np.zeros((len(palette), 1), np.uint8)]).tobytes()
    offset = 14 + len(dib) + len(pal)
    return (b"BM" + struct.pack("<IHHI", offset + len(data), 0, 0, offset)
            + dib + pal + data)


# ---- Sun raster -------------------------------------------------------------

def _sun_rle(raw):
    out, i, n = bytearray(), 0, len(raw)
    while i < n:
        run = 1
        while i + run < n and run < 256 and raw[i + run] == raw[i]:
            run += 1
        v = raw[i]
        if run >= 3 or v == 0x80:
            if v == 0x80 and run == 1:
                out += b"\x80\x00"
            else:
                out += bytes((0x80, run - 1, v))
            i += run
        else:
            out.append(v)
            i += 1
    return bytes(out)


def sunras(img=None, depth=24, rle=False, rgb=False, index=None,
           palette=None):
    """A Sun raster: 24/32 bits of ``img`` (BGR; RT_FORMAT_RGB when
    ``rgb``), 1/8 bits of ``index`` with an optional BGR colormap."""
    h, w = (index if index is not None else img).shape[:2]
    stride = ((w * depth + 7) // 8 + 1) & ~1
    rows = []
    for y in range(h):
        if depth == 1:
            line = np.packbits(np.asarray(index[y], np.uint8) & 1).tobytes()
        elif depth == 8:
            line = np.asarray(index[y], np.uint8).tobytes()
        else:
            px = img[y][:, ::-1] if rgb else img[y]
            if depth == 32:
                px = np.hstack([np.full((w, 1), 7, np.uint8), px])
            line = px.tobytes()
        rows.append(line + b"\x00" * (stride - len(line)))
    data = b"".join(rows)
    kind = 2 if rle else 3 if rgb else 1
    if rle:
        data = _sun_rle(data)
    cmap = b""
    if palette is not None:
        p = np.asarray(palette, np.uint8)
        cmap = p[:, 2].tobytes() + p[:, 1].tobytes() + p[:, 0].tobytes()
    head = struct.pack(">8I", 0x59A66A95, w, h, depth, len(data), kind,
                       1 if cmap else 0, len(cmap))
    return head + cmap + data


# ---- PNM, PFM, HDR ----------------------------------------------------------

def pnm_ascii(samples, kind, maxval=255, comment=True, packed=False):
    """P1, P2 or P3 of integer ``samples`` ([h, w] or [h, w, 3], RGB)."""
    h, w = samples.shape[:2]
    head = f"P{kind}\n" + ("# a comment\n" if comment else "") + f"{w} {h}\n"
    if kind != 1:
        head += f"{maxval}\n"
    flat = samples.reshape(h, -1)
    sep = "" if packed else " "
    body = "\n".join(sep.join(str(int(v)) for v in row) for row in flat)
    return (head + body + "\n").encode()


def pfm(values, big_endian=False, scale=1.0):
    """PFM of float ``values`` ([h, w] or [h, w, 3] RGB), rows bottom-up."""
    h, w = values.shape[:2]
    kind = "PF" if values.ndim == 3 else "Pf"
    s = scale if big_endian else -scale
    dt = ">f4" if big_endian else "<f4"
    return (f"{kind}\n{w} {h}\n{s}\n".encode()
            + np.ascontiguousarray(values[::-1]).astype(dt).tobytes())


def hdr(values, rle=True):
    """A Radiance HDR of float RGB ``values`` through cv2."""
    import cv2

    params = [] if rle else [cv2.IMWRITE_HDR_COMPRESSION,
                             cv2.IMWRITE_HDR_COMPRESSION_NONE]
    return _cv2(".hdr", np.ascontiguousarray(values[..., ::-1]), params)


# ---- TIFF -------------------------------------------------------------------

def _packbits(raw):
    out, i, n = bytearray(), 0, len(raw)
    while i < n:
        run = 1
        while i + run < n and run < 128 and raw[i + run] == raw[i]:
            run += 1
        if run >= 2:
            out += bytes((257 - run, raw[i]))
            i += run
        else:
            j = i
            while j < n and j - i < 128 and (j + 1 >= n
                                               or raw[j + 1] != raw[j]):
                j += 1
            j = max(j, i + 1)
            out += bytes((j - i - 1,)) + raw[i:j]
            i = j
    return bytes(out)


def tiff(samples, photometric=2, bits=8, planar=1, tile=None, compression=1,
         big_endian=False, colormap=None, rows_per_strip=None, predictor=1,
         extra=None):
    """A TIFF of ``samples`` ([h, w, spp] integers of ``bits`` bits, RGB
    order for photometric 2) in strips (``rows_per_strip``) or tiles (``tile``),
    chunky or planar, compression 1, 8 (Deflate) or 32773 (PackBits),
    predictor 2 applied here."""
    e = ">" if big_endian else "<"
    h, w, spp = samples.shape
    dt = np.dtype(e + ("u2" if bits == 16 else "u1"))

    def encode(block):  # block: [rows, cols, spp] -> bytes
        b = block.astype(np.int64)
        if predictor == 2:
            b = np.concatenate([b[:, :1], np.diff(b, axis=1)], 1) % (1 << bits)
        if bits not in (8, 16):  # MSB first, each row padded to a byte
            flat = b.reshape(b.shape[0], -1)
            shifts = np.arange(bits - 1, -1, -1)
            return b"".join(np.packbits((r[:, None] >> shifts) & 1).tobytes()
                            for r in flat)
        return b.astype(dt).tobytes()

    planes = [samples[..., k:k + 1] for k in range(spp)] if planar == 2 \
        else [samples]
    chunks = []
    for plane in planes:
        if tile:
            tw, th = tile
            for ty in range(0, h, th):
                for tx in range(0, w, tw):
                    blk = np.zeros((th, tw, plane.shape[2]), np.int64)
                    part = plane[ty:ty + th, tx:tx + tw]
                    blk[:part.shape[0], :part.shape[1]] = part
                    chunks.append(encode(blk))
        else:
            rps = rows_per_strip or h
            for y in range(0, h, rps):
                chunks.append(encode(plane[y:y + rps]))
    if compression == 8:
        chunks = [zlib.compress(c) for c in chunks]
    elif compression == 32773:
        chunks = [_packbits(c) for c in chunks]
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp),
            259: (3, [compression]), 262: (3, [photometric]),
            277: (3, [spp]), 284: (3, [planar])}
    if predictor != 1:
        tags[317] = (3, [predictor])
    if colormap is not None:
        tags[320] = (3, list(np.asarray(colormap, np.int64).T.reshape(-1)))
    if extra is not None:
        tags[338] = (3, [extra])
    body = bytearray(b"II*\x00" if not big_endian else b"MM\x00*")
    body += struct.pack(e + "I", 0)  # patched below
    offsets = []
    for c in chunks:
        offsets.append(len(body))
        body += c
        if len(body) & 1:
            body += b"\x00"
    counts = [len(c) for c in chunks]
    if tile:
        tags[322] = (3, [tile[0]])
        tags[323] = (3, [tile[1]])
        tags[324] = (4, offsets)
        tags[325] = (4, counts)
    else:
        tags[273] = (4, offsets)
        tags[278] = (4, [rows_per_strip or h])
        tags[279] = (4, counts)
    # out-of-line values, then the IFD
    entries = []
    for tag in sorted(tags):
        typ, vals = tags[tag]
        code = "H" if typ == 3 else "I"
        raw = struct.pack(e + code * len(vals), *vals)
        if len(raw) <= 4:
            entries.append((tag, typ, len(vals), raw.ljust(4, b"\x00")))
        else:
            off = len(body)
            body += raw
            entries.append((tag, typ, len(vals), struct.pack(e + "I", off)))
    if len(body) & 1:
        body += b"\x00"
    ifd = len(body)
    body += struct.pack(e + "H", len(entries))
    for tag, typ, count, val in entries:
        body += struct.pack(e + "HHI", tag, typ, count) + val
    body += struct.pack(e + "I", 0)
    body[4:8] = struct.pack(e + "I", ifd)
    return bytes(body)


# ---- GIF --------------------------------------------------------------------

def _gif_lzw(indices, m):
    """LZW codes that never grow the table past the first code width: a
    clear code every few literals (a valid stream any decoder reads)."""
    clear, width = 1 << m, m + 1
    room = (1 << width) - clear - 2 - 1
    codes = [clear]
    for k, v in enumerate(indices):
        if k and k % room == 0:
            codes.append(clear)
        codes.append(int(v))
    codes.append(clear + 1)
    acc = nacc = 0
    out = bytearray()
    for c in codes:
        acc |= c << nacc
        nacc += width
        while nacc >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nacc -= 8
    if nacc:
        out.append(acc)
    return bytes(out)


def gif(index, palette, screen=None, frame_at=(0, 0), background=0,
        transparent=None, local=False, interlace=False):
    """A GIF89a whose first frame is ``index`` (palette indices) at
    ``frame_at`` inside a ``screen`` (h, w), the BGR ``palette`` global or
    local."""
    fh, fw = index.shape
    sh, sw = screen or (fh, fw)
    n = len(palette)
    bits = max(1, int(np.ceil(np.log2(n))))
    pal = np.zeros((1 << bits, 3), np.uint8)
    pal[:n] = np.asarray(palette, np.uint8)[:, ::-1]  # BGR -> RGB
    out = bytearray(b"GIF89a")
    flags = (0x80 | (bits - 1)) if not local else 0
    out += struct.pack("<HHBBB", sw, sh, flags | 0x70, background, 0)
    if not local:
        out += pal.tobytes()
    if transparent is not None:
        out += b"\x21\xf9\x04" + struct.pack("<BHB", 1, 0, transparent) + \
            b"\x00"
    iflags = (0x80 | (bits - 1) if local else 0) | (0x40 if interlace else 0)
    out += b"\x2c" + struct.pack("<HHHHB", frame_at[1], frame_at[0], fw, fh,
                                 iflags)
    if local:
        out += pal.tobytes()
    rows = index
    if interlace:
        order = np.concatenate([np.arange(0, fh, 8), np.arange(4, fh, 8),
                                np.arange(2, fh, 4), np.arange(1, fh, 2)])
        rows = index[order]
    m = max(2, bits)
    data = _gif_lzw(rows.reshape(-1), m)
    out.append(m)
    for i in range(0, len(data), 255):
        chunk = data[i:i + 255]
        out += bytes((len(chunk),)) + chunk
    out += b"\x00\x3b"
    return bytes(out)


# ---- the cases --------------------------------------------------------------

def _exif(orientation):
    from PIL import Image

    ex = Image.Exif()
    ex[0x0112] = orientation
    return ex.tobytes()


def cases(seed=0, h=48, w=64):
    """{format: [(name, bytes), ...]} of the CPU tests' cases."""
    from PIL import Image  # noqa: F401  (PIL writes several of them)

    rng = np.random.default_rng(seed)
    img = noise(h, w, seed)
    sm = smooth(h, w, seed)
    rgba = np.dstack([sm[..., ::-1], rng.integers(0, 256, (h, w), np.uint8)])
    pal = rng.integers(0, 256, (256, 3), np.uint8)
    idx8 = rng.integers(0, 256, (h, w))
    runs = np.repeat(rng.integers(0, 16, (h, w // 8)), 8, axis=1)
    out = {}
    small = sm[:32, :32]
    out["webp"] = [
        ("lossy_q90", _pil(small[..., ::-1], "WEBP", quality=90)),
        ("lossy_q30_noise", _pil(img[:32, :32, ::-1], "WEBP", quality=30)),
        ("lossy_odd", _pil(sm[:17, :23, ::-1], "WEBP", quality=70)),
        ("lossy_alpha", _pil(rgba[:32, :32], "WEBP", quality=90)),
        ("lossy_exif6", _pil(small[:24, ..., ::-1], "WEBP", quality=90,
                             exif=_exif(6))),
        ("lossy_cv2", _cv2(".webp", sm[:32, :24], [0x40, 90])),
        ("lossless_noise", _pil(img[..., ::-1], "WEBP", lossless=True)),
        ("lossless_smooth", _pil(sm[..., ::-1], "WEBP", lossless=True,
                                 method=6)),
        ("lossless_alpha", _pil(rgba, "WEBP", lossless=True)),
        ("lossless_palette", _pil(pal[:20][rng.integers(0, 20, (h, w))],
                                  "WEBP", lossless=True)),
        ("lossless_4colors", _pil(pal[:3][rng.integers(0, 3, (h, w))],
                                  "WEBP", lossless=True)),
        ("lossless_exif3", _pil(sm[..., ::-1], "WEBP", lossless=True,
                                exif=_exif(3))),
        ("lossless_cv2", _cv2(".webp", sm, [0x40, 101])),
    ]
    out["bmp"] = [
        ("bgr24", _cv2(".bmp", img)),
        ("gray8", _cv2(".bmp", img[..., 0])),
        ("pal1", bmp(bpp=1, index=idx8 & 1, palette=pal[:2])),
        ("pal4", bmp(bpp=4, index=idx8 & 15, palette=pal[:16])),
        ("pal8_short", bmp(bpp=8, index=idx8 % 200, palette=pal[:180])),
        ("bgr24_topdown", bmp(img, 24, top_down=True)),
        ("bgrx32", bmp(img, 32)),
        ("bgra32_v5", bmp(img, 32, header=124)),
        ("rgb555", bmp(img, 16)),
        ("rgb565", bmp(img, 16, bitfields=(0xF800, 0x7E0, 0x1F))),
        ("core8", bmp(bpp=8, index=idx8, palette=pal, header=12)),
        ("rle8", bmp(bpp=8, rle=True, index=runs, palette=pal[:16])),
        ("rle4", bmp(bpp=4, rle=True, index=runs, palette=pal[:16])),
        ("rle8_topdown", bmp(bpp=8, rle=True, index=runs, palette=pal[:16],
                             top_down=True)),
        ("pil_rgba", _pil(rgba, "BMP")),
    ]
    s16 = rng.integers(0, 65536, (h, w, 3))
    fl = (rng.random((h, w, 3)) * 300 - 20).astype(np.float32)
    out["pnm"] = [
        ("p1", pnm_ascii(idx8 & 1, 1)),
        ("p1_packed", pnm_ascii(idx8[:8] & 1, 1, packed=True)),
        ("p2_255", pnm_ascii(idx8, 2)),
        ("p2_100", pnm_ascii(idx8 % 101, 2, maxval=100)),
        ("p2_65535", pnm_ascii(s16[..., 0], 2, maxval=65535)),
        ("p3_255", pnm_ascii(img[..., ::-1], 3)),
        ("p3_65535", pnm_ascii(s16, 3, maxval=65535)),
        ("p4", _cv2(".pbm", (img[..., 0] > 128).astype(np.uint8) * 255)),
        ("p5_255", _cv2(".pgm", img[..., 0])),
        ("p5_65535", _cv2(".pgm", s16[..., 0].astype(np.uint16))),
        ("p6_255", _cv2(".ppm", img)),
        ("p6_65535", _cv2(".ppm", s16.astype(np.uint16))),
        ("pfm_le", pfm(fl)),
        ("pfm_be", pfm(fl, big_endian=True)),
        ("pfm_scale3", pfm(fl, scale=3.0)),
        ("pfm_gray", pfm(fl[..., 0])),
    ]
    out["sunras"] = [
        ("bgr24", _cv2(".sr", img)),
        ("gray8", _cv2(".sr", img[..., 0])),
        ("odd_bgr24", sunras(img[:, :33], 24)),
        ("xbgr32", sunras(img, 32)),
        ("map8", sunras(depth=8, index=idx8 % 200, palette=pal[:200])),
        ("map1", sunras(depth=1, index=idx8 & 1, palette=pal[:2])),
        ("gray1", sunras(depth=1, index=idx8 & 1)),
    ]
    hv = (rng.random((h, w, 3)) * 2).astype(np.float32)
    hv[:4] *= 1e-3
    hv[4:8] = 0
    out["hdr"] = [
        ("rle", hdr(hv)),
        ("flat", hdr(hv, rle=False)),
        ("narrow_rle", hdr(hv[:, :7])),
    ]
    gidx = rng.integers(0, 200, (h, w))
    out["gif"] = [
        ("pil", _pil(pal[gidx][..., ::-1], "GIF")),
        ("pil_interlaced", _pil(pal[gidx][..., ::-1], "GIF",
                                interlace=True)),
        ("transparent", gif(gidx, pal[:200], transparent=3, background=7)),
        ("interlaced", gif(gidx, pal[:200], interlace=True)),
        ("frame_inside", gif(gidx[:20, :30], pal[:200], screen=(h, w),
                             frame_at=(5, 9), background=4, transparent=2)),
        ("local_palette", gif(gidx % 16, pal[:16], local=True)),
        ("cv2", _cv2(".gif", img)),
    ]
    g16 = rng.integers(0, 65536, (h, w, 1))
    rgb = img[..., ::-1]
    cmap = (pal.astype(np.int64) * 257)[:, ::-1]  # RGB, 16-bit
    out["tiff"] = [
        ("none", _pil(rgb, "TIFF")),
        ("lzw", _pil(rgb, "TIFF", compression="tiff_lzw")),
        ("deflate", _pil(rgb, "TIFF", compression="tiff_adobe_deflate")),
        ("packbits", _pil(rgb, "TIFF", compression="packbits")),
        ("lzw_pred2", _pil(sm[..., ::-1], "TIFF", compression="tiff_lzw",
                           tiffinfo={317: 2})),
        ("gray_lzw_pred2", _pil(sm[..., 0], "TIFF", compression="tiff_lzw",
                                tiffinfo={317: 2})),
        ("gray", _pil(img[..., 0], "TIFF")),
        ("bilevel", _pil(img[..., 0], "TIFF", mode="1")),
        ("palette", _pil(rgb, "TIFF", mode="P")),
        ("rgba", _pil(rgba, "TIFF")),
        ("gray16", _pil(g16[..., 0].astype(np.uint16), "TIFF")),
        ("rgb16_cv2_lzw", _cv2(".tiff", s16.astype(np.uint16), [259, 5])),
        ("pred2_16_deflate", tiff(s16, bits=16, compression=8, predictor=2)),
        ("gray16_pred2_be", tiff(g16, photometric=1, bits=16, predictor=2,
                                 compression=8, big_endian=True)),
        ("planar2", tiff(rgb, planar=2, rows_per_strip=7)),
        ("planar2_packbits", tiff(rgb, planar=2, compression=32773)),
        ("tiles_deflate", tiff(rgb, tile=(16, 32), compression=8)),
        ("tiles_planar_pred2", tiff(rgb, tile=(32, 16), planar=2,
                                    compression=8, predictor=2)),
        ("miniswhite8", tiff(idx8[..., None], photometric=0)),
        ("miniswhite1", tiff(idx8[..., None] & 1, photometric=0, bits=1)),
        ("palette4_be", tiff(idx8[..., None] & 15, photometric=3, bits=4,
                             colormap=cmap[:16], big_endian=True)),
        ("gray8_strips", tiff(idx8[..., None], photometric=1,
                              rows_per_strip=5)),
    ]
    return out


def big(fmt, seed=0, h=480, w=640):
    """One 480 x 640 image of a format, smooth and posterised so that it
    codes small: (name, bytes)."""
    sm = smooth(h, w, seed, levels=16)
    rgb = sm[..., ::-1]
    if fmt == "webp_lossy":
        return "big_lossy", _pil(rgb, "WEBP", quality=85)
    if fmt == "webp_lossless":
        return "big_lossless", _pil(rgb, "WEBP", lossless=True)
    if fmt == "gif":
        return "big", _pil(rgb, "GIF")
    if fmt == "tiff":
        return "big_lzw_pred2", _pil(rgb, "TIFF", compression="tiff_lzw",
                                     tiffinfo={317: 2})
    if fmt == "bmp":
        from PIL import Image

        p = Image.fromarray(rgb).quantize(64)
        pal = np.asarray(p.getpalette()[:192], np.uint8).reshape(-1, 3)
        return "big_rle8", bmp(bpp=8, rle=True, index=np.asarray(p),
                               palette=pal[:, ::-1])
    if fmt == "pnm":
        return "big_p4", _cv2(".pbm", (sm[..., 1] > 128).astype(np.uint8)
                              * 255)
    if fmt == "sunras":
        return "big_map8", sunras(depth=8, index=sm[..., 1] // 16,
                                  palette=smooth(16, 1, seed)[:, 0])
    if fmt == "hdr":
        return "big_rle", hdr(sm[..., ::-1].astype(np.float32) / 255)
    raise KeyError(fmt)


BIG_FORMATS = ("webp_lossy", "webp_lossless", "gif", "tiff", "bmp", "pnm",
               "sunras", "hdr")


def big_textured(fmt, seed=0, h=480, w=640):
    """One 480 x 640 ``textured`` image of a format whose decode time
    follows its coded size: (name, bytes).  Lossy WebP at quality 75 codes
    a photograph's spectrum (beta 1.2) to about a photograph's size; the
    lossless WebP and the LZW TIFF take a smoother one (beta 2) so that
    the fixtures stay small, and still code to 7-14x their posterised
    ``big`` twins."""
    if fmt == "webp_lossy":
        return "big_textured", _pil(textured(h, w, seed)[..., ::-1], "WEBP",
                                    quality=75)
    rgb = textured(h, w, seed, beta=2.0)[..., ::-1]
    if fmt == "webp_lossless":
        return "big_textured", _pil(rgb, "WEBP", lossless=True)
    if fmt == "tiff":
        return "big_textured", _pil(rgb, "TIFF", compression="tiff_lzw",
                                    tiffinfo={317: 2})
    raise KeyError(fmt)


TEXTURED_FORMATS = ("webp_lossy", "webp_lossless", "tiff")


def vp8_wavefront_replay(fr, reverse=False):
    """BGR uint8 [h, w, 3] of a parsed VP8 frame (``vp8.Vp8Frame``) from the
    plain per-macroblock steps of ``data/vp8.py`` run in the card kernel's
    schedule (``csrc/vp8.cu``): step t reconstructs the macroblocks of
    diagonal t = x + 2 y, predicting only from saved unfiltered edges (a
    column's bottom row, a row's right column and its corner), and filters
    diagonal t - 1 in the frame.  ``reverse`` runs each step's filters
    before its reconstructions and each diagonal's macroblocks bottom row
    first: the result must not change, as the kernel runs them at once."""
    from simvg_tpu_torch.data import vp8

    mb_w, mb_h = fr.mb_w, fr.mb_h
    planes = [np.zeros((16 * mb_h, 16 * mb_w), np.uint8)] + [
        np.zeros((8 * mb_h, 8 * mb_w), np.uint8) for _ in range(2)]
    # per plane: the bottom rows of the row above, the right columns and
    # corners of each row; 127 above the frame, 129 left of it
    top = [np.full((mb_w, s), 127, np.int64) for s in (16, 8, 8)]
    left = [np.full((mb_h, s), 129, np.int64) for s in (16, 8, 8)]
    corner = [np.where(np.arange(mb_h) == 0, 127, 129) for _ in range(3)]

    def work_buffer(p, mx, my, size, right):
        ws = np.zeros((size + 1, size + 1 + right), np.int64)
        ws[0, 0] = corner[p][my]
        ws[0, 1:size + 1] = top[p][mx]
        if right:
            ws[0, size + 1:] = top[0][mx + 1, :4] if mx < mb_w - 1 \
                else top[0][mx, 15]
        ws[1:, 0] = left[p][my]
        return ws

    def reconstruct(mx, my):
        idx = my * mb_w + mx
        row = fr.info[idx]
        co = vp8._dequant(fr, idx)
        ws = work_buffer(0, mx, my, 16, 4)
        if row[vp8.I4X4]:
            for r in (4, 8, 12):
                ws[r, 17:21] = ws[0, 17:21]
            ws = ws.tolist()
            for n in range(16):
                by, bx = n >> 2, n & 3
                p = vp8._pred4(int(row[vp8.MODES + n]),
                               ws[4 * by][4 * bx + 1:4 * bx + 9],
                               [ws[4 * by + 1 + k][4 * bx] for k in range(4)],
                               ws[4 * by][4 * bx])
                vp8._idct_add(co[n], p)
                for k in range(4):
                    ws[4 * by + 1 + k][4 * bx + 1:4 * bx + 5] = p[k]
            blocks = [np.asarray(ws, np.int64)[1:17, 1:17]]
        else:
            blk = vp8._pred_block(int(row[vp8.MODES]), 16, ws[0, 1:17],
                                  ws[1:17, 0], ws[0, 0], mx, my).tolist()
            for n in range(16):
                by, bx = n >> 2, n & 3
                sub = [r[4 * bx:4 * bx + 4] for r in blk[4 * by:4 * by + 4]]
                vp8._idct_add(co[n], sub)
                for k in range(4):
                    blk[4 * by + k][4 * bx:4 * bx + 4] = sub[k]
            blocks = [np.asarray(blk, np.int64)]
        tops = [ws[0][16] if isinstance(ws, list) else ws[0, 16]]
        for ch in range(2):
            wc = work_buffer(1 + ch, mx, my, 8, 0)
            blk = vp8._pred_block(int(row[vp8.UVMODE]), 8, wc[0, 1:9],
                                  wc[1:9, 0], wc[0, 0], mx, my).tolist()
            for n in range(4):
                by, bx = n >> 1, n & 1
                sub = [r[4 * bx:4 * bx + 4] for r in blk[4 * by:4 * by + 4]]
                vp8._idct_add(co[16 + 4 * ch + n], sub)
                for k in range(4):
                    blk[4 * by + k][4 * bx:4 * bx + 4] = sub[k]
            blocks.append(np.asarray(blk, np.int64))
            tops.append(wc[0, 8])
        for p, (blk, size) in enumerate(zip(blocks, (16, 8, 8))):
            planes[p][size * my:size * my + size,
                      size * mx:size * mx + size] = blk
            corner[p][my] = tops[p]  # the next macroblock's corner
            top[p][mx] = blk[-1]
            left[p][my] = blk[:, -1]

    def loop_filter(mx, my):
        row = fr.info[my * mb_w + mx]
        limit, il, hev, inner = (int(row[k]) for k in (
            vp8.LIMIT, vp8.ILEVEL, vp8.HEV, vp8.INNER))
        if limit == 0:
            return
        simple = fr.filter_type == 1
        for vertical in (True, False):
            for p, size in ((0, 16),) + (() if simple else ((1, 8), (2, 8))):
                y0, x0 = size * my, size * mx
                at = x0 if vertical else y0
                span = slice(y0, y0 + size) if vertical \
                    else slice(x0, x0 + size)
                if (mx if vertical else my) > 0:
                    vp8._edge(planes[p], at, span, vertical, simple,
                              limit + 4, il, hev, True)
                if inner:
                    for k in range(4, size, 4):
                        vp8._edge(planes[p], at + k, span, vertical, simple,
                                  limit, il, hev, False)

    def diagonal(t):
        rows = [my for my in range(mb_h) if 0 <= t - 2 * my < mb_w]
        return [(t - 2 * my, my) for my in (rows[::-1] if reverse else rows)]

    diags = mb_w + 2 * (mb_h - 1)
    for t in range(diags + 1):
        work = [(reconstruct, diagonal(t))]
        if fr.filter_type:
            work.append((loop_filter, diagonal(t - 1)))
        for fn, mbs in (work[::-1] if reverse else work):
            for mx, my in mbs:
                fn(mx, my)
    return vp8.to_bgr_reference(*planes, fr.width, fr.height)
