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


# ---- the predictor kernels' schedules (csrc/vp8l.cu, csrc/image_convert.cu)

# csrc/vp8l.cu's kSlots (kCluster x kBlockWarps) and kWideRing (the widths
# up to which its rings lie in shared memory, in device memory past them)
VP8L_SLOTS, VP8L_WIDE_RING = 16, 4096
_BLACK = np.uint32(0xFF000000)


def _avg2(a, b):
    return (((a ^ b) & np.uint32(0xFEFEFEFE)) >> 1) + (a & b)


def _clamp_fields(v):
    """The kernel's 16-bit fields v (in [0, 1023], standing for v - 256)
    clamped to [0, 255]."""
    over = (v >> 9) & np.uint32(0x00010001)
    under = (((v >> 8) | (v >> 9)) & np.uint32(0x00010001)) \
        ^ np.uint32(0x00010001)
    return ((v & np.uint32(0x00FF00FF)) | (over * np.uint32(0xFF))) \
        & ~(under * np.uint32(0xFF))


def _half_fields(a, b):
    d = a + np.uint32(0x02000200) - b
    neg = (~d >> 9) & np.uint32(0x00010001)
    return a + (((d + neg) >> 1) & np.uint32(0x7FFF7FFF))


def _sad4(a, b):
    s = np.zeros(a.shape, np.int64)
    for k in (0, 8, 16, 24):
        s += np.abs(((a >> k) & 255).astype(np.int64)
                    - ((b >> k) & 255).astype(np.int64))
    return s


# csrc/vp8l.cu's operands of modes 1-10, avg2(avg2(P, Q), avg2(R, S)):
# two bits an operand (0 L, 1 T, 2 TL, 3 TR), P lowest, a byte a mode
VP8L_OPERANDS = 0xD8DD6644885CAAFF550000
_VP8L_OPS = np.array([(VP8L_OPERANDS >> (8 * m)) & 255 for m in range(16)],
                     np.int64)


def vp8l_predict_simd(mode, l, t, tl, tr, present=0xFFFF):
    """The kernel's prediction (``predict`` in csrc/vp8l.cu) of uint32
    arrays of packed ARGB words, each element with its own mode: modes
    1-10 through their operands, 11-13 as SIMD-in-a-word clamps, the rest
    black; ``present``: the modes the warp needs (a bit each; an array
    that broadcasts against ``mode`` gives each warp its own), the parts
    of the others skipped as the kernel skips them."""
    e = np.uint32(0x00FF00FF)
    mode = np.asarray(mode, np.int64)
    present = np.asarray(present, np.int64)
    ops = _VP8L_OPS[mode]

    def pick(c):
        return np.where(c & 2, np.where(c & 1, tr, tl),
                        np.where(c & 1, t, l)).astype(np.uint32)

    p = pick(ops)
    averages, clamps = present & 0x7E0, present & 0x3800
    if averages.any():
        p = np.where(averages != 0, _avg2(
            _avg2(p, pick(ops >> 2)), _avg2(pick(ops >> 4), pick(ops >> 6))), p)
    if clamps.any():
        m11 = np.where(_sad4(l, tl) - _sad4(t, tl) <= 0, t, l)
        m12 = _clamp_fields((l & e) + (t & e) + np.uint32(0x01000100)
                            - (tl & e)) \
            | (_clamp_fields(((l >> 8) & e) + ((t >> 8) & e)
                             + np.uint32(0x01000100) - ((tl >> 8) & e)) << 8)
        m7 = _avg2(l, t)
        m13 = _clamp_fields(_half_fields(m7 & e, tl & e)) \
            | (_clamp_fields(_half_fields((m7 >> 8) & e, (tl >> 8) & e)) << 8)
        p = np.where(clamps == 0, p, np.where(mode == 11, m11, np.where(
            mode == 12, m12, np.where(mode == 13, m13, p))))
    return np.where((mode >= 1) & (mode <= 13), p, _BLACK).astype(np.uint32)


def vp8l_predictor_replay(res, w, h, bits, tiles):
    """The predictor transform undone in csrc/vp8l.cu's schedule: row group
    g (32 rows, a lane a row) on slot g % VP8L_SLOTS; lane l undoes pixel x
    at step x + 2 l from its left pixel, the row above's pixels x + 1, x and
    x - 1 as lane l - 1 made them one, two and three steps before (lane 0:
    from the ring that lane 31 of the slot before fills, with the kernel's
    sequence numbers: a slot a pixel of the row at every width, with no
    flow control); the rightmost column's top-right from the lane's
    register; the mode switched as the pixel starts a tile; the prediction
    ``vp8l_predict_simd`` with only the families some lane of the warp
    needs.  The slots run in rounds, all at once ([slot, lane] arrays):
    in a round each slot whose ring entries have come takes a step, the
    others wait where the kernel's warp would poll; a round's hand-overs
    are seen in the next.  A slot whose entry was overwritten by the next
    round's writer before it took it would wait for ever, and the replay
    raises.  ``res``: uint32 [h * w]; ``tiles``: the sub-image's words
    [th * tw].  Returns uint32 [h * w]."""
    res = np.asarray(res, np.uint32)
    tiles = np.asarray(tiles, np.uint32)
    tw = (w + (1 << bits) - 1) >> bits
    total = w * h
    out = np.full(total, 0x5A5A5A5A, np.uint32)  # every pixel is written
    groups = (h + 31) >> 5
    n = VP8L_SLOTS
    # slot k's ring is rings[k, :w]; column w is never written
    rings = np.zeros((n, w + 1), np.uint64)
    lanes, slots = np.arange(32), np.arange(n)
    g = slots.copy()  # each slot's row group, and its step in the group
    s = np.zeros(n, np.int64)
    shape = (n, 32)
    r, row, mrow = (np.zeros(shape, np.int64) for _ in range(3))
    mode = np.zeros(shape, np.int64)
    tr, t, tl, up, left, first, mnext = (np.zeros(shape, np.uint32)
                                         for _ in range(7))

    def start(sel):  # the slots `sel` begin their group g
        rr = 32 * g[sel, None] + lanes
        hr = np.minimum(rr, h - 1)
        r[sel], row[sel], mrow[sel] = rr, hr * w, (hr >> bits) * tw
        mode[sel] = (tiles[mrow[sel]] >> 8) & 15
        mnext[sel] = tiles[mrow[sel] + 1] if tw > 1 else 0
        for a in (tr, t, tl, up, left, first):
            a[sel] = 0
        s[sel] = 0

    start(g < groups)
    while (g < groups).any():
        live = g < groups
        seq, seq_next = (g // n) * w, ((g + 1) // n) * w
        # lane 0's entries: 0 before the group's first step, s + 1 at step s
        need0 = live & (g > 0) & (s == 0)
        need1 = live & (g > 0) & (s + 1 < w)
        u1 = np.minimum(s + 1, w)
        e0, e1 = rings[slots, 0], rings[slots, u1]
        tag0, tag1 = (e0 >> 32).astype(np.int64), (e1 >> 32).astype(np.int64)
        go = live & (~need0 | (tag0 == seq + 1)) & (~need1 | (tag1 == seq + u1 + 1))
        if not go.any():
            raise RuntimeError("the predictor's slots wait on each other")
        G = go[:, None]
        tr0 = tr.copy()
        tr0[:, 0] = np.where(need0, (e0 & 0xFFFFFFFF).astype(np.uint32), tr[:, 0])
        tl_n, t_n = t, tr0
        tr_n = up.copy()
        tr_n[:, 0] = np.where(need1, (e1 & 0xFFFFFFFF).astype(np.uint32), 0)
        x = s[:, None] - 2 * lanes
        active = r < h
        mine = active & (x >= 0) & (x < w)
        resid = res[np.clip(row + x, 0, total - 1)]
        tile = mine & (x > 0) & ((x & ((1 << bits) - 1)) == 0)
        mode_n = np.where(tile, (mnext >> 8) & 15, mode)
        has = tile & ((x >> bits) + 1 < tw)
        mnext_n = np.where(has, tiles[np.clip(
            mrow + (x >> bits) + 1, 0, len(tiles) - 1)], mnext)
        top_row = r == 0
        edge = top_row | (x == 0)
        present = np.bitwise_or.reduce(
            np.where(mine & ~edge, 1 << mode_n, 0), axis=1)
        p = vp8l_predict_simd(mode_n, left, t_n, tl_n,
                              np.where(x + 1 < w, tr_n, first), present[:, None])
        pred = np.where(edge, np.where(top_row, np.where(
            x == 0, _BLACK, left), t_n), p).astype(np.uint32)
        o = ((((resid & 0xFF00FF00) + (pred & 0xFF00FF00)) & 0xFF00FF00)
             | (((resid & 0x00FF00FF) + (pred & 0x00FF00FF)) & 0x00FF00FF)
             ).astype(np.uint32)
        wrote = mine & G
        out[(row + x)[wrote]] = o[wrote]
        # lane 31's pixel s - 62 to the next slot's ring
        u31 = s - 62
        hand = go & (g + 1 < groups) & (u31 >= 0) & (u31 < w)
        rings[(slots[hand] + 1) % n, u31[hand]] = \
            ((seq_next[hand] + u31[hand] + 1).astype(np.uint64) << 32) \
            | o[hand, 31].astype(np.uint64)
        for a, v in ((tl, tl_n), (t, t_n), (tr, tr_n), (mode, mode_n),
                     (mnext, mnext_n), (left, np.where(mine, o, left)),
                     (first, np.where(mine & (x == 0), o, first)),
                     (up, np.concatenate([o[:, :1], o[:, :-1]], axis=1))):
            a[:] = np.where(G, v, a)  # __shfl_up_sync, the last
        s += go
        done = go & (s == w + 62)
        g[done] += n
        start(done & (g < groups))
    return out


# VP8L predictor cases: (label, width, height, bits, tile modes or None for
# random ones); every mode in every tile position comes from the
# ``modes_cycle`` images (tile i takes mode (i + k) % 16 over k)
def vp8l_predictor_cases():
    cases = []
    for w, h, bits in ((1, 1, 2), (2, 31, 2), (3, 32, 2), (5, 33, 2),
                       (7, 33, 3), (9, 40, 3), (15, 31, 4), (17, 33, 4),
                       (31, 32, 5), (33, 33, 5), (63, 20, 6), (65, 33, 6),
                       (127, 9, 7), (129, 31, 7), (255, 5, 8), (257, 33, 8),
                       (511, 3, 9), (513, 33, 9), (640, 33, 2),
                       (VP8L_WIDE_RING + 1, 33, 9),
                       (40, VP8L_SLOTS * 32 + 1, 2),
                       # rings in device memory, each slot's ring refilled
                       # by the next round (slot 15 feeds slot 0)
                       (8192, VP8L_SLOTS * 32 + 1, 9), (16384, 600, 9)):
        cases.append((f"{w}x{h}_bits{bits}", w, h, bits, None))
    for k in range(16):
        cases.append((f"modes_cycle{k}", 21, 40, 2, k))
    return cases


def vp8l_predictor_input(w, h, bits, modes, seed=0):
    """(residuals uint32 [h * w], the sub-image's words) of a case: random
    residuals from ``seed``; tile modes random (``modes`` None) or tile i's
    mode (i + modes) % 16; the words' other bits random."""
    rng = np.random.default_rng(seed)
    tw, th = (w + (1 << bits) - 1) >> bits, (h + (1 << bits) - 1) >> bits
    res = rng.integers(0, 1 << 32, w * h, dtype=np.uint64).astype(np.uint32)
    m = rng.integers(0, 16, tw * th) if modes is None \
        else (np.arange(tw * th) + modes) % 16
    words = rng.integers(0, 1 << 32, tw * th, dtype=np.uint64) \
        .astype(np.uint32) & np.uint32(0xFFFFF0FF)
    return res, words | (m.astype(np.uint32) << 8)


# csrc/image_convert.cu's register route: kLaneBytes a lane's run at most,
# kMaxSpp samples a pixel; kStrideRun pixels a lane on the strided route
TIFF_LANE_BYTES, TIFF_MAX_SPP, TIFF_STRIDE_RUN, TIFF_WARPS = 64, 8, 8, 8


def tiff_predictor_replay(data, segments, seg_bytes, count, spp, bits,
                          big_endian):
    """TIFF's predictor 2 undone in csrc/image_convert.cu's chunked scans.
    The register route (spp <= TIFF_MAX_SPP): a segment in passes of 32
    runs of whole pixels, a lane a run (TIFF_LANE_BYTES), its sums
    scanned across the warp, passes dealt to ``wps`` warps a round (enough
    for the passes, up to TIFF_WARPS) and each round's sums scanned across
    them, a carry from round to round; the strided route: a warp a
    (segment, sample), runs of TIFF_STRIDE_RUN pixels, a carry from pass to
    pass.  Only the segments' pixel bytes are written.  Returns the
    bytes."""
    buf = np.frombuffer(data, np.uint8).copy()
    n = bits // 8
    mod = (1 << bits) - 1

    def get(at):
        b = buf[at:at + n].astype(np.int64)
        return int(b[0]) if n == 1 else int(
            (b[0] << 8 | b[1]) if big_endian else (b[0] | b[1] << 8))

    def put(at, v):
        v &= mod
        if n == 1:
            buf[at] = v
        else:
            buf[at:at + 2] = (v >> 8, v & 255) if big_endian \
                else (v & 255, v >> 8)

    def warp_exclusive(sums):  # __shfl_up_sync's scan: before each lane
        return np.concatenate([[0], np.cumsum(sums)[:-1]]), int(sums.sum())

    pb = spp * n
    for seg in range(segments):
        base = seg * seg_bytes
        if spp > TIFF_MAX_SPP:
            for c in range(spp):
                carry = 0
                for px0 in range(0, count, 32 * TIFF_STRIDE_RUN):
                    runs = []
                    for lane in range(32):
                        mine = [px for px in range(
                            px0 + lane * TIFF_STRIDE_RUN,
                            px0 + (lane + 1) * TIFF_STRIDE_RUN) if px < count]
                        vals = np.cumsum([get(base + px * pb + c * n)
                                          for px in mine]).tolist()
                        runs.append((mine, vals))
                    before, total = warp_exclusive(np.asarray(
                        [v[-1] if v else 0 for _, v in runs], np.int64))
                    for (mine, vals), b in zip(runs, before):
                        for px, v in zip(mine, vals):
                            put(base + px * pb + c * n, v + b + carry)
                    carry += total
            continue
        run = TIFF_LANE_BYTES // pb
        pass_px = 32 * run
        passes = -(-count // pass_px)
        wps = 1
        while wps < TIFF_WARPS and wps < passes:
            wps *= 2
        carry = np.zeros(spp, np.int64)
        for r0 in range(0, passes, wps):
            work = []
            for part in range(wps):  # the round's warps
                px0 = (r0 + part) * pass_px
                lanes = []
                for lane in range(32):
                    mine = [px for px in range(px0 + lane * run,
                                               px0 + (lane + 1) * run)
                            if px < count]
                    acc = np.zeros(spp, np.int64)
                    for px in mine:  # the run summed in place
                        for c in range(spp):
                            acc[c] += get(base + px * pb + c * n)
                            put(base + px * pb + c * n, int(acc[c]))
                    lanes.append((mine, acc))
                sums = np.stack([a for _, a in lanes])
                before = np.concatenate([np.zeros((1, spp), np.int64),
                                         np.cumsum(sums, 0)[:-1]])
                work.append((lanes, before, sums.sum(0)))
            pass_sums = [s for _, _, s in work]
            for part, (lanes, before, _) in enumerate(work):
                earlier = carry + sum(pass_sums[:part])
                for (mine, _), b in zip(lanes, before):
                    for px in mine:
                        for c in range(spp):
                            at = base + px * pb + c * n
                            put(at, get(at) + int(b[c] + earlier[c]))
            carry = carry + sum(pass_sums)
    return buf.tobytes()


# TIFF predictor cases: (spp, bits, big_endian, count, padding bytes a
# segment); spp 1-5, the register route's last and the strided route's
# first, 8 and 16 bits, both byte orders, counts around a warp and past a
# pass (RGB at 8 bits: 672 pixels a pass; gray at 16 bits: 1,024)
TIFF_PREDICTOR_CASES = tuple(
    (spp, bits, be, count, pad)
    for spp in (1, 2, 3, 4, 5, TIFF_MAX_SPP, TIFF_MAX_SPP + 1)
    for bits, be in ((8, False), (16, False), (16, True))
    for count, pad in ((1, 0), (31, 3), (32, 0), (33, 1))) + (
    (3, 8, False, 640, 0), (3, 8, False, 673, 5), (1, 16, True, 1025, 2),
    (3, 16, False, 2700, 0), (4, 8, False, 9000, 3), (9, 8, False, 300, 1))


def tiff_predictor_input(spp, bits, count, pad, segments=5, seed=0):
    """(bytes, segments, seg_bytes) of a case: random samples, ``pad``
    random bytes after each segment's pixels and 3 after the last
    segment."""
    rng = np.random.default_rng(seed)
    seg_bytes = count * spp * (bits // 8) + pad
    data = rng.integers(0, 256, segments * seg_bytes + 3, dtype=np.uint8)
    return data.tobytes(), segments, seg_bytes
