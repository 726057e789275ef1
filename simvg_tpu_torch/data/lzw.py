"""LZW as GIF and TIFF code it: the plain versions of the host stage whose
card route is ``simvg_lzw_decode`` in ``csrc/image_convert.cu`` (host
C++, as sequential as the format).

- GIF: codes packed least significant bit first, a minimum code size m
  (clear = 1 << m, end = clear + 1, codes of m + 1 bits at the start), the
  width growing when the next free code reaches 1 << width, at most 12
  bits; a full table stays as it is until a clear code.
- TIFF: codes packed most significant bit first, clear 256 and end 257,
  9 bits at the start, the width growing one code early (at 511, 1023 and
  2047: libtiff's "early change"), at most 12 bits.

A code past the next free one is an error; a stream that ends without an
end code gives what it decoded (the callers check the length).
"""

from __future__ import annotations

import torch

GIF, TIFF = 0, 1


def decode_reference(data: bytes, kind: int, min_code_size: int = 8,
                     limit: int = -1) -> bytes:
    """The decoded bytes of an LZW stream, at most ``limit`` of them
    (all when negative)."""
    if kind == GIF:
        if not 1 <= min_code_size <= 11:
            raise ValueError(f"GIF LZW minimum code size {min_code_size}")
        clear = 1 << min_code_size
    else:
        clear = 256
    end, early = clear + 1, int(kind == TIFF)
    width0 = width = clear.bit_length()  # m + 1 bits; 9 for TIFF
    init = [bytes((i,)) for i in range(clear)] + [b"", b""]
    table = list(init)
    out, total = [], 0
    prev = None
    acc = nacc = pos = 0
    n = len(data)
    while True:
        while nacc < width and pos < n:
            if kind == GIF:
                acc |= data[pos] << nacc
            else:
                acc = (acc << 8) | data[pos]
            nacc += 8
            pos += 1
        if nacc < width:
            break
        if kind == GIF:
            code = acc & ((1 << width) - 1)
            acc >>= width
        else:
            code = (acc >> (nacc - width)) & ((1 << width) - 1)
            acc &= (1 << (nacc - width)) - 1
        nacc -= width
        if code == clear:
            table = list(init)
            width = width0
            prev = None
            continue
        if code == end:
            break
        if prev is None:
            if code >= clear:
                raise ValueError("LZW stream starts with an undefined code")
            entry = table[code]
        else:
            if code < len(table):
                entry = table[code]
                new = prev + entry[:1]
            elif code == len(table):
                entry = new = prev + prev[:1]
            else:
                raise ValueError("LZW code past the table")
            if len(table) < 4096:
                table.append(new)
        out.append(entry)
        total += len(entry)
        if 0 <= limit <= total:
            break
        prev = entry
        if len(table) + early >= (1 << width) and width < 12:
            width += 1
    data = b"".join(out)
    return data if limit < 0 else data[:limit]


def decode_host(data: bytes, kind: int, min_code_size: int = 8,
                limit: int = -1) -> bytes:
    """``decode_reference``'s result from the card route's host C++
    (``csrc/image_convert.cu``); ``limit`` must be given."""
    import ctypes

    from .image_convert import library

    if limit < 0:
        raise ValueError("the host LZW decoder needs the output's length")
    out = ctypes.create_string_buffer(max(limit, 1))
    n = library().simvg_lzw_decode(data, len(data), kind, min_code_size, out,
                                   limit)
    if n < 0:
        raise ValueError({-1: "LZW stream starts with an undefined code",
                          -2: "LZW code past the table"}.get(
            n, f"LZW decode failed ({n})"))
    return out.raw[:n]


def decode(data: bytes, kind: int, device, min_code_size: int = 8,
           limit: int = -1) -> bytes:
    """The decoder of ``device``'s route: the host C++ for a CUDA device,
    ``decode_reference`` for the CPU."""
    if torch.device(device).type == "cuda":
        return decode_host(data, kind, min_code_size, limit)
    return decode_reference(data, kind, min_code_size, limit)
