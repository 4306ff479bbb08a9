"""A PNG codec on the standard library's ``zlib`` and ``struct`` with numpy:
the port reads and writes image files without an image library (the GPU
machine has none).

``decode`` reads every PNG the format allows: colour types 0 (grey), 2
(RGB), 3 (palette), 4 (grey + alpha) and 6 (RGBA); bit depths 1, 2, 4, 8
and 16 where the type allows them; the five scanline filters; Adam7
interlacing.  ``to_float`` maps the samples to float32 as matplotlib's
``plt.imread`` does through Pillow, so ``signals/image.py:imread`` gives
the JAX package's values.  ``write_rgba`` writes 8-bit RGBA, as
``plt.imsave`` writes its files (the same pixels; no text chunks).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"

# samples per pixel and the bit depths each colour type allows
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}

# Adam7's passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _chunks(data):
    """(type, payload) of each chunk after the signature, CRCs checked."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"PNG chunk {kind!r} is truncated")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + body):
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG file ends before its IEND chunk")


def _paeth_row(f, prior, bpp):
    """Undo the Paeth filter of one scanline, byte by byte."""
    out = bytearray(len(f))
    for i in range(len(f)):
        a = out[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        if pa <= pb and pa <= pc:
            pred = a
        elif pb <= pc:
            pred = b
        else:
            pred = c
        out[i] = (f[i] + pred) & 0xFF
    return out


def _average_row(f, prior, bpp):
    """Undo the Average filter of one scanline, byte by byte."""
    out = bytearray(len(f))
    for i in range(len(f)):
        a = out[i - bpp] if i >= bpp else 0
        out[i] = (f[i] + ((a + prior[i]) >> 1)) & 0xFF
    return out


def _unfilter(raw, pos, rows, row_bytes, bpp):
    """(rows, row_bytes) uint8 of the reconstructed scanlines starting at
    ``raw[pos]`` (each led by its filter byte), and the position after
    them."""
    out = np.zeros((rows, row_bytes), np.uint8)
    prior = np.zeros(row_bytes, np.uint8)
    for r in range(rows):
        if pos + 1 + row_bytes > len(raw):
            raise ValueError("PNG image data is truncated")
        ftype = raw[pos]
        f = np.frombuffer(raw, np.uint8, row_bytes, pos + 1)
        pos += 1 + row_bytes
        if ftype == 0:
            row = f.copy()
        elif ftype == 1:
            # Sub: a running sum mod 256 over the pixel's byte lanes
            pad = -row_bytes % bpp
            lanes = np.concatenate([f, np.zeros(pad, np.uint8)]).reshape(
                -1, bpp)
            row = (np.cumsum(lanes, axis=0, dtype=np.uint64) & 0xFF).astype(
                np.uint8).reshape(-1)[:row_bytes]
        elif ftype == 2:
            row = f + prior
        elif ftype == 3:
            row = np.frombuffer(_average_row(f.tobytes(), prior.tobytes(),
                                             bpp), np.uint8)
        elif ftype == 4:
            row = np.frombuffer(_paeth_row(f.tobytes(), prior.tobytes(),
                                           bpp), np.uint8)
        else:
            raise ValueError(f"PNG scanline filter type {ftype} is not one "
                             f"of the five the format defines")
        out[r] = row
        prior = out[r]
    return out, pos


def _samples(rows, width, channels, depth):
    """(h, width, channels) samples of reconstructed scanlines: uint8 for
    depths up to 8, uint16 for 16."""
    h = rows.shape[0]
    if depth == 16:
        v = rows.reshape(h, -1)[:, :width * channels * 2].view(">u2")
        return v.astype(np.uint16).reshape(h, width, channels)
    if depth == 8:
        return rows[:, :width * channels].reshape(h, width, channels)
    bits = np.unpackbits(rows, axis=1)[:, :width * channels * depth]
    bits = bits.reshape(h, width * channels, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(-1, dtype=np.uint8).reshape(h, width,
                                                            channels)


def decode(data):
    """A PNG file's contents as a dict: ``samples`` (H, W, channels) uint8
    or uint16 as stored (palette indices for colour type 3), ``depth``,
    ``color_type``, ``palette`` ((n, 3) uint8 or None), ``trns`` (the tRNS
    chunk's bytes or None).  Raises ValueError on a malformed file."""
    header = None
    palette = trns = None
    idat = []
    for kind, body in _chunks(bytes(data)):
        if kind == b"IHDR":
            if len(body) != 13:
                raise ValueError("PNG IHDR chunk has a wrong length")
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            if len(body) % 3:
                raise ValueError("PNG palette length is not a multiple of 3")
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG file has no IHDR chunk")
    width, height, depth, ctype, comp, filt, interlace = header
    if ctype not in _CHANNELS:
        raise ValueError(f"PNG colour type {ctype} is not one of 0, 2, 3, "
                         f"4, 6")
    if depth not in _DEPTHS[ctype]:
        raise ValueError(f"PNG bit depth {depth} is not allowed for colour "
                         f"type {ctype}")
    if comp != 0 or filt != 0:
        raise ValueError(f"PNG compression {comp} / filter method {filt}: "
                         f"only 0 is defined")
    if interlace not in (0, 1):
        raise ValueError(f"PNG interlace method {interlace} is not 0 (none) "
                         f"or 1 (Adam7)")
    if ctype == 3 and palette is None:
        raise ValueError("PNG palette image has no PLTE chunk")
    raw = zlib.decompress(b"".join(idat))
    channels = _CHANNELS[ctype]
    bpp = max(1, channels * depth // 8)
    dtype = np.uint16 if depth == 16 else np.uint8
    if interlace == 0:
        row_bytes = (width * channels * depth + 7) // 8
        rows, _ = _unfilter(raw, 0, height, row_bytes, bpp)
        samples = _samples(rows, width, channels, depth)
    else:
        samples = np.zeros((height, width, channels), dtype)
        pos = 0
        for x0, y0, dx, dy in _ADAM7:
            w = (width - x0 + dx - 1) // dx if width > x0 else 0
            h = (height - y0 + dy - 1) // dy if height > y0 else 0
            if w == 0 or h == 0:
                continue
            row_bytes = (w * channels * depth + 7) // 8
            rows, pos = _unfilter(raw, pos, h, row_bytes, bpp)
            samples[y0::dy, x0::dx] = _samples(rows, w, channels, depth)
    return {"samples": samples, "depth": depth, "color_type": ctype,
            "palette": palette, "trns": trns}


def to_float(png):
    """float32 pixels of a ``decode`` result, as ``plt.imread`` gives them
    through Pillow: grey (H, W) over 2^depth - 1, the 1-bit file as 0/1
    and the 2- and 4-bit files' samples as Pillow widens them to 8 bits
    (x 85, x 17) over 3 and 15; RGB (H, W, 3) and RGBA (H, W, 4) over 255,
    16-bit samples cut to their high byte first; grey + alpha and palette
    images as RGBA (a palette's alpha from tRNS, else opaque)."""
    s = png["samples"]
    depth, ctype = png["depth"], png["color_type"]
    if ctype == 0:
        g = s[..., 0]
        if depth == 1:
            return g.astype(np.float32)
        if depth in (2, 4):
            widen = 255 // ((1 << depth) - 1)
            return np.divide(g.astype(np.uint8) * np.uint8(widen),
                             (1 << depth) - 1, dtype=np.float32)
        return np.divide(g, (1 << depth) - 1, dtype=np.float32)
    if depth == 16:
        s = (s >> 8).astype(np.uint8)
    if ctype == 3:
        pal = png["palette"]
        alpha = np.full(len(pal), 255, np.uint8)
        if png["trns"] is not None:
            t = np.frombuffer(png["trns"], np.uint8)[:len(pal)]
            alpha[:len(t)] = t
        lut = np.concatenate([pal, alpha[:, None]], axis=1)
        idx = s[..., 0].astype(np.intp)
        if idx.max(initial=0) >= len(lut):
            raise ValueError("PNG palette index past the palette's end")
        s = lut[idx]
    elif ctype == 4:
        s = np.concatenate([s[..., :1]] * 3 + [s[..., 1:]], axis=-1)
    return np.divide(s, 255, dtype=np.float32)


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def write_rgba(path, rgba):
    """Write an (H, W, 4) uint8 array to ``path`` as an 8-bit RGBA PNG,
    each scanline unfiltered (filter type 0)."""
    rgba = np.ascontiguousarray(rgba, np.uint8)
    if rgba.ndim != 3 or rgba.shape[2] != 4:
        raise ValueError(f"write_rgba: expected (H, W, 4) uint8, got "
                         f"{rgba.shape}")
    h, w, _ = rgba.shape
    lines = np.concatenate([np.zeros((h, 1), np.uint8),
                            rgba.reshape(h, w * 4)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(SIGNATURE + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(lines.tobytes(), 6))
                + _chunk(b"IEND", b""))
