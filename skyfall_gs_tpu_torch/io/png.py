"""A numpy + zlib PNG codec for the scene readers and frame dumps.

The port's readers decode PNG images with this module, so reading a scene
needs neither PIL nor OpenCV (other image formats still go through PIL).
It decodes 8-bit, non-interlaced images of colour types 0 (grey), 2 (RGB),
3 (palette), 4 (grey + alpha) and 6 (RGBA), with any mix of the five row
filters, plus the ``tRNS`` transparency chunk; it encodes 8-bit RGB with
filter 0.  Anything else raises ``ValueError``.

``read_png(path, mode)`` returns what PIL's ``Image.open(path).convert(mode)``
gives for ``mode`` "RGB" or "RGBA": a (H, W, 3|4) uint8 array.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunks(data: bytes):
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError("truncated PNG: no IEND chunk")


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, height: int, width: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters: (H, 1 + W*bpp) filtered bytes -> (H, W*bpp)."""
    ftype = raw[:, 0].astype(np.int64)
    filt = raw[:, 1:].astype(np.int32)
    if ftype.max(initial=0) > 4:
        raise ValueError(f"unknown PNG filter type {int(ftype.max())}")
    if not ftype.any():
        return filt.astype(np.uint8)
    if np.isin(ftype, (0, 2)).all():          # None / Up: one add per row
        out = filt.copy()
        for y in range(1, height):
            if ftype[y] == 2:
                out[y] = (out[y] + out[y - 1]) & 0xFF
        return out.astype(np.uint8)
    # General case: pixel (y, x) depends on its left (a), upper (b) and
    # upper-left (c) neighbours, so reconstruct one anti-diagonal x + y = d
    # at a time, vectorized over the pixels (and bytes) of the diagonal.
    rec = np.zeros((height + 1, (width + 1) * bpp), np.int32)   # zero top row / left pixel
    k = np.arange(bpp)
    for d in range(height + width - 1):
        ys = np.arange(max(0, d - width + 1), min(height, d + 1))
        xs = d - ys
        row = ys[:, None]
        cur = (xs[:, None] + 1) * bpp + k                      # padded column of (y, x)
        a = rec[row + 1, cur - bpp]
        b = rec[row, cur]
        c = rec[row, cur - bpp]
        t = ftype[ys][:, None]
        pred = np.select([t == 1, t == 2, t == 3, t == 4],
                         [a, b, (a + b) >> 1, _paeth(a, b, c)], 0)
        rec[row + 1, cur] = (filt[row, xs[:, None] * bpp + k] + pred) & 0xFF
    return rec[1:, bpp:].astype(np.uint8)


def read_png(path: str, mode: str = "RGB") -> np.ndarray:
    """Decode a PNG file to (H, W, 3) uint8 for ``mode="RGB"`` or (H, W, 4)
    for ``mode="RGBA"``, as PIL's ``convert(mode)`` would."""
    if mode not in ("RGB", "RGBA"):
        raise ValueError(f"unsupported mode {mode!r}")
    with open(path, "rb") as f:
        data = f.read()
    header = palette = trns = None
    idat = []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise ValueError(f"{path}: unsupported PNG (bit depth {depth}, colour type "
                         f"{ctype}, interlace {interlace}); only 8-bit non-interlaced "
                         "types 0, 2, 3, 4 and 6 are decoded")
    ch = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (1 + width * ch):
        raise ValueError(f"{path}: image data has {raw.size} bytes, expected "
                         f"{height * (1 + width * ch)}")
    px = _unfilter(raw.reshape(height, 1 + width * ch), height, width, ch)
    px = px.reshape(height, width, ch)

    alpha = None
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{path}: palette image without a PLTE chunk")
        rgb = palette[px[..., 0]]
        if trns is not None:
            table = np.full(256, 255, np.uint8)
            table[:len(trns)] = np.frombuffer(trns, np.uint8)
            alpha = table[px[..., 0]]
    elif ctype in (0, 4):
        rgb = np.repeat(px[..., :1], 3, axis=2)
        if ctype == 4:
            alpha = px[..., 1]
        elif trns is not None:
            key = struct.unpack(">H", trns[:2])[0]
            alpha = np.where(px[..., 0] == key, 0, 255).astype(np.uint8)
    else:
        rgb = px[..., :3]
        if ctype == 6:
            alpha = px[..., 3]
        elif trns is not None:
            key = np.array(struct.unpack(">HHH", trns[:6]))
            alpha = np.where((px == key).all(-1), 0, 255).astype(np.uint8)
    if mode == "RGB":
        return np.ascontiguousarray(rgb)
    if alpha is None:
        alpha = np.full(rgb.shape[:2], 255, np.uint8)
    return np.concatenate([rgb, alpha[..., None]], axis=2)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path: str, rgb: np.ndarray) -> None:
    """Encode an (H, W, 3) uint8 image as an 8-bit RGB PNG (filter 0)."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {rgb.dtype} {rgb.shape}")
    h, w = rgb.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)
    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))
