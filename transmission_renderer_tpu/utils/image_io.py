"""PNG IO with the standard library (zlib + struct) and numpy.

Writes 8-bit RGB with the Up filter on every row; reads 8-bit
non-interlaced greyscale, grey+alpha, RGB and RGBA PNGs with any of the
five row filters.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunk(kind: bytes, body: bytes) -> bytes:
    crc = zlib.crc32(kind + body) & 0xFFFFFFFF
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", crc)


def encode_png(rgb: np.ndarray) -> bytes:
    """[H, W, 3] (or [H, W, 4]) uint8 or float [0,1] array -> PNG bytes."""
    arr = np.asarray(rgb)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    h, w, c = arr.shape
    colour = {3: 2, 4: 6}[c]
    rows = arr.reshape(h, w * c)
    prior = np.concatenate([np.zeros((1, w * c), np.uint8), rows[:-1]])
    up = rows - prior  # uint8 arithmetic wraps mod 256
    raw = np.concatenate([np.full((h, 1), 2, np.uint8), up], axis=1)
    return (
        _SIGNATURE
        + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
        + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
        + _chunk(b"IEND", b"")
    )


def save_png(path: str, rgb: np.ndarray) -> None:
    """Save [H, W, 3] uint8 or float [0,1] array as PNG."""
    with open(path, "wb") as f:
        f.write(encode_png(rgb))


def _unfilter_row(ftype: int, row: np.ndarray, prior: np.ndarray, bpp: int):
    if ftype == 0:
        return row
    if ftype == 1:  # Sub: running sum per channel, mod 256
        return np.cumsum(
            row.reshape(-1, bpp), axis=0, dtype=np.uint8
        ).reshape(-1)
    if ftype == 2:  # Up
        return row + prior
    out = np.zeros(row.shape[0] + bpp, np.int32)  # bpp zeros on the left
    r = row.astype(np.int32)
    p = prior.astype(np.int32)
    if ftype == 3:  # Average
        for i in range(row.shape[0]):
            out[i + bpp] = (r[i] + ((out[i] + p[i]) >> 1)) & 0xFF
    elif ftype == 4:  # Paeth
        pl = np.concatenate([np.zeros(bpp, np.int32), p])  # upper-left
        for i in range(row.shape[0]):
            a, b, c = out[i], p[i], pl[i]
            est = a + b - c
            pa, pb, pc = abs(est - a), abs(est - b), abs(est - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            out[i + bpp] = (r[i] + pred) & 0xFF
    else:
        raise ValueError(f"bad PNG filter type {ftype}")
    return out[bpp:].astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> [H, W, 4] uint8 (RGB expanded with opaque alpha)."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        kind, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + n]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    w, h, depth, colour, _, _, interlace = header
    if depth != 8 or interlace or colour not in _CHANNELS:
        raise ValueError(
            f"unsupported PNG (bit depth {depth}, colour type {colour}, "
            f"interlace {interlace})"
        )
    c = _CHANNELS[colour]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, 1 + w * c)
    rows = np.empty((h, w * c), np.uint8)
    prior = np.zeros(w * c, np.uint8)
    for y in range(h):
        prior = _unfilter_row(int(raw[y, 0]), raw[y, 1:], prior, c)
        rows[y] = prior
    img = rows.reshape(h, w, c)
    if c < 3:  # grey (+ alpha) -> RGB (+ alpha)
        img = np.concatenate([np.repeat(img[..., :1], 3, -1), img[..., 1:]], -1)
    if img.shape[-1] == 3:
        img = np.concatenate([img, np.full((h, w, 1), 255, np.uint8)], -1)
    return img


def load_png(path: str) -> np.ndarray:
    """Load a PNG as [H, W, 4] uint8 (RGB expanded with opaque alpha)."""
    with open(path, "rb") as f:
        return decode_png(f.read())
