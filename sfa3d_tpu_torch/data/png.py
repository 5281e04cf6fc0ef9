"""8-bit PNG read and write with the standard library's zlib and numpy: the
port's stand-in for `cv2.imread` + `cvtColor(BGR2RGB)` and `cv2.imwrite`.

`read_png_rgb` decodes non-interlaced 8-bit greyscale (colour type 0), RGB
(2) and RGBA (6) files with any of the five row filters (0 none, 1 sub,
2 up, 3 average, 4 Paeth) into an (H, W, 3) RGB uint8 array, as cv2's
colour read gives after the BGR -> RGB swap: greyscale is repeated into
the three channels and alpha is dropped. Anything else (palette, 16-bit,
interlaced) raises ValueError. `write_png_rgb` writes an (H, W, 3) RGB
uint8 array with the up filter on every row.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type -> bytes per pixel at 8 bits


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length


def _unfilter_average(raw: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    cur = bytearray(raw.tobytes())
    up = prior.tobytes()
    for i in range(len(cur)):
        left = cur[i - bpp] if i >= bpp else 0
        cur[i] = (cur[i] + ((left + up[i]) >> 1)) & 0xFF
    return np.frombuffer(bytes(cur), np.uint8)


def _unfilter_paeth(raw: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    cur = bytearray(raw.tobytes())
    up = prior.tobytes()
    for i in range(len(cur)):
        if i >= bpp:
            a, b, c = cur[i - bpp], up[i], up[i - bpp]
        else:
            a, b, c = 0, up[i], 0
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF
    return np.frombuffer(bytes(cur), np.uint8)


def _unfilter(kind: int, raw: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    if kind == 0:
        return raw
    if kind == 1:  # sub: a running sum along the row, one per channel
        return np.cumsum(raw.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
    if kind == 2:  # up
        return raw + prior
    if kind == 3:
        return _unfilter_average(raw, prior, bpp)
    if kind == 4:
        return _unfilter_paeth(raw, prior, bpp)
    raise ValueError(f"unknown PNG row filter {kind}")


def decode_png_rgb(data: bytes) -> np.ndarray:
    """PNG file bytes -> (H, W, 3) RGB uint8 (see the module docstring)."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body[:13])
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without an IHDR chunk")
    width, height, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"unsupported PNG: bit depth {depth}, colour type {colour}, interlace {interlace} "
            "(8-bit non-interlaced greyscale, RGB or RGBA only)"
        )
    bpp = _CHANNELS[colour]
    stride = width * bpp
    flat = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if flat.size < height * (stride + 1):
        raise ValueError("truncated PNG image data")
    rows = flat[: height * (stride + 1)].reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        prior = out[y] = _unfilter(int(rows[y, 0]), rows[y, 1:], prior, bpp)
    pixels = out.reshape(height, width, bpp)
    if bpp == 1:
        return np.repeat(pixels, 3, axis=2)
    return np.ascontiguousarray(pixels[..., :3])


def read_png_rgb(path: str) -> np.ndarray:
    """A PNG file -> (H, W, 3) RGB uint8."""
    with open(path, "rb") as f:
        return decode_png_rgb(f.read())


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def encode_png_rgb(image: np.ndarray) -> bytes:
    """(H, W, 3) RGB uint8 -> PNG file bytes (8-bit RGB, the up filter on
    every row, zlib level 1: cv2.imwrite's default compression)."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) uint8 image; got {image.dtype} {image.shape}")
    h, w, _ = image.shape
    flat = np.ascontiguousarray(image).reshape(h, w * 3)
    up = flat.copy()
    up[1:] -= flat[:-1]  # uint8 arithmetic wraps, as the filter's byte sums do
    rows = np.concatenate([np.full((h, 1), 2, np.uint8), up], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 1))
            + _chunk(b"IEND", b""))


def write_png_rgb(path: str, image: np.ndarray) -> None:
    """Write an (H, W, 3) RGB uint8 image as a PNG file."""
    with open(path, "wb") as f:
        f.write(encode_png_rgb(image))
