"""Motion-JPEG AVI files in the standard library and numpy: the port's
stand-in for `cv2.VideoWriter(path, VideoWriter_fourcc(*"MJPG"), fps,
(w, h))` and for reading such a file's frames.

`AviMjpegWriter` writes a RIFF AVI with one video stream: `hdrl` (`avih`,
then `strl` with `strh` and a BITMAPINFOHEADER `strf` of compression
`MJPG`), `movi` with one `00dc` chunk per frame (each frame BGR uint8
through `data/jpeg.py::encode_jpeg` at quality 95, cv2.imwrite's default)
and `idx1`, every frame a key frame. The header's frame counts and sizes
are written when the file is released.

`read_avi_frames` returns each video frame's bytes (JPEG for MJPEG) by
walking the `movi` lists of every RIFF chunk (`AVI ` and OpenDML's
`AVIX`), descending into `rec ` lists and skipping index and JUNK chunks;
it does not trust `idx1`, which a muxer may leave out or supplement with
OpenDML indexes. `read_avi_info` gives the stream's size, rate and
compression.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np

from sfa3d_tpu_torch.data.jpeg import encode_jpeg

_AVIF_HASINDEX = 0x10
_AVIIF_KEYFRAME = 0x10


def _chunk(fourcc: bytes, body: bytes) -> bytes:
    pad = b"\0" if len(body) % 2 else b""
    return fourcc + struct.pack("<I", len(body)) + body + pad


def _list(kind: bytes, body: bytes) -> bytes:
    return _chunk(b"LIST", kind + body)


class AviMjpegWriter:
    """Frames of one size -> an MJPEG AVI at `fps` frames a second.
    `size` is (width, height), as cv2.VideoWriter takes it."""

    def __init__(self, path: str, fps: float, size: Tuple[int, int]):
        self.path, self.fps = path, float(fps)
        self.width, self.height = int(size[0]), int(size[1])
        self._index: List[Tuple[int, int]] = []  # (offset from 'movi', length)
        self._largest = 0
        self._f = open(path, "wb")
        self._f.write(self._header(0))
        self._movi_start = self._f.tell()  # the 'movi' fourcc sits 4 bytes before
        self._closed = False

    def _header(self, frames: int) -> bytes:
        usec = int(round(1e6 / self.fps))
        buffer = self._largest + 8
        avih = struct.pack("<10I4I", usec, buffer * int(round(self.fps)), 0, _AVIF_HASINDEX, frames, 0, 1,
                           buffer, self.width, self.height, 0, 0, 0, 0)
        rate, scale = _rate(self.fps)
        strh = (b"vids" + b"MJPG" + struct.pack("<IHHIIIIIIiI", 0, 0, 0, 0, scale, rate, 0, frames, buffer, -1, 0)
                + struct.pack("<4h", 0, 0, self.width, self.height))
        strf = struct.pack("<IiiHH4sIiiII", 40, self.width, self.height, 1, 24, b"MJPG",
                           self.width * self.height * 3, 0, 0, 0, 0)
        hdrl = _list(b"hdrl", _chunk(b"avih", avih) + _list(b"strl", _chunk(b"strh", strh) + _chunk(b"strf", strf)))
        # RIFF and movi sizes are patched at release
        return b"RIFF" + struct.pack("<I", 0) + b"AVI " + hdrl + b"LIST" + struct.pack("<I", 0) + b"movi"

    def write(self, image: np.ndarray) -> None:
        """Append one (height, width, 3) BGR uint8 frame."""
        if self._closed:
            raise ValueError("write on a released AviMjpegWriter")
        image = np.asarray(image)
        if image.shape[:2] != (self.height, self.width):
            raise ValueError(f"frame of {image.shape[1]} x {image.shape[0]} in a {self.width} x {self.height} video")
        self.write_encoded(encode_jpeg(image))

    def write_encoded(self, jpeg: bytes) -> None:
        """Append one frame that is already a JPEG of the video's size."""
        offset = self._f.tell() - self._movi_start + 4
        self._f.write(_chunk(b"00dc", jpeg))
        self._index.append((offset, len(jpeg)))
        self._largest = max(self._largest, len(jpeg))

    def release(self) -> None:
        if self._closed:
            return
        self._closed = True
        f = self._f
        movi_end = f.tell()
        idx = b"".join(b"00dc" + struct.pack("<III", _AVIIF_KEYFRAME, off, n) for off, n in self._index)
        f.write(_chunk(b"idx1", idx))
        end = f.tell()
        f.seek(0)
        header = self._header(len(self._index))
        f.write(header)
        f.seek(4)
        f.write(struct.pack("<I", end - 8))
        f.seek(self._movi_start - 8)
        f.write(struct.pack("<I", movi_end - self._movi_start + 4))
        f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()


def _rate(fps: float) -> Tuple[int, int]:
    """(dwRate, dwScale) with dwRate / dwScale = fps."""
    if float(fps).is_integer():
        return int(fps), 1
    return int(round(fps * 1000)), 1000


def _walk(data: bytes, lo: int, hi: int, frames: List[bytes], info: Dict) -> None:
    pos = lo
    while pos + 8 <= hi:
        fourcc = data[pos:pos + 4]
        (size,) = struct.unpack("<I", data[pos + 4:pos + 8])
        body = pos + 8
        end = min(body + size, hi)
        if fourcc in (b"RIFF", b"LIST"):
            kind = data[body:body + 4]
            if kind in (b"AVI ", b"AVIX", b"hdrl", b"strl", b"movi", b"rec "):
                _walk(data, body + 4, end, frames, {**info, "in": kind} if kind in (b"movi", b"rec ") else info)
        elif info.get("in") in (b"movi", b"rec ") and fourcc[2:4] in (b"dc", b"db") and fourcc[:2].isdigit():
            if int(fourcc[:2]) == 0 and size:
                frames.append(data[body:end])
        elif fourcc == b"avih" and "avih" not in info:
            info["avih"] = data[body:end]
        elif fourcc == b"strh" and "strh" not in info:
            info["strh"] = data[body:end]
        elif fourcc == b"strf" and "strf" not in info:
            info["strf"] = data[body:end]
        pos = body + size + (size & 1)


def _parse(path: str):
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        raise ValueError(f"{path}: not a RIFF AVI file")
    frames: List[bytes] = []
    info: Dict = {}
    _walk(data, 0, len(data), frames, info)
    return frames, info


def read_avi_frames(path: str) -> List[bytes]:
    """The first video stream's frames, in file order, as bytes."""
    return _parse(path)[0]


def read_avi_info(path: str) -> Dict:
    """{"width", "height", "fps", "compression", "frames"} of the first
    video stream, from its headers (frames: the chunks found in movi)."""
    frames, info = _parse(path)
    if "strf" not in info or "strh" not in info:
        raise ValueError(f"{path}: no video stream header")
    _, width, height, _, _, compression = struct.unpack("<IiiHH4s", info["strf"][:20])
    scale, rate = struct.unpack("<II", info["strh"][20:28])
    return {"width": width, "height": abs(height), "fps": rate / scale if scale else 0.0,
            "compression": compression.decode("latin-1"), "frames": len(frames)}
