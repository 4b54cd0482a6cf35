"""PNG reader and writer on ``zlib``, ``struct`` and numpy.

The JAX package reads and writes its image files through OpenCV or Pillow;
the port keeps its disk path free of both, so it runs where neither is
installed. Reading covers 8- and 16-bit grayscale, grayscale + alpha, RGB
and RGBA, non-interlaced, with all five row filters (None, Sub and Up
vectorised; Average and Paeth run per byte in Python, which is slow on
large frames and fine for small ones). Writing covers 8-bit gray and RGB and
16-bit gray, filter None on every row, so the port's own files always take
the fast path. 16-bit samples are big-endian on disk, as the format says.

``imread_gray`` / ``imread_color`` give float32 arrays as the JAX loaders
do: a colour file read as gray takes Pillow's "L" conversion (ITU-R 601-2
luma, L = (19595 R + 38470 G + 7471 B + 32768) >> 16); a gray file read as
colour is repeated over three channels.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# Colour type -> channels (0 gray, 2 RGB, 4 gray + alpha, 6 RGBA).
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunks(data: bytes):
    """(type, payload) of every chunk after the signature, CRC checked."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + payload) != crc:
            raise ValueError(f"PNG chunk {kind!r}: bad CRC")
        yield kind, payload
        pos += 12 + length
        if kind == b"IEND":
            return


def _unfilter_average(cur: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(cur)):
        left = cur[i - bpp] if i >= bpp else 0
        cur[i] = (cur[i] + ((left + prev[i]) >> 1)) & 0xFF


def _unfilter_paeth(cur: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF


def _unfilter(raw: bytes, height: int, stride: int, bpp: int):
    """Undo the per-row filters: rows [height, stride] uint8."""
    rows = np.frombuffer(raw, np.uint8)[:height * (stride + 1)]
    rows = rows.reshape(height, stride + 1)
    out = rows[:, 1:].copy()
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        kind = int(rows[y, 0])
        row = out[y]
        if kind == 1:      # Sub: running sum of each byte lane, mod 256
            lanes = row.reshape(-1, bpp)
            out[y] = np.cumsum(lanes, axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:    # Up
            out[y] = row + prev
        elif kind in (3, 4):
            cur = bytearray(row.tobytes())
            (_unfilter_average if kind == 3 else _unfilter_paeth)(
                cur, prev.tobytes(), bpp)
            out[y] = np.frombuffer(bytes(cur), np.uint8)
        elif kind != 0:
            raise ValueError(f"PNG row {y}: unknown filter type {kind}")
        prev = out[y]
    return out


def read(path):
    """The image of a PNG file: uint8 or uint16, [H, W] for gray and
    [H, W, C] otherwise (C = 2, 3 or 4, channels in file order)."""
    data = Path(path).read_bytes()
    header, idat = None, []
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, color, _, _, interlace = header
    if color not in _CHANNELS or depth not in (8, 16) or interlace:
        raise ValueError(f"{path}: unsupported PNG (colour type {color}, "
                         f"bit depth {depth}, interlace {interlace})")
    channels = _CHANNELS[color]
    bpp = channels * depth // 8
    rows = _unfilter(zlib.decompress(b"".join(idat)), height, width * bpp,
                     bpp)
    img = rows.reshape(-1)
    if depth == 16:
        img = img.view(">u2").astype(np.uint16)
    img = img.reshape((height, width, channels) if channels > 1
                      else (height, width))
    return img


def write(path, img) -> None:
    """Write uint8 [H, W] (gray) or [H, W, 3] (RGB), or uint16 [H, W]
    (16-bit gray); filter None on every row."""
    img = np.asarray(img)
    if img.dtype == np.uint8 and img.ndim == 2:
        depth, color = 8, 0
    elif img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3:
        depth, color = 8, 2
    elif img.dtype == np.uint16 and img.ndim == 2:
        depth, color = 16, 0
        img = img.astype(">u2")
    else:
        raise ValueError(f"cannot write a PNG of {img.dtype} {img.shape}")
    height, width = img.shape[:2]
    rows = np.ascontiguousarray(img).view(np.uint8).reshape(height, -1)
    raw = np.concatenate([np.zeros((height, 1), np.uint8), rows], axis=1)

    def chunk(kind: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    Path(path).write_bytes(
        SIGNATURE
        + chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, depth, color,
                                     0, 0, 0))
        + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
        + chunk(b"IEND", b""))


def _rgb(img):
    """[H, W, 3] of a decoded image (alpha dropped, gray repeated)."""
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=-1)
    if img.shape[2] == 2:
        return np.repeat(img[..., :1], 3, axis=-1)
    return img[..., :3]


def imread_gray(path) -> np.ndarray:
    """float32 [H, W]: a gray file as stored, a colour file through
    Pillow's "L" conversion (8-bit files)."""
    img = read(path)
    if img.ndim == 3 and img.shape[2] == 2:
        img = img[..., 0]
    if img.ndim == 3:
        c = img[..., :3].astype(np.uint32)
        img = (c[..., 0] * 19595 + c[..., 1] * 38470 + c[..., 2] * 7471
               + 0x8000) >> 16
    return img.astype(np.float32)


def imread_color(path) -> np.ndarray:
    """float32 [H, W, 3] RGB."""
    return _rgb(read(path)).astype(np.float32)
