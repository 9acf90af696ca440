"""A small PNG codec on ``zlib`` and numpy, for the dataset trees.

It reads and writes the 8-bit, non-interlaced greyscale (L), palette (P)
and RGB PNGs that the FQ and annotation-type trees hold (generated masks,
frames, and DAVIS / MOSE palette annotations), and raises ``PNGError`` (an
``OSError``, as PIL's are) on anything else.  Writing uses filter 0 on every
row; reading undoes all five filters.  Ancillary chunks are skipped.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPES = {0: ("L", 1), 2: ("RGB", 3), 3: ("P", 1)}


class PNGError(OSError):
    pass


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path, array: np.ndarray, palette=None):
    """``array`` uint8: [H, W] greyscale, or palette indices when
    ``palette`` ([n <= 256, 3] uint8) is given; [H, W, 3] RGB."""
    a = np.ascontiguousarray(array)
    if a.dtype != np.uint8:
        raise ValueError(f"PNG pixels must be uint8, not {a.dtype}")
    if a.ndim == 3 and a.shape[2] == 3 and palette is None:
        color_type = 2
    elif a.ndim == 2:
        color_type = 0 if palette is None else 3
    else:
        raise ValueError(f"cannot write a PNG of shape {a.shape}")
    h, w = a.shape[:2]
    rows = np.zeros((h, 1 + a[0].size), np.uint8)     # filter byte 0
    rows[:, 1:] = a.reshape(h, -1)
    out = [PNG_SIGNATURE,
           _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type,
                                       0, 0, 0))]
    if palette is not None:
        pal = np.asarray(palette, np.uint8).reshape(-1, 3)
        if not 1 <= len(pal) <= 256:
            raise ValueError(f"a palette of {len(pal)} colours")
        out.append(_chunk(b"PLTE", pal.tobytes()))
    out += [_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)),
            _chunk(b"IEND", b"")]
    Path(path).write_bytes(b"".join(out))


def _average(row: bytearray, prev: bytes, bpp: int):
    for i in range(len(row)):
        left = row[i - bpp] if i >= bpp else 0
        row[i] = (row[i] + ((left + prev[i]) >> 1)) & 0xFF


def _paeth(row: bytearray, prev: bytes, bpp: int):
    for i in range(len(row)):
        a = row[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        row[i] = (row[i] + pred) & 0xFF


def _unfilter(data: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    rows = np.frombuffer(data, np.uint8).reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, raw = rows[y, 0], rows[y, 1:]
        if kind == 0:
            cur = raw
        elif kind == 1:      # sub: a running sum over each byte's channel
            cur = np.cumsum(raw.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif kind == 2:      # up
            cur = raw + prev
        elif kind in (3, 4):
            row = bytearray(raw.tobytes())
            (_average if kind == 3 else _paeth)(row, prev.tobytes(), bpp)
            cur = np.frombuffer(bytes(row), np.uint8)
        else:
            raise PNGError(f"unknown PNG filter type {kind}")
        out[y] = cur
        prev = out[y]
    return out


def read_png(path):
    """-> (pixels uint8 [H, W] or [H, W, 3], mode 'L' / 'P' / 'RGB',
    palette [n, 3] uint8 or None)."""
    blob = Path(path).read_bytes()
    if not blob.startswith(PNG_SIGNATURE):
        raise PNGError(f"{path}: not a PNG file")
    pos, header, palette, idat = len(PNG_SIGNATURE), None, None, []
    while True:
        if pos + 8 > len(blob):
            raise PNGError(f"{path}: truncated PNG")
        length, tag = struct.unpack(">I4s", blob[pos:pos + 8])
        data = blob[pos + 8:pos + 8 + length]
        crc = blob[pos + 8 + length:pos + 12 + length]
        if len(data) != length or len(crc) != 4:
            raise PNGError(f"{path}: truncated PNG")
        if struct.unpack(">I", crc)[0] != zlib.crc32(tag + data) & 0xFFFFFFFF:
            raise PNGError(f"{path}: bad CRC in the {tag!r} chunk")
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif tag == b"PLTE":
            palette = np.frombuffer(data, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(data)
        elif tag == b"IEND":
            break
    if header is None:
        raise PNGError(f"{path}: no IHDR chunk")
    w, h, depth, color_type, compression, filtering, interlace = header
    if (depth != 8 or color_type not in _COLOR_TYPES or compression
            or filtering or interlace):
        raise PNGError(f"{path}: unsupported PNG (bit depth {depth}, colour "
                       f"type {color_type}, interlace {interlace})")
    mode, bpp = _COLOR_TYPES[color_type]
    if mode == "P" and palette is None:
        raise PNGError(f"{path}: palette PNG without a PLTE chunk")
    try:
        data = zlib.decompress(b"".join(idat))
    except zlib.error as exc:
        raise PNGError(f"{path}: {exc}") from exc
    if len(data) != h * (1 + w * bpp):
        raise PNGError(f"{path}: {len(data)} bytes of pixel data for "
                       f"{w}x{h} {mode}")
    pixels = _unfilter(data, h, w * bpp, bpp)
    pixels = pixels.reshape(h, w, 3) if bpp == 3 else pixels
    return pixels, mode, (palette if mode == "P" else None)


def imread_palette(path) -> np.ndarray:
    """Object ids of a mask PNG, as PIL's ``convert("P")`` gives them for
    the trees' masks: an L image's values, a P image's indices."""
    pixels, mode, _ = read_png(path)
    if mode == "RGB":
        raise PNGError(f"{path}: an RGB PNG is not a mask")
    return pixels


def imread_rgb01(path) -> np.ndarray:
    """[H, W, 3] float32 in [0, 1], as PIL's ``convert("RGB")``: an L image
    repeated, a P image through its palette."""
    pixels, mode, palette = read_png(path)
    if mode == "L":
        pixels = np.repeat(pixels[..., None], 3, axis=-1)
    elif mode == "P":
        full = np.zeros((256, 3), np.uint8)
        full[:len(palette)] = palette
        pixels = full[pixels]
    return pixels.astype(np.float32) / 255.0
