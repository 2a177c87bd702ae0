"""Image IO on the host: Radiance RGBE .hdr in and out, 8-bit PNG out
(`rpt_tpu/io/image.py`).

`load_hdr` decodes flat scanlines and the 'new RLE' (0x02 0x02) ones, as
the reference's decoder does; `save_hdr` writes flat scanlines. `save_png`
writes an 8-bit RGB PNG with the standard library alone (`zlib`,
`struct`): one IDAT chunk, every scanline with filter 0.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["load_hdr", "save_hdr", "save_png"]


def _decode_rgbe(rgbe: np.ndarray) -> np.ndarray:
    """(..., 4) uint8 RGBE -> (..., 3) float32: rgb = m/256 * 2^(e-128),
    with e=0 meaning black (the Radiance spec)."""
    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(e == 0, 0.0, np.ldexp(1.0 / 256.0, e - 128))
    return rgbe[..., :3].astype(np.float32) * scale[..., None].astype(np.float32)


def load_hdr(path) -> np.ndarray:
    """Load a Radiance RGBE .hdr equirectangular image -> (H, W, 3) float32
    linear RGB."""
    with open(path, "rb") as f:
        data = f.read()
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError(f"{path}: not a Radiance RGBE file")
    # Header: lines until the blank line, then the resolution line.
    pos = 0
    fmt_ok = False
    while True:
        nl = data.index(b"\n", pos)
        line = data[pos:nl]
        pos = nl + 1
        if line.startswith(b"FORMAT="):
            fmt_ok = line.strip() == b"FORMAT=32-bit_rle_rgbe"
        if line == b"":
            break
    if not fmt_ok:
        raise ValueError(f"{path}: unsupported FORMAT (want 32-bit_rle_rgbe)")
    nl = data.index(b"\n", pos)
    res = data[pos:nl].split()
    pos = nl + 1
    if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"{path}: unsupported orientation {res}")
    h, w = int(res[1]), int(res[3])

    buf = np.frombuffer(data, np.uint8, offset=pos)
    out = np.empty((h, w, 4), np.uint8)
    i = 0
    for y in range(h):
        if 8 <= w < 32768 and buf[i] == 2 and buf[i + 1] == 2 and ((int(buf[i + 2]) << 8) | int(buf[i + 3])) == w:
            # New RLE: 4 component planes, each a run/dump stream.
            i += 4
            for c in range(4):
                x = 0
                while x < w:
                    n = int(buf[i])
                    if n > 128:  # a run of n-128 copies of the next byte
                        out[y, x:x + n - 128, c] = buf[i + 1]
                        x += n - 128
                        i += 2
                    else:  # a dump of n literal bytes
                        out[y, x:x + n, c] = buf[i + 1:i + 1 + n]
                        x += n
                        i += 1 + n
        else:
            out[y] = buf[i:i + 4 * w].reshape(w, 4)
            i += 4 * w
    return _decode_rgbe(out)


def save_hdr(path, image: np.ndarray) -> None:
    """Write (H, W, 3) linear RGB as a Radiance RGBE .hdr file with flat
    scanlines. Each pixel keeps 8-bit mantissas under one shared exponent,
    so a round trip is exact to about 0.4%."""
    img = np.asarray(image, np.float64)
    if img.ndim != 3 or img.shape[-1] != 3:
        raise ValueError(f"save_hdr takes an (H, W, 3) image, not {img.shape}")
    h, w = img.shape[:2]
    maxc = img.max(axis=-1)
    zero = maxc < 1e-32
    m, e = np.frexp(np.where(zero, 1.0, maxc))  # maxc = m * 2^e, m in [.5, 1)
    scale = m * 256.0 / np.where(zero, 1.0, maxc)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(img * scale[..., None] + 0.5, 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(zero, 0, e + 128).astype(np.uint8)
    rgbe[zero] = 0
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())


def _chunk(tag: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF)


def save_png(path, image_u8: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 image as an 8-bit RGB PNG."""
    img = np.ascontiguousarray(image_u8, np.uint8)
    if img.ndim != 3 or img.shape[-1] != 3:
        raise ValueError(f"save_png takes an (H, W, 3) image, not {img.shape}")
    h, w = img.shape[:2]
    # Every scanline starts with its filter type, 0 (none).
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, 3 * w)], axis=1).tobytes()
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8 bits, RGB, deflate, filter 0, no interlace
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", header))
        f.write(_chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(_chunk(b"IEND", b""))
