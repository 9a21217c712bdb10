"""Image IO and colour conversion.

The reference never persisted images at all (its blit pass converts the
linear accumulation buffer to the sRGB swapchain, fragment.glsl:8-12); here
the same linear→sRGB transfer function (common.glsl:400-412) feeds a PNG
writer — a strict capability upgrade.  The PNG codec uses the standard
library only (zlib + struct), so rendering needs no imaging package.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def linear_to_srgb(linear: np.ndarray) -> np.ndarray:
    """Piecewise sRGB OETF on clamped linear RGB (common.glsl:401-407)."""
    x = np.clip(np.asarray(linear, np.float32), 0.0, 1.0)
    lower = x * 12.92
    higher = 1.055 * np.power(x, 1.0 / 2.4, where=x > 0, out=np.zeros_like(x)) - 0.055
    return np.where(x < 0.0031308, lower, higher)


def srgb_to_linear(srgb: np.ndarray) -> np.ndarray:
    """Inverse transfer (common.glsl:415-421)."""
    x = np.clip(np.asarray(srgb, np.float32), 0.0, 1.0)
    lower = x / 12.92
    higher = np.power((x + 0.055) / 1.055, 2.4)
    return np.where(x < 0.04045, lower, higher)


def to_srgb_u8(linear: np.ndarray) -> np.ndarray:
    return np.round(linear_to_srgb(linear) * 255.0).astype(np.uint8)


_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(rgb_u8: np.ndarray) -> bytes:
    """[H,W,3] uint8 -> PNG bytes (8-bit RGB, filter 0 on every row),
    with the standard library alone."""
    rgb = np.ascontiguousarray(rgb_u8, np.uint8)
    h, w = rgb.shape[:2]
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected [H,W,3] uint8, got {rgb.shape}")
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, 3 * w)],
                         axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (_PNG_SIG + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> [H,W,C] uint8 for 8-bit, non-interlaced grey, RGB or
    RGBA images (every filter type); the reader for encode_png's output
    and other simple PNGs."""
    if data[:8] != _PNG_SIG:
        raise ValueError("not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    w, h, depth, ctype, _, _, interlace = hdr
    chans = {0: 1, 2: 3, 4: 2, 6: 4}.get(ctype)
    if depth != 8 or chans is None or interlace:
        raise ValueError(f"unsupported PNG (depth {depth}, colour type "
                         f"{ctype}, interlace {interlace})")
    stride = w * chans
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.int32)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        f, line = raw[y, 0], raw[y, 1:].astype(np.int32)
        if f == 0:
            cur = line
        elif f == 2:
            cur = (line + prev) & 0xFF
        else:   # sub / average / Paeth depend on the reconstructed left pixel
            cur = np.zeros(stride, np.int32)
            for x in range(stride):
                a = cur[x - chans] if x >= chans else 0
                b = prev[x]
                c = prev[x - chans] if x >= chans else 0
                if f == 1:
                    p = a
                elif f == 3:
                    p = (a + b) // 2
                else:
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    p = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[x] = (line[x] + p) & 0xFF
        out[y] = cur
        prev = cur
    return out.astype(np.uint8).reshape(h, w, chans)


def write_png(path: str, linear_rgb: np.ndarray) -> None:
    """Write a linear-light [H,W,3] float image as an sRGB PNG."""
    with open(path, "wb") as f:
        f.write(encode_png(to_srgb_u8(linear_rgb)))


def read_png_linear(path: str) -> np.ndarray:
    """Read an 8-bit PNG as linear-light [H,W,3] float32."""
    with open(path, "rb") as f:
        img = decode_png(f.read())
    if img.shape[2] < 3:
        img = np.repeat(img[..., :1], 3, axis=2)
    return srgb_to_linear(img[..., :3].astype(np.float32) / 255.0)


def rmse(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)))
