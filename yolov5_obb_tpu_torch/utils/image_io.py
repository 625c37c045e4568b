"""Image reading and writing for the detect and serve surface.

The counterpart of the ``cv2.imread`` / ``cv2.imdecode`` calls of the JAX
package's ``detect.py``, ``api.py`` and ``serve.py``.  PNG is read here,
without OpenCV (the card's machine has none): the chunks, ``zlib``, the five
scanline filters (PNG specification, section 9) undone row by row in
``native/png_filter.cpp`` where ``g++`` builds it and in NumPy otherwise,
then the samples as ``cv2.IMREAD_COLOR`` gives them: BGR uint8, 16-bit
samples taken as ``>> 8``, 1/2/4-bit gray scaled to 0-255, gray replicated,
palette indices looked up, alpha dropped.  Interlaced PNG and every other
format go to ``cv2``, imported inside the call; where OpenCV is absent
:class:`OpenCVUnavailable` names it.  PNG never goes through ``cv2``, on any
machine.

:func:`write_png` writes 8- or 16-bit gray, gray+alpha, RGB and RGBA PNG
with any of the five filters, with the standard library and NumPy only.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

from .. import native

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type → samples per pixel
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}


class OpenCVUnavailable(ImportError):
    """A format other than non-interlaced PNG was asked of a machine
    without OpenCV."""


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise OpenCVUnavailable(
            "this image is not a non-interlaced PNG, and reading it needs "
            "OpenCV (cv2), which is not installed") from e
    return cv2


def is_png(data) -> bool:
    return bytes(data[:8]) == PNG_SIGNATURE


# ---------------------------------------------------------------------------
# filters
# ---------------------------------------------------------------------------


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def unfilter_np(raw, height: int, stride: int, bpp: int) -> np.ndarray:
    """The unfiltered ``(height, stride)`` uint8 rows of an inflated image
    stream (each row a filter-type byte + ``stride`` bytes; ``bpp`` bytes
    per complete pixel, at least 1).  Average and Paeth read the byte just
    rebuilt to their left, so those rows run pixel by pixel."""
    rows = np.frombuffer(raw, np.uint8)[:height * (stride + 1)]
    rows = rows.reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(height):
        ftype, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub: a running sum over each byte of a pixel
            pad = (-stride) % bpp
            cur = np.cumsum(np.pad(line, (0, pad)).reshape(-1, bpp), 0)
            cur = cur.reshape(-1)[:stride]
        elif ftype == 2:
            cur = line + prev
        elif ftype in (3, 4):
            cur = np.zeros(stride, np.int32)
            zero = np.zeros(bpp, np.int32)
            for i in range(0, stride, bpp):
                j = min(i + bpp, stride)
                a = cur[i - bpp:j - bpp] if i else zero[:j - i]
                b = prev[i:j]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = prev[i - bpp:j - bpp] if i else zero[:j - i]
                    pred = _paeth(a, b, c)
                cur[i:j] = (line[i:j] + pred) & 255
        else:
            raise ValueError("PNG: bad scanline filter type")
        prev = cur & 255
        out[y] = prev
    return out


def _filter_rows(img_bytes: np.ndarray, bpp: int, filters) -> np.ndarray:
    """Filter ``(h, stride)`` uint8 rows: row ``y`` by ``filters[y %
    len(filters)]``.  Returns the ``(h, stride + 1)`` stream rows."""
    x = img_bytes.astype(np.int32)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    pred = {0: 0, 1: a, 2: b, 3: (a + b) >> 1, 4: _paeth(a, b, c)}
    kinds = np.array([filters[y % len(filters)] for y in range(len(x))],
                     np.uint8)
    out = np.empty((len(x), x.shape[1] + 1), np.uint8)
    out[:, 0] = kinds
    for f in set(kinds.tolist()):
        rows = kinds == f
        p = pred[f] if f == 0 else pred[f][rows]
        out[rows, 1:] = (x[rows] - p) & 255
    return out


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------


def _chunks(data: bytes):
    pos = 8
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length]
                               or b"\0\0\0\0")
        if len(body) != length or zlib.crc32(tag + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG: chunk {tag!r} is truncated or corrupt")
        yield tag, body
        if tag == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG: no IEND chunk")


def decode_png(data, use_native: bool = True) -> np.ndarray:
    """A PNG byte string → ``(H, W, 3)`` BGR uint8, as ``cv2.imdecode(...,
    cv2.IMREAD_COLOR)`` gives it.  Raises ``ValueError`` on a malformed
    file; an interlaced one goes to ``cv2``."""
    data = bytes(data)
    if not is_png(data):
        raise ValueError("not a PNG file")
    ihdr = plte = None
    idat = []
    for tag, body in _chunks(data):
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
    if ihdr is None or not idat:
        raise ValueError("PNG: no IHDR or IDAT chunk")
    w, h, depth, ctype, comp, filt, interlace = ihdr
    if ctype not in _CHANNELS or depth not in _DEPTHS[ctype] or comp or filt:
        raise ValueError(f"PNG: unsupported bit depth {depth} / colour type "
                         f"{ctype}")
    if ctype == 3 and plte is None:
        raise ValueError("PNG: palette image without PLTE")
    if interlace:
        return _cv2_decode(data)
    ch = _CHANNELS[ctype]
    bits = ch * depth
    stride, bpp = (w * bits + 7) // 8, max(1, bits // 8)
    raw = zlib.decompress(b"".join(idat))
    if len(raw) < h * (stride + 1):
        raise ValueError("PNG: image data is truncated")
    rows = native.png_unfilter_native(raw, h, stride, bpp) if use_native \
        else None
    if rows is None:
        rows = unfilter_np(raw, h, stride, bpp)
    if depth == 16:
        px = rows.reshape(h, w, ch, 2)[..., 0]  # the high byte, >> 8
    elif depth == 8:
        px = rows.reshape(h, w, ch)
    else:  # 1, 2 or 4 bits, one sample a pixel, packed from the high bit
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        px = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
        px = px.reshape(h, -1)[:, :w, None]
        if ctype == 0:
            px = px * (255 // ((1 << depth) - 1))
    if ctype == 3:
        lut = np.zeros((256, 3), np.uint8)
        lut[:len(plte)] = plte[:256]
        rgb = lut[px[..., 0]]
    elif ch in (1, 2):
        rgb = np.repeat(px[..., :1], 3, -1)
    else:
        rgb = px[..., :3]
    return np.ascontiguousarray(rgb[..., ::-1], np.uint8)


def _cv2_decode(data) -> np.ndarray | None:
    cv2 = _cv2()
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)


def imdecode(data) -> np.ndarray | None:
    """Image file bytes → BGR uint8 ``(H, W, 3)``, or None when they do not
    decode (as ``cv2.imdecode``).  PNG is read here; any other format needs
    OpenCV (:class:`OpenCVUnavailable` where it is absent).  Empty data
    does not decode: None, before any OpenCV call (``cv2.imdecode`` raises
    on an empty buffer, where ``cv2.imread`` of an empty file gives None)."""
    data = bytes(data)
    if not data:
        return None
    if is_png(data):
        try:
            return decode_png(data)
        except (ValueError, zlib.error):
            return None
    return _cv2_decode(data)


def imread(path) -> np.ndarray | None:
    """An image file → BGR uint8, or None when it is missing or does not
    decode (as ``cv2.imread``)."""
    p = Path(path)
    if not p.is_file():
        return None
    return imdecode(p.read_bytes())


# ---------------------------------------------------------------------------
# encoding
# ---------------------------------------------------------------------------


def encode_png(img, filters=(0,), level: int = 1) -> bytes:
    """``(H, W)`` gray, ``(H, W, 2)`` gray+alpha, ``(H, W, 3)`` RGB or
    ``(H, W, 4)`` RGBA, uint8 or uint16 (8- or 16-bit samples, in that
    channel order) → PNG bytes; row ``y`` is filtered by ``filters[y %
    len(filters)]`` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    a = np.asarray(img)
    if a.ndim == 2:
        a = a[..., None]
    h, w, ch = a.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    depth = {np.dtype(np.uint8): 8, np.dtype(np.uint16): 16}[a.dtype]
    samples = a.astype(">u2" if depth == 16 else np.uint8)
    rows = np.ascontiguousarray(samples).view(np.uint8).reshape(h, -1)
    stream = _filter_rows(rows, max(1, ch * depth // 8), tuple(filters))

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    return (PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0,
                                         0, 0))
            + chunk(b"IDAT", zlib.compress(stream.tobytes(), level))
            + chunk(b"IEND", b""))


def write_png(path, img, filters=(0,), level: int = 1) -> None:
    """:func:`encode_png` into the file ``path``."""
    Path(path).write_bytes(encode_png(img, filters, level))
