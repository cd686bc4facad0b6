"""The port's image codec: what the JAX package asks of PIL.

JAX decodes files with ``np.asarray(PIL.Image.open(path).convert("RGB"))``
(``bigdl_tpu/dataset/image_folder.py``, ``transform/vision/image.py``,
``dataset/recordio.py``) and resizes with ``PIL.Image.resize(...,
BILINEAR)``. The port has no PIL: ``native/imgcodec.cpp`` decodes and
resizes in C++, written to give the same pixels, and this module binds it.

- :func:`decode` takes the bytes of a JPEG (sequential Huffman, 8-bit, 1
  or 3 components, sampling factors up to 2x2, restart intervals), a PNG
  (colour types 0, 2, 3, 4 and 6 at 8 bits; gray and palette at 1, 2 and
  4 bits; alpha and ``tRNS`` dropped as ``convert("RGB")`` drops them) or
  an uncompressed 24- or 32-bit BMP, and returns (H, W, 3) uint8 RGB. A
  file of a kind it does not decode (progressive, arithmetic-coded, CMYK
  or 12-bit JPEG; 16-bit or interlaced PNG) raises
  :class:`UnsupportedImageError`, naming it; damaged data raises
  ``ValueError``.
- :func:`resize_bilinear` is Pillow's ``ImagingResample`` with the bilinear
  filter, bitwise, on uint8 images of any channel count.
- :func:`encode_png` writes an 8-bit gray or RGB PNG (filter 0, zlib); its
  bytes need not be Pillow's, what decodes from them is the array.

The library is compiled at first use with ``g++ -O3 -ffp-contract=off``
into ``build/native/`` (by ``native.build_so``, as ``native/batchpack.cpp``
is) and loaded through
``ctypes``, which releases the GIL for each call, so a decode pool runs in
parallel as PIL's does. There is no fallback: a build that fails raises.
"""

from __future__ import annotations

import ctypes
import os
import struct
import threading
import zlib

import numpy as np

from bigdl_tpu_torch import native
from bigdl_tpu_torch.native import build_so

_SRC = os.path.join(os.path.dirname(native.__file__), "imgcodec.cpp")
_SO = os.path.join(native._BUILD_DIR, "_imgcodec.so")

_lock = threading.Lock()
_lib = None
build_seconds = None     # wall time of this process's build, None if cached

_UNSUPPORTED = 1          # the C interface's code for a refused kind
_PNG_SIG = b"\x89PNG\r\n\x1a\n"


class UnsupportedImageError(ValueError):
    """An image of a kind the port's codec does not decode (the message
    names it); the decode stage treats it as any unreadable file."""


def _unported(what: str) -> UnsupportedImageError:
    return UnsupportedImageError(
        f"{what} (not ported yet: ROADMAP Queue A.4.2)")


def build() -> str:
    """Compile the codec if its library is missing or older than the
    source; returns the library's path."""
    global build_seconds
    seconds = build_so(_SRC, _SO, ["-ffp-contract=off"])
    if seconds is not None:
        build_seconds = seconds
    return _SO


def _load():
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            c_u8p = ctypes.c_void_p
            i32, i64 = ctypes.c_int32, ctypes.c_int64
            i32p = ctypes.POINTER(ctypes.c_int32)
            lib.bdl_jpeg_info.argtypes = [c_u8p, i64, i32p, i32p, i32p,
                                          ctypes.c_char_p, ctypes.c_int]
            lib.bdl_jpeg_decode.argtypes = [c_u8p, i64, c_u8p, i32, i32,
                                            ctypes.c_char_p, ctypes.c_int]
            lib.bdl_png_unfilter.argtypes = [c_u8p, i64, c_u8p, i32, i32, i32,
                                             i32, c_u8p, i32, ctypes.c_char_p,
                                             ctypes.c_int]
            lib.bdl_resize_bilinear.argtypes = [c_u8p, i32, i32, i32, c_u8p,
                                                i32, i32]
            for f in (lib.bdl_jpeg_info, lib.bdl_jpeg_decode,
                      lib.bdl_png_unfilter, lib.bdl_resize_bilinear):
                f.restype = ctypes.c_int
            _lib = lib
    return _lib


def _raise(rc: int, msg: bytes) -> None:
    text = msg.value.decode("ascii", "replace")
    if rc == _UNSUPPORTED:
        raise _unported(text)
    raise ValueError(text or f"image codec error {rc}")


def _buf(data: bytes):
    return ctypes.cast(ctypes.c_char_p(data), ctypes.c_void_p)


def _decode_jpeg(data: bytes) -> np.ndarray:
    lib = _load()
    err = ctypes.create_string_buffer(200)
    h, w, c = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32()
    src = _buf(data)
    rc = lib.bdl_jpeg_info(src, len(data), ctypes.byref(h), ctypes.byref(w),
                           ctypes.byref(c), err, 200)
    if rc:
        _raise(rc, err)
    out = np.empty((h.value, w.value, 3), np.uint8)
    rc = lib.bdl_jpeg_decode(src, len(data), out.ctypes.data, h.value,
                             w.value, err, 200)
    if rc:
        _raise(rc, err)
    return out


def _png_chunks(data: bytes):
    """``(kind, body)`` of each chunk, the body a view (no copy)."""
    view = memoryview(data)
    pos = len(_PNG_SIG)
    while pos + 8 <= len(data):
        n, kind = struct.unpack_from(">I4s", data, pos)
        if pos + 12 + n > len(data):
            raise ValueError("PNG file is truncated")
        body = view[pos + 8:pos + 8 + n]
        crc = struct.unpack_from(">I", data, pos + 8 + n)[0]
        if zlib.crc32(body, zlib.crc32(kind)) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, body
        pos += 12 + n
        if kind == b"IEND":
            return
    raise ValueError("PNG file is truncated")


def _decode_png(data: bytes) -> np.ndarray:
    header, palette, idat = None, b"", []
    for kind, body in _png_chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = bytes(body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color, _, _, interlace = header
    if interlace:
        raise _unported("interlaced (Adam7) PNG is not supported")
    if depth == 16:
        raise _unported("16-bit PNG is not supported")
    if color not in (0, 2, 3, 4, 6) or depth not in (1, 2, 4, 8) or (
            depth < 8 and color not in (0, 3)):
        raise ValueError(f"PNG colour type {color} at {depth} bits is invalid")
    if color == 3 and not palette:
        raise ValueError("palette PNG without PLTE")
    # the exact size: one output block, returned without a copy under the
    # GIL (a growing buffer is joined under it, serialising a decode pool)
    chans = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    raw = zlib.decompress(idat[0] if len(idat) == 1 else b"".join(idat),
                          bufsize=h * ((w * chans * depth + 7) // 8 + 1))
    out = np.empty((h, w, 3), np.uint8)
    err = ctypes.create_string_buffer(200)
    pal = palette or b"\0"
    rc = _load().bdl_png_unfilter(_buf(raw), len(raw), out.ctypes.data, h, w,
                                  depth, color, _buf(pal), len(palette) // 3,
                                  err, 200)
    if rc:
        _raise(rc, err)
    return out


def _decode_bmp(data: bytes) -> np.ndarray:
    if len(data) < 54:
        raise ValueError("BMP file is truncated")
    offset = struct.unpack("<I", data[10:14])[0]
    hsize = struct.unpack("<I", data[14:18])[0]
    if hsize < 40:
        raise _unported("OS/2 BMP headers are not supported")
    w, h, _, bits, comp = struct.unpack("<iiHHI", data[18:34])
    if comp not in (0, 3) or bits not in (24, 32):
        raise _unported(
            f"BMP of {bits} bits with compression {comp} is not supported "
            f"(uncompressed 24- and 32-bit only)")
    if comp == 3:   # the R, G, B masks follow the 40-byte header's fields
        masks = struct.unpack("<III", data[54:66])
        if bits != 32 or masks != (0xFF0000, 0xFF00, 0xFF):
            raise _unported("BMP bit fields other than BGRX")
    bpp = bits // 8
    stride = (w * bpp + 3) // 4 * 4
    rows = abs(h)
    if offset + stride * rows > len(data):
        raise ValueError("BMP file is truncated")
    px = np.frombuffer(data, np.uint8, stride * rows, offset).reshape(
        rows, stride)[:, :w * bpp].reshape(rows, w, bpp)
    if h > 0:
        px = px[::-1]
    return np.ascontiguousarray(px[:, :, 2::-1])


def decode(data: bytes) -> np.ndarray:
    """The bytes of an image file as (H, W, 3) uint8 RGB, the array
    ``np.asarray(PIL.Image.open(f).convert("RGB"))`` gives."""
    data = bytes(data)
    if data[:2] == b"\xff\xd8":
        return _decode_jpeg(data)
    if data[:8] == _PNG_SIG:
        return _decode_png(data)
    if data[:2] == b"BM":
        return _decode_bmp(data)
    raise UnsupportedImageError(
        "cannot identify the image format (JPEG, PNG and BMP are decoded)")


def decode_file(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode(f.read())


def resize_bilinear(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """Pillow's bilinear ``resize((width, height))`` of a uint8 (H, W) or
    (H, W, C) array."""
    img = np.ascontiguousarray(img, np.uint8)
    squeeze = img.ndim == 2
    src = img[:, :, None] if squeeze else img
    h, w, c = src.shape
    out = np.empty((height, width, c), np.uint8)
    rc = _load().bdl_resize_bilinear(src.ctypes.data, h, w, c,
                                     out.ctypes.data, height, width)
    if rc:
        raise ValueError(f"bad resize arguments {img.shape} -> "
                         f"{(height, width)}")
    return out[:, :, 0] if squeeze else out


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """An 8-bit PNG of a uint8 (H, W), (H, W, 1) or (H, W, 3) array."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"encode_png takes uint8, got {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    if img.ndim == 2:
        color = 0
    elif img.ndim == 3 and img.shape[2] == 3:
        color = 2
    else:
        raise ValueError(f"encode_png takes gray or RGB, got {img.shape}")
    h, w = img.shape[:2]
    rows = np.ascontiguousarray(img).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    return (_PNG_SIG
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))
