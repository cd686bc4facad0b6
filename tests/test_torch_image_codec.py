"""The port's image codec (``bigdl_tpu_torch/transform/vision/codec.py``,
``native/imgcodec.cpp``) against PIL, bitwise.

- JPEG: files PIL writes here (qualities 10 to 100, 4:4:4, 4:2:2, 4:2:0,
  restart intervals, odd sizes such as 17x33, gray) and files of a small
  baseline encoder below for the sampling factors PIL does not write (4:4:0,
  mixed chroma factors, Adobe RGB), decoded as
  ``np.asarray(PIL.Image.open(f).convert("RGB"))``;
- PNG of every colour type and bit depth the codec takes, with alpha and
  ``tRNS``, and 24- and 32-bit BMPs;
- the refusals: progressive, arithmetic-coded, CMYK and 12-bit JPEG, 16-bit
  and interlaced PNG raise ``UnsupportedImageError``;
- Pillow's bilinear resize, on up- and down-scales;
- the fixtures under ``tests/torch_image_fixtures/``: the table of the
  SHA-256 and shape of PIL's decode of each file, which ``chip_smoke.py``
  holds the port's decode against on the card.

Regenerate the fixtures with ``PYTHONPATH=. python
tests/test_torch_image_codec.py``.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
from PIL import Image

from bigdl_tpu_torch.transform.vision import codec
from bigdl_tpu_torch.transform.vision.codec import UnsupportedImageError

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "torch_image_fixtures")
TABLE = os.path.join(FIXTURES, "fixtures.json")


def pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def smooth(rng, h, w, c=3) -> np.ndarray:
    """A photo-like image: smoothed noise plus a gradient."""
    a = rng.integers(0, 256, (h, w, c)).astype(np.float32)
    for _ in range(3):
        a = (a + np.roll(a, 1, 0) + np.roll(a, 1, 1)) / 3
    a += np.linspace(-40, 40, w, dtype=np.float32)[None, :, None]
    return np.clip(a, 0, 255).astype(np.uint8)


def pil_bytes(arr, fmt, **kw) -> bytes:
    b = io.BytesIO()
    (arr if isinstance(arr, Image.Image) else Image.fromarray(arr)).save(
        b, fmt, **kw)
    return b.getvalue()


# ------------------------------------------- a small baseline JPEG encoder
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
_DCT = np.array([[np.sqrt((1 if k == 0 else 2) / 8)
                  * np.cos((2 * n + 1) * k * np.pi / 16) for n in range(8)]
                 for k in range(8)])


def _huff(symbols, length):
    """A canonical code giving every symbol ``length`` bits."""
    bits = [0] * 17
    bits[length] = len(symbols)
    codes = {s: (i, length) for i, s in enumerate(symbols)}
    return bits[1:], list(symbols), codes


_DC = _huff(list(range(12)), 4)
_AC = _huff([(r << 4) | s for r in range(16) for s in range(1, 11)]
            + [0x00, 0xF0], 8)


class _Bits:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value, n):
        for i in range(n - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)
                self.acc, self.n = 0, 0

    def flush(self):
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)


def _magnitude(v):
    s = int(abs(v)).bit_length()
    return s, (v if v >= 0 else v + (1 << s) - 1)


def encode_jpeg(rgb: np.ndarray, sampling, restart: int = 0,
                adobe_rgb: bool = False, q: int = 6) -> bytes:
    """Baseline JPEG of ``rgb`` with per-component ``sampling`` factors
    ((h, v) each), optional restart interval, YCbCr (JFIF) or Adobe RGB."""
    h, w, _ = rgb.shape
    x = rgb.astype(np.float64)
    if adobe_rgb:
        planes = [x[..., 0], x[..., 1], x[..., 2]]
    else:
        planes = [0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2],
                  -0.168736 * x[..., 0] - 0.331264 * x[..., 1]
                  + 0.5 * x[..., 2] + 128,
                  0.5 * x[..., 0] - 0.418688 * x[..., 1]
                  - 0.081312 * x[..., 2] + 128]
    hm = max(s[0] for s in sampling)
    vm = max(s[1] for s in sampling)
    mcux, mcuy = -(-w // (8 * hm)), -(-h // (8 * vm))
    comps = []
    for p, (ch, cv) in zip(planes, sampling):
        fx, fy = hm // ch, vm // cv
        pw, ph = -(-w // fx) * fx, -(-h // fy) * fy
        p = np.pad(p, ((0, ph - h), (0, pw - w)), mode="edge")
        p = p.reshape(ph // fy, fy, pw // fx, fx).mean(axis=(1, 3))
        tw, th = mcux * ch * 8, mcuy * cv * 8
        comps.append(np.pad(p, ((0, th - p.shape[0]), (0, tw - p.shape[1])),
                            mode="edge"))
    bits, pred = _Bits(), [0, 0, 0]

    def block(ci, bx, by):
        b = comps[ci][by * 8:by * 8 + 8, bx * 8:bx * 8 + 8] - 128
        coef = np.round((_DCT @ b @ _DCT.T).reshape(64)[_ZIGZAG] / q).astype(int)
        diff = coef[0] - pred[ci]
        pred[ci] = coef[0]
        s, v = _magnitude(diff)
        bits.put(*_DC[2][s])
        bits.put(v, s)
        run = 0
        last = max([k for k in range(1, 64) if coef[k]] or [0])
        for k in range(1, last + 1):
            if coef[k] == 0:
                run += 1
                continue
            while run > 15:
                bits.put(*_AC[2][0xF0])
                run -= 16
            s, v = _magnitude(coef[k])
            bits.put(*_AC[2][(run << 4) | s])
            bits.put(v, s)
            run = 0
        if last < 63:
            bits.put(*_AC[2][0x00])

    n_mcu, rst = 0, 0
    for my in range(mcuy):
        for mx in range(mcux):
            if restart and n_mcu and n_mcu % restart == 0:
                bits.flush()
                bits.out += bytes([0xFF, 0xD0 + rst % 8])
                rst += 1
                pred[:] = [0, 0, 0]
            for ci, (ch, cv) in enumerate(sampling):
                for v in range(cv):
                    for u in range(ch):
                        block(ci, mx * ch + u, my * cv + v)
            n_mcu += 1
    bits.flush()

    def seg(marker, body):
        return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body

    out = b"\xff\xd8"
    if adobe_rgb:
        out += seg(0xEE, b"Adobe" + bytes([0, 100, 0, 0, 0, 0, 0]))
    else:
        out += seg(0xE0, b"JFIF\0\x01\x01\0\0\x01\0\x01\0\0")
    out += seg(0xDB, bytes([0]) + bytes([q] * 64))
    ids = (82, 71, 66) if adobe_rgb else (1, 2, 3)
    out += seg(0xC0, struct.pack(">BHHB", 8, h, w, 3) + b"".join(
        bytes([i, (ch << 4) | cv, 0]) for i, (ch, cv) in zip(ids, sampling)))
    out += seg(0xC4, bytes([0x00] + _DC[0]) + bytes(_DC[1]))
    out += seg(0xC4, bytes([0x10] + _AC[0]) + bytes(_AC[1]))
    if restart:
        out += seg(0xDD, struct.pack(">H", restart))
    out += seg(0xDA, bytes([3]) + b"".join(bytes([i, 0]) for i in ids)
               + bytes([0, 63, 0]))
    return out + bytes(bits.out) + b"\xff\xd9"


# ------------------------------------------------------------------- JPEG
@pytest.mark.parametrize("hw", [(17, 33), (33, 17), (8, 8), (1, 1), (31, 5),
                                (64, 48)])
@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("quality", [10, 75, 100])
def test_jpeg_pil_written_decodes_bitwise(hw, subsampling, quality):
    rng = np.random.default_rng(hash((hw, subsampling, quality)) % 2**32)
    arr = smooth(rng, *hw) if quality > 10 else rng.integers(
        0, 256, hw + (3,), dtype=np.uint8)
    data = pil_bytes(arr, "JPEG", quality=quality, subsampling=subsampling)
    np.testing.assert_array_equal(codec.decode(data), pil_rgb(data))


@pytest.mark.parametrize("restart", [dict(restart_marker_blocks=1),
                                     dict(restart_marker_blocks=3),
                                     dict(restart_marker_rows=1)])
@pytest.mark.parametrize("subsampling", [0, 2])
def test_jpeg_restart_intervals(restart, subsampling):
    arr = smooth(np.random.default_rng(5), 40, 72)
    data = pil_bytes(arr, "JPEG", quality=85, subsampling=subsampling,
                     **restart)
    assert b"\xff\xdd" in data
    np.testing.assert_array_equal(codec.decode(data), pil_rgb(data))


@pytest.mark.parametrize("hw", [(17, 33), (64, 64)])
def test_jpeg_gray_replicates_to_rgb(hw):
    arr = smooth(np.random.default_rng(2), *hw)[:, :, 0]
    data = pil_bytes(arr, "JPEG", quality=80)
    got = codec.decode(data)
    np.testing.assert_array_equal(got, pil_rgb(data))
    assert (got[..., 0] == got[..., 2]).all()


@pytest.mark.parametrize("sampling,kw", [
    (((1, 2), (1, 1), (1, 1)), {}),                 # 4:4:0
    (((2, 2), (1, 2), (2, 1)), {}),                 # mixed chroma factors
    (((2, 1), (1, 1), (1, 1)), {"restart": 2}),     # 4:2:2, restarts
    (((2, 2), (1, 1), (1, 1)), {"restart": 1}),     # 4:2:0, restarts
    (((1, 1), (1, 1), (1, 1)), {"adobe_rgb": True}),
    (((2, 2), (2, 2), (1, 1)), {}),
])
@pytest.mark.parametrize("hw", [(17, 33), (24, 40)])
def test_jpeg_sampling_factors_pil_cannot_write(sampling, kw, hw):
    arr = smooth(np.random.default_rng(7), *hw)
    data = encode_jpeg(arr, sampling, **kw)
    np.testing.assert_array_equal(codec.decode(data), pil_rgb(data))


# -------------------------------------------------------------- PNG, BMP
def _png_cases():
    rng = np.random.default_rng(3)
    rgb = rng.integers(0, 256, (13, 29, 3), dtype=np.uint8)
    rgba = rng.integers(0, 256, (13, 29, 4), dtype=np.uint8)
    g = rgb[:, :, 0]
    cases = {
        "rgb": (Image.fromarray(rgb), {}),
        "rgb-optimized": (Image.fromarray(rgb), {"optimize": True}),
        "gray8": (Image.fromarray(g), {}),
        "rgba": (Image.fromarray(rgba), {}),
        "gray-alpha": (Image.fromarray(g).convert("LA"), {}),
        "palette8": (Image.fromarray(rgb).convert("P"), {}),
        "gray1": (Image.fromarray(g > 128), {}),
        "rgb-tRNS": (Image.fromarray(rgb), {"transparency": (1, 2, 3)}),
        "gray-tRNS": (Image.fromarray(g), {"transparency": 5}),
    }
    for bits in (1, 2, 4):
        cases[f"palette{bits}"] = (Image.fromarray(rgb).quantize(
            colors=2 ** bits), {"bits": bits})
        cases[f"gray{bits}b"] = (Image.fromarray(
            g >> (8 - bits) << (8 - bits)), {"bits": bits})
    return cases


PNG_CASES = _png_cases()


@pytest.mark.parametrize("name", sorted(PNG_CASES))
def test_png_decodes_bitwise(name):
    im, kw = PNG_CASES[name]
    data = pil_bytes(im, "PNG", **kw)
    np.testing.assert_array_equal(codec.decode(data), pil_rgb(data))


def test_png_bit_depths_are_written_as_named():
    depth = {n: pil_bytes(im, "PNG", **kw)[24]
             for n, (im, kw) in PNG_CASES.items()}
    assert (depth["palette1"], depth["palette2"], depth["palette4"]) == \
        (1, 2, 4)
    assert depth["gray1"] == 1


@pytest.mark.parametrize("channels", [3, 4])
def test_bmp_decodes_bitwise(channels):
    arr = np.random.default_rng(4).integers(0, 256, (11, 7, channels),
                                            dtype=np.uint8)
    data = pil_bytes(arr, "BMP")
    np.testing.assert_array_equal(codec.decode(data), pil_rgb(data))


def test_png_writer_round_trips():
    rng = np.random.default_rng(6)
    for arr in (rng.integers(0, 256, (20, 30, 3), dtype=np.uint8),
                rng.integers(0, 256, (9, 4), dtype=np.uint8)):
        data = codec.encode_png(arr)
        want = arr if arr.ndim == 3 else np.repeat(arr[:, :, None], 3, 2)
        np.testing.assert_array_equal(codec.decode(data), want)
        np.testing.assert_array_equal(np.asarray(Image.open(
            io.BytesIO(data))), arr)


# --------------------------------------------------------------- refusals
def _patched_png(**header):
    data = bytearray(pil_bytes(np.zeros((4, 4, 3), np.uint8), "PNG"))
    ihdr = list(struct.unpack(">IIBBBBB", data[16:29]))
    for k, v in header.items():
        ihdr[{"depth": 2, "interlace": 6}[k]] = v
    body = struct.pack(">IIBBBBB", *ihdr)
    data[16:29] = body
    data[29:33] = struct.pack(">I", zlib.crc32(b"IHDR" + body) & 0xFFFFFFFF)
    return bytes(data)


def _patched_jpeg(marker=None, precision=None):
    data = bytearray(pil_bytes(np.zeros((8, 8, 3), np.uint8), "JPEG"))
    sof = data.index(b"\xff\xc0")
    if marker is not None:
        data[sof + 1] = marker
    if precision is not None:
        data[sof + 4] = precision
    return bytes(data)


@pytest.mark.parametrize("name,data,match", [
    ("progressive", lambda: pil_bytes(np.zeros((16, 16, 3), np.uint8),
                                      "JPEG", progressive=True),
     "progressive"),
    ("cmyk", lambda: pil_bytes(Image.new("CMYK", (8, 8)), "JPEG"), "CMYK"),
    ("12-bit", lambda: _patched_jpeg(precision=12), "12-bit"),
    ("arithmetic", lambda: _patched_jpeg(marker=0xC9), "arithmetic"),
    ("png-16", lambda: _patched_png(depth=16), "16-bit"),
    ("png-interlaced", lambda: _patched_png(interlace=1), "interlaced"),
    ("unknown", lambda: b"GIF89a" + bytes(20), "cannot identify"),
])
def test_unsupported_kinds_raise_naming_what(name, data, match):
    with pytest.raises(UnsupportedImageError, match=match) as e:
        codec.decode(data())
    assert ("Queue A.4.2" in str(e.value)) == (name != "unknown")


def test_damaged_files_raise_value_error():
    data = pil_bytes(smooth(np.random.default_rng(1), 32, 32), "PNG")
    with pytest.raises(ValueError):
        codec.decode(data[:len(data) // 2])
    jpg = pil_bytes(smooth(np.random.default_rng(1), 32, 32), "JPEG")
    with pytest.raises(ValueError):
        codec.decode(jpg[:40])


def _first_dc_table(jpg: bytes) -> int:
    """Offset of the 16 code counts of the file's first DC Huffman table."""
    pos = jpg.index(b"\xff\xc4")
    assert jpg[pos + 4] >> 4 == 0, "the first table PIL writes is a DC one"
    return pos + 5


@pytest.mark.parametrize("damage", ["over_subscribed", "all_ones_code",
                                    "dc_symbol_200"])
def test_damaged_huffman_tables_raise_value_error(damage):
    """A DHT that libjpeg rejects is refused as damaged data (PIL refuses
    the same file): code counts that do not fit their lengths would write
    past the decoder's lookahead table, a DC symbol above 15 would shift
    by more than a word."""
    jpg = bytearray(pil_bytes(smooth(np.random.default_rng(1), 32, 32),
                              "JPEG"))
    at = _first_dc_table(bytes(jpg))
    counts = list(jpg[at:at + 16])
    if damage == "dc_symbol_200":
        jpg[at + 16] = 200
    else:   # move codes to length 1; the table keeps its symbol count
        ones = 3 if damage == "over_subscribed" else 2
        moved = ones - counts[0]
        counts[0] = ones
        for i in range(1, 16):
            take = min(moved, counts[i])
            counts[i] -= take
            moved -= take
        assert moved == 0
        jpg[at:at + 16] = bytes(counts)
    with pytest.raises(Exception):
        Image.open(io.BytesIO(bytes(jpg))).convert("RGB")
    with pytest.raises(ValueError, match="Huffman"):
        codec.decode(bytes(jpg))


# ----------------------------------------------------------------- resize
@pytest.mark.parametrize("shape,out", [
    ((280, 280, 3), (256, 256)),      # the synthetic folder's AspectScale
    ((375, 500, 3), (256, 341)),      # ImageNet's typical shape
    ((17, 33, 3), (40, 50)),
    ((64, 64, 3), (224, 224)),
    ((100, 30, 3), (7, 301)),
    ((5, 5, 3), (5, 9)),
    ((9, 9, 3), (9, 9)),
    ((1, 7, 1), (3, 2)),
    ((40, 60), (13, 17)),
])
def test_resize_matches_pil_bilinear(shape, out):
    arr = np.random.default_rng(8).integers(0, 256, shape, dtype=np.uint8)
    src = arr[:, :, 0] if arr.ndim == 3 and arr.shape[2] == 1 else arr
    want = np.asarray(Image.fromarray(src).resize(out[::-1],
                                                  Image.BILINEAR))
    got = codec.resize_bilinear(arr, *out)
    np.testing.assert_array_equal(got.reshape(want.shape), want)


def test_decode_pool_gives_the_serial_arrays():
    rng = np.random.default_rng(9)
    files = [pil_bytes(smooth(rng, 40, 56), "JPEG", quality=90)
             for _ in range(8)]
    with ThreadPoolExecutor(4) as ex:
        par = list(ex.map(codec.decode, files * 4))
    for a, data in zip(par, files * 4):
        np.testing.assert_array_equal(a, pil_rgb(data))


# --------------------------------------------------------------- fixtures
def _table():
    with open(TABLE) as f:
        return json.load(f)


FIXTURE_NAMES = sorted(n for n in os.listdir(FIXTURES)
                       if n != "fixtures.json") \
    if os.path.isdir(FIXTURES) else []


def test_fixture_table_covers_every_fixture():
    assert sorted(_table()) == FIXTURE_NAMES and FIXTURE_NAMES


@pytest.mark.parametrize("name", FIXTURE_NAMES)
def test_fixture_table_is_pils_decode_and_the_port_matches(name):
    entry = _table()[name]
    with open(os.path.join(FIXTURES, name), "rb") as f:
        data = f.read()
    want = pil_rgb(data)
    assert list(want.shape) == entry["shape"]
    assert hashlib.sha256(want.tobytes()).hexdigest() == entry["sha256"]
    np.testing.assert_array_equal(codec.decode(data), want)


def test_fixtures_stay_small():
    total = sum(os.path.getsize(os.path.join(FIXTURES, n))
                for n in os.listdir(FIXTURES))
    assert total < 300 * 1024


def write_fixtures() -> None:
    """(Re)write ``tests/torch_image_fixtures/`` and its table."""
    os.makedirs(FIXTURES, exist_ok=True)
    rng = np.random.default_rng(2024)
    files = {
        "jpeg_444_q90.jpg": pil_bytes(smooth(rng, 48, 64), "JPEG",
                                      quality=90, subsampling=0),
        "jpeg_422_q75.jpg": pil_bytes(smooth(rng, 48, 64), "JPEG",
                                      quality=75, subsampling=1),
        "jpeg_420_q50.jpg": pil_bytes(smooth(rng, 48, 64), "JPEG",
                                      quality=50, subsampling=2),
        "jpeg_420_restart.jpg": pil_bytes(smooth(rng, 40, 72), "JPEG",
                                          quality=85, subsampling=2,
                                          restart_marker_blocks=2),
        "jpeg_420_17x33.jpg": pil_bytes(smooth(rng, 17, 33), "JPEG",
                                        quality=95, subsampling=2),
        "jpeg_gray.jpg": pil_bytes(smooth(rng, 30, 41)[:, :, 0], "JPEG",
                                   quality=80),
        "jpeg_440.jpg": encode_jpeg(smooth(rng, 24, 40),
                                    ((1, 2), (1, 1), (1, 1))),
        "jpeg_420_500x375.jpg": pil_bytes(smooth(rng, 375, 500), "JPEG",
                                          quality=75, subsampling=2),
        "png_rgb.png": pil_bytes(smooth(rng, 31, 47), "PNG"),
        "png_rgba.png": pil_bytes(smooth(rng, 20, 20, 4), "PNG"),
        "png_palette4.png": pil_bytes(Image.fromarray(smooth(rng, 25, 19))
                                      .quantize(colors=16), "PNG", bits=4),
        "png_gray2.png": pil_bytes(Image.fromarray(
            smooth(rng, 18, 22)[:, :, 0] & 0xC0), "PNG", bits=2),
        "bmp24.bmp": pil_bytes(smooth(rng, 15, 21), "BMP"),
    }
    table = {}
    for name, data in files.items():
        with open(os.path.join(FIXTURES, name), "wb") as f:
            f.write(data)
        arr = pil_rgb(data)
        table[name] = {"sha256": hashlib.sha256(arr.tobytes()).hexdigest(),
                       "shape": list(arr.shape)}
    with open(TABLE, "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    write_fixtures()
