"""PNG reading and writing without OpenCV or PIL.

Stands in for ``cv2.imread`` and ``cv2.imwrite`` on PNG files in the JAX
package (``data/cityscapes.py:load_rgb_image``, ``eval_loop.py``,
``test.py``). ``read_png`` decodes 8-bit grey, grey+alpha, RGB, RGBA and
palette images, non-interlaced, with any of the five row filters, and
returns RGB uint8 [H, W, 3] as ``load_rgb_image`` does: grey is replicated,
alpha is dropped (as ``cv2.IMREAD_COLOR`` drops it) and a palette is
expanded. 16-bit, low-bit-depth and interlaced PNGs and anything that is
not a PNG raise a ``ValueError`` that names the file (JPEG frames are read by
``utils/jpeg.py``; ``data/cityscapes.load_rgb_image`` picks the reader by
the file's magic bytes). ``write_png`` writes RGB or grey uint8.

Undoing the row filters is sequential along a row (the Average and Paeth
filters read the byte just written). ``read_png`` undoes them with
``csrc/png_unfilter.c``, a host C function (no device code: a helper of the
data path, not a port of a TPU kernel) that ``kernels/build.py`` builds with
the host C compiler on first use, on any machine; it raises when the
function cannot be built. ``unfilter_numpy`` is its plain twin, which walks
the image in anti-diagonals of pixels (every pixel of one diagonal depends
only on earlier diagonals) and which the tests hold it to. ``write_png``
filters each row as libpng does by default: the filter whose bytes, read
as signed, have the least sum of magnitudes.
"""

from __future__ import annotations

import ctypes
import functools
import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_JPEG_SOI = b"\xff\xd8\xff"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}      # colour type -> samples a pixel


def unfilter_numpy(data: np.ndarray, height: int, rowbytes: int, bpp: int) -> np.ndarray:
    """Undo the PNG row filters: ``data`` is the inflated stream, ``height``
    rows of a filter-type byte and ``rowbytes`` filtered bytes; ``bpp`` is
    the bytes of one pixel. Returns uint8 [height, rowbytes]."""
    rows = np.asarray(data, np.uint8).reshape(height, rowbytes + 1)
    ftype = rows[:, 0].astype(np.int64)
    if (ftype > 4).any():
        raise ValueError(f"unknown PNG filter type {int(ftype.max())}")
    width = rowbytes // bpp
    raw = rows[:, 1:].reshape(height, width, bpp).astype(np.int32)
    # out[r + 1, c + 1] is pixel (r, c); row 0 and column 0 are the zeros the
    # filters read outside the image
    out = np.zeros((height + 1, width + 1, bpp), np.int32)
    for t in range(height + width - 1):
        r = np.arange(max(0, t - width + 1), min(height, t + 1))
        c = t - r
        x, f = raw[r, c], ftype[r][:, None]
        a, b, cc = out[r + 1, c], out[r, c + 1], out[r, c]
        p = a + b - cc
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - cc)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, cc))
        pred = np.choose(f, (np.zeros_like(a), a, b, (a + b) >> 1, paeth))
        out[r + 1, c + 1] = (x + pred) & 255
    return out[1:, 1:].reshape(height, rowbytes).astype(np.uint8)


def filter_rows(rows: np.ndarray, bpp: int, types=None) -> np.ndarray:
    """The PNG stream of uint8 rows [H, R] (``bpp`` bytes a pixel): a
    filter-type byte and R filtered bytes a row, uint8 [H, R + 1]. ``types``
    gives each row's filter; by default each row takes the filter that
    libpng's heuristic picks (least sum of |filtered byte| read as int8)."""
    x = np.asarray(rows, np.uint8).astype(np.int16)
    left = np.pad(x, ((0, 0), (bpp, 0)))[:, :-bpp]
    up = np.pad(x, ((1, 0), (0, 0)))[:-1]
    ul = np.pad(up, ((0, 0), (bpp, 0)))[:, :-bpp]
    p = left + up - ul
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
    filtered = np.stack([x, x - left, x - up, x - ((left + up) >> 1), x - paeth]).astype(np.uint8)
    if types is None:
        types = np.abs(filtered.view(np.int8).astype(np.int64)).sum(-1).argmin(0)
    types = np.asarray(types, np.int64)
    out = np.empty((x.shape[0], x.shape[1] + 1), np.uint8)
    out[:, 0] = types
    out[:, 1:] = filtered[types, np.arange(x.shape[0])]
    return out


@functools.cache
def _native_unfilter():
    from instance_segmentation_torch.kernels import build
    fn = build.load("png_unfilter").iseg_png_unfilter
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def unfilter_native(data: np.ndarray, height: int, rowbytes: int, bpp: int) -> np.ndarray:
    """``unfilter_numpy`` by the C function of ``csrc/png_unfilter.c``."""
    src = np.ascontiguousarray(data, np.uint8)
    if src.size != height * (rowbytes + 1):
        raise ValueError(f"PNG stream holds {src.size} bytes, want {height * (rowbytes + 1)}")
    out = np.empty((height, rowbytes), np.uint8)
    bad = _native_unfilter()(src.ctypes.data, height, rowbytes, bpp, out.ctypes.data)
    if bad:
        raise ValueError(f"unknown PNG filter type {bad - 1}")
    return out


def _chunks(blob: bytes):
    pos = len(SIGNATURE)
    while pos + 8 <= len(blob):
        length, kind = struct.unpack(">I4s", blob[pos:pos + 8])
        data = blob[pos + 8:pos + 8 + length]
        if len(data) != length:
            raise ValueError("truncated chunk")
        yield kind, data
        pos += 12 + length


def _header(blob: bytes, path: str):
    if blob[:3] == _JPEG_SOI:
        raise ValueError(f"{path}: a JPEG file, not a PNG (utils.jpeg.read_jpeg reads it)")
    if blob[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    kind, data = next(_chunks(blob), (None, b""))
    if kind != b"IHDR" or len(data) != 13:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    width, height, depth, color, _comp, _filt, interlace = struct.unpack(">IIBBBBB", data)
    if color not in _CHANNELS:
        raise ValueError(f"{path}: PNG colour type {color} is not valid")
    if depth != 8:
        raise ValueError(f"{path}: {depth}-bit PNG is not read (8-bit only)")
    if interlace:
        raise ValueError(f"{path}: interlaced PNG is not read")
    return width, height, color


def inflate(path: str):
    """The inflated, still filtered stream of the PNG at ``path``: (uint8
    stream, height, rowbytes, bytes a pixel, colour type, palette or None)."""
    with open(path, "rb") as f:
        blob = f.read()
    width, height, color = _header(blob, path)
    idat, palette = [], None
    for kind, data in _chunks(blob):
        if kind == b"IDAT":
            idat.append(data)
        elif kind == b"PLTE":
            palette = np.frombuffer(data, np.uint8).reshape(-1, 3)
        elif kind == b"IEND":
            break
    try:
        stream = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as exc:
        raise ValueError(f"{path}: corrupt PNG data ({exc})") from exc
    channels = _CHANNELS[color]
    rowbytes = width * channels
    if stream.size != height * (rowbytes + 1):
        raise ValueError(f"{path}: PNG data holds {stream.size} bytes, "
                         f"want {height * (rowbytes + 1)}")
    return stream, height, rowbytes, channels, color, palette


def read_png(path: str) -> np.ndarray:
    """RGB uint8 [H, W, 3] of the PNG at ``path`` (see the module's
    docstring)."""
    stream, height, rowbytes, channels, color, palette = inflate(path)
    try:
        pixels = unfilter_native(stream, height, rowbytes, channels)
    except ValueError as exc:
        raise ValueError(f"{path}: {exc}") from exc
    pixels = pixels.reshape(height, rowbytes // channels, channels)
    if color == 3:
        if palette is None:
            raise ValueError(f"{path}: palette PNG without a PLTE chunk")
        index = pixels[..., 0]
        if int(index.max(initial=0)) >= len(palette):
            raise ValueError(f"{path}: palette index past the PLTE chunk")
        return palette[index]
    if color in (0, 4):
        return np.repeat(pixels[..., :1], 3, axis=2)
    return np.ascontiguousarray(pixels[..., :3])


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """Write uint8 [H, W, 3] (RGB) or [H, W] / [H, W, 1] (grey) as a PNG,
    each row filtered as ``filter_rows`` picks, at zlib's default level 6
    (libpng's)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8, got {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        color = 0
    elif img.ndim == 3 and img.shape[2] == 3:
        color = 2
    else:
        raise ValueError(f"write_png takes [H, W, 3] or [H, W], got {img.shape}")
    height, width = img.shape[:2]
    raw = filter_rows(np.ascontiguousarray(img).reshape(height, -1), 1 if color == 0 else 3)
    head = struct.pack(">IIBBBBB", width, height, 8, color, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(SIGNATURE + _chunk(b"IHDR", head)
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + _chunk(b"IEND", b""))
