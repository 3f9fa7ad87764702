"""JPEG reading and writing without OpenCV or PIL.

Stands in for ``cv2.imread`` and ``cv2.imwrite`` on JPEG files in the JAX
package (``data/cityscapes.py:load_rgb_image``, ``data/coco.py``,
``test.py``). ``read_jpeg`` returns RGB uint8 [H, W, 3] equal, bit for bit,
to ``cv2.imread(path)[..., ::-1]`` with OpenCV's bundled libjpeg-turbo: it
reads baseline, extended-sequential and progressive Huffman JPEGs of 8-bit
samples with one or three components at sampling factors 1 and 2 (and any
integer ratio, replicated), restart intervals, sizes that are not whole
MCUs, and applies the EXIF orientation tag as ``imread`` does. Grey frames
are replicated to three channels. Arithmetic coding, lossless and
hierarchical frames, 12- and 16-bit samples, four-component (CMYK/YCCK)
and two-component frames and fractional sampling ratios raise a
``ValueError`` that names the file.

``write_jpeg`` / ``encode_jpeg`` write a baseline JPEG as ``cv2.imwrite``
does at its defaults (a JFIF APP0 header, the standard Huffman tables, no
optimisation, YCbCr 4:2:0 for colour, the quality-scaled standard
quantisation tables): byte for byte the file ``cv2.imwrite`` writes, at
any ``quality``.

This module parses and writes the markers; the entropy coding, the DCTs,
the chroma resampling and the colour conversion are the C functions of
``csrc/jpeg_codec.c`` (host code, no device code), built by
``kernels/build.py`` with the host C compiler on first use, on any machine.
There is no numpy fallback: reading or writing raises when the C file
cannot be built.
"""

from __future__ import annotations

import ctypes
import functools
import struct

import numpy as np

SOI = b"\xff\xd8\xff"

# jpeg_natural_order: the natural (row-major) index of each zigzag position
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63], np.int64)

# The JPEG standard's example tables (ITU T.81 K.1, K.2, K.3), which
# libjpeg's jpeg_set_defaults installs; quantisation tables in natural order
STD_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99], np.int64)
STD_CHROMA_Q = np.full(64, 99, np.int64)
STD_CHROMA_Q.reshape(8, 8)[:4, :4] = [[17, 18, 24, 47], [18, 21, 26, 66],
                                      [24, 26, 56, 99], [47, 66, 99, 99]]
_AC_LUMA_VALS = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a43444546474849"
    "4a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
    "f9fa")
_AC_CHROMA_VALS = bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa")
STD_HUFFMAN = {   # (class, id): (16 code counts, symbols)
    (0, 0): (bytes([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]), bytes(range(12))),
    (1, 0): (bytes([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D]), _AC_LUMA_VALS),
    (0, 1): (bytes([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0]), bytes(range(12))),
    (1, 1): (bytes([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77]), _AC_CHROMA_VALS),
}
_UNSUPPORTED_SOF = {0xC3: "lossless", 0xC5: "hierarchical", 0xC6: "hierarchical",
                    0xC7: "hierarchical lossless", 0xC9: "arithmetic-coded",
                    0xCA: "arithmetic-coded progressive", 0xCB: "arithmetic-coded lossless",
                    0xCD: "arithmetic-coded hierarchical", 0xCE: "arithmetic-coded hierarchical",
                    0xCF: "arithmetic-coded hierarchical lossless"}

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64


@functools.cache
def _lib():
    from instance_segmentation_torch.kernels import build
    lib = build.load("jpeg_codec")
    lib.iseg_jpeg_decode_scan.argtypes = [_P, _I64, _I64, _P, _I, _P, _P, _P]
    lib.iseg_jpeg_decode_scan.restype = _I64
    lib.iseg_jpeg_idct.argtypes = [_P, _I, _I, _P, _P]
    lib.iseg_jpeg_idct.restype = None
    lib.iseg_jpeg_upsample.argtypes = [_P, _I64, _I, _I, _I, _I, _P, _I, _I]
    lib.iseg_jpeg_upsample.restype = None
    lib.iseg_jpeg_ycc_to_rgb.argtypes = [_P, _P, _P, _I64, _P]
    lib.iseg_jpeg_ycc_to_rgb.restype = None
    lib.iseg_jpeg_encode.argtypes = [_P, _I, _I, _I, _P, _P, _P, _P, _I64]
    lib.iseg_jpeg_encode.restype = _I64
    return lib


def is_jpeg(head: bytes) -> bool:
    return head[:3] == SOI


# ------------------------------------------------------------------ reading

def _exif_orientation(seg: bytes) -> int:
    """The orientation tag (0x0112) of IFD0 of an APP1 Exif segment, else 1."""
    tiff = seg[6:]
    if len(tiff) < 8 or tiff[:2] not in (b"II", b"MM"):
        return 1
    e = "<" if tiff[:2] == b"II" else ">"
    ifd = struct.unpack(e + "I", tiff[4:8])[0]
    if ifd + 2 > len(tiff):
        return 1
    for i in range(struct.unpack(e + "H", tiff[ifd:ifd + 2])[0]):
        entry = tiff[ifd + 2 + 12 * i: ifd + 14 + 12 * i]
        if len(entry) < 12:
            break
        tag, kind = struct.unpack(e + "HH", entry[:4])
        if tag == 0x0112 and kind == 3:
            return struct.unpack(e + "H", entry[8:10])[0]
    return 1


def apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """OpenCV's ``ApplyExifOrientation`` (EXIF tag 0x0112, values 1..8)."""
    if orientation in (5, 6, 7, 8):
        img = img.transpose(1, 0, *range(2, img.ndim))
    flips = {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}.get(orientation, ())
    if flips:
        img = np.flip(img, flips)
    return np.ascontiguousarray(img)


class _Frame:
    def __init__(self, seg: bytes, progressive: bool, name: str):
        precision, self.height, self.width, n = struct.unpack(">BHHB", seg[:6])
        if precision != 8:
            raise ValueError(f"{name}: {precision}-bit JPEG is not read (8-bit only)")
        if n == 4:
            raise ValueError(f"{name}: CMYK/YCCK JPEG is not read")
        if n not in (1, 3):
            raise ValueError(f"{name}: JPEG with {n} components is not read")
        if self.height == 0 or self.width == 0:
            raise ValueError(f"{name}: JPEG frame of size {self.width}x{self.height} "
                             "(a DNL marker) is not read")
        self.progressive = progressive
        self.ids, self.h, self.v, self.tq = [], [], [], []
        for i in range(n):
            cid, hv, tq = seg[6 + 3 * i: 9 + 3 * i]
            self.ids.append(cid)
            self.h.append(hv >> 4)
            self.v.append(hv & 15)
            self.tq.append(tq)
        if min(self.h + self.v) < 1 or max(self.h + self.v) > 4:
            raise ValueError(f"{name}: JPEG sampling factors {self.h}x{self.v} are not valid")
        hmax, vmax = max(self.h), max(self.v)
        if any(hmax % h or vmax % v for h, v in zip(self.h, self.v)):
            raise ValueError(f"{name}: fractional JPEG sampling ratios are not read")
        self.mcux = -(-self.width // (8 * hmax))
        self.mcuy = -(-self.height // (8 * vmax))
        self.cw = [-(-self.width * h // hmax) for h in self.h]
        self.ch = [-(-self.height * v // vmax) for v in self.v]
        # blocks of each component's coefficient array: whole MCUs, which
        # cover a one-component scan's blocks (ceil(cw / 8) <= mcux * h) too
        self.cols = [self.mcux * h for h in self.h]
        self.rows = [self.mcuy * v for v in self.v]
        self.offset = np.cumsum([0] + [r * c for r, c in zip(self.rows, self.cols)])
        self.coefs = np.zeros((int(self.offset[-1]), 64), np.int16)
        self.qtables = [None] * n


def decode_jpeg(blob: bytes, name: str = "<bytes>") -> np.ndarray:
    """RGB uint8 [H, W, 3] of the JPEG file ``blob`` (see the module's
    docstring); ``name`` is the path named by an error."""
    if not is_jpeg(blob):
        raise ValueError(f"{name}: not a JPEG file")
    lib = _lib()
    data = np.frombuffer(blob, np.uint8)
    size = len(blob)
    qt = {}
    huff = np.zeros((8, 272), np.uint8)
    frame, restart, jfif, adobe, orientation = None, 0, False, None, 1
    pos = 2
    while True:
        while pos < size and blob[pos] != 0xFF:
            pos += 1                      # garbage before a marker (libjpeg skips it)
        while pos < size and blob[pos] == 0xFF:
            pos += 1
        if pos >= size:
            break                         # no EOI: take what was decoded (as libjpeg)
        marker = blob[pos]
        pos += 1
        if marker == 0xD9:
            break
        if 0xD0 <= marker <= 0xD7 or marker in (0x01, 0xD8):
            continue
        if pos + 2 > size:
            raise ValueError(f"{name}: truncated JPEG marker 0x{marker:02X}")
        length = struct.unpack(">H", blob[pos:pos + 2])[0]
        seg = blob[pos + 2:pos + length]
        if len(seg) != length - 2:
            raise ValueError(f"{name}: truncated JPEG segment 0x{marker:02X}")
        pos += length
        if marker in (0xC0, 0xC1, 0xC2):
            if frame is not None:
                raise ValueError(f"{name}: JPEG with two frames is not read")
            frame = _Frame(seg, marker == 0xC2, name)
        elif marker in _UNSUPPORTED_SOF or marker == 0xCC:
            kind = _UNSUPPORTED_SOF.get(marker, "arithmetic-coded")
            raise ValueError(f"{name}: {kind} JPEG is not read")
        elif marker == 0xC4:
            i = 0
            while i < len(seg):
                tc, th = seg[i] >> 4, seg[i] & 15
                counts = seg[i + 1:i + 17]
                n = sum(counts)
                if tc > 1 or th > 3 or n > 256 or len(seg) < i + 17 + n:
                    raise ValueError(f"{name}: bad JPEG Huffman table")
                huff[4 * tc + th] = 0
                huff[4 * tc + th, :16 + n] = np.frombuffer(seg[i + 1:i + 17 + n], np.uint8)
                i += 17 + n
        elif marker == 0xDB:
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                if pq:
                    zz = np.frombuffer(seg[i + 1:i + 129], ">u2").astype(np.uint16)
                else:
                    zz = np.frombuffer(seg[i + 1:i + 65], np.uint8).astype(np.uint16)
                if tq > 3 or zz.size != 64:
                    raise ValueError(f"{name}: bad JPEG quantisation table")
                table = np.empty(64, np.uint16)
                table[ZIGZAG] = zz
                qt[tq] = table
                i += 129 if pq else 65
        elif marker == 0xDD:
            restart = struct.unpack(">H", seg[:2])[0]
        elif marker == 0xE0 and seg[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xE1 and seg[:6] == b"Exif\x00\x00" and orientation == 1:
            orientation = _exif_orientation(seg)
        elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe = seg[11]
        elif marker == 0xDA:
            if frame is None:
                raise ValueError(f"{name}: JPEG scan before the frame header")
            pos = _decode_scan(lib, frame, seg, data, pos, huff, qt, restart, name)
    if frame is None:
        raise ValueError(f"{name}: JPEG without a frame")
    img = _output(lib, frame, jfif, adobe, name)
    return apply_orientation(img, orientation)


def _decode_scan(lib, frame, seg, data, pos, huff, qt, restart, name) -> int:
    n = seg[0]
    comp = np.zeros((n, 6), np.int32)
    for i in range(n):
        cid, tables = seg[1 + 2 * i], seg[2 + 2 * i]
        if cid not in frame.ids:
            raise ValueError(f"{name}: JPEG scan names component {cid}, not in the frame")
        c = frame.ids.index(cid)
        if frame.qtables[c] is None:      # latched at the component's first scan
            if frame.tq[c] not in qt:
                raise ValueError(f"{name}: JPEG quantisation table {frame.tq[c]} is missing")
            frame.qtables[c] = qt[frame.tq[c]].copy()
        comp[i] = (frame.offset[c], frame.cols[c], frame.h[c], frame.v[c], tables >> 4,
                   tables & 15)
    ss, se, a = seg[1 + 2 * n], seg[2 + 2 * n], seg[3 + 2 * n]
    if n == 1:               # a scan of one component: its own blocks, one an MCU
        mcux, mcuy = -(-frame.cw[c] // 8), -(-frame.ch[c] // 8)
    else:
        mcux, mcuy = frame.mcux, frame.mcuy
    params = np.array([ss, se, a >> 4, a & 15, restart, mcux, mcuy, int(frame.progressive)],
                      np.int32)
    end = lib.iseg_jpeg_decode_scan(data.ctypes.data, data.size, pos, frame.coefs.ctypes.data,
                                    n, comp.ctypes.data, huff.ctypes.data, params.ctypes.data)
    if end < 0:
        raise ValueError(f"{name}: bad JPEG Huffman table")
    return int(end)


def _output(lib, frame, jfif, adobe, name) -> np.ndarray:
    height, width = frame.height, frame.width
    hmax, vmax = max(frame.h), max(frame.v)
    planes = []
    for c in range(len(frame.ids)):
        if frame.qtables[c] is None:
            raise ValueError(f"{name}: JPEG component {frame.ids[c]} has no scan")
        rows, cols = frame.rows[c], frame.cols[c]
        coefs = np.ascontiguousarray(frame.coefs[frame.offset[c]:frame.offset[c + 1]])
        plane = np.empty((8 * rows, 8 * cols), np.uint8)
        lib.iseg_jpeg_idct(coefs.ctypes.data, rows, cols, frame.qtables[c].ctypes.data,
                           plane.ctypes.data)
        fx, fy = hmax // frame.h[c], vmax // frame.v[c]
        if fx == 1 and fy == 1:
            planes.append(np.ascontiguousarray(plane[:height, :width]))
            continue
        full = np.empty((height, width), np.uint8)
        lib.iseg_jpeg_upsample(plane.ctypes.data, plane.shape[1], frame.cw[c], frame.ch[c],
                               fx, fy, full.ctypes.data, width, height)
        planes.append(full)
    if len(planes) == 1:
        return np.repeat(planes[0][..., None], 3, axis=2)
    ids = frame.ids
    if jfif:
        ycc = True
    elif adobe is not None:
        ycc = adobe != 0
    else:
        ycc = ids != [82, 71, 66]          # 'R', 'G', 'B' component ids
    if not ycc:
        return np.stack(planes, axis=2)
    rgb = np.empty((height, width, 3), np.uint8)
    lib.iseg_jpeg_ycc_to_rgb(planes[0].ctypes.data, planes[1].ctypes.data,
                             planes[2].ctypes.data, height * width, rgb.ctypes.data)
    return rgb


def read_jpeg(path: str) -> np.ndarray:
    """RGB uint8 [H, W, 3] of the JPEG at ``path``."""
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), str(path))


# ------------------------------------------------------------------ writing

def quality_tables(quality: int):
    """libjpeg's ``jpeg_set_quality(quality, force_baseline=TRUE)``: the two
    standard tables scaled, in natural order, uint16 [2, 64]."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    tables = (np.stack([STD_LUMA_Q, STD_CHROMA_Q]) * scale + 50) // 100
    return np.clip(tables, 1, 255).astype(np.uint16)


def _segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


def encode_jpeg(img: np.ndarray, quality: int = 95) -> bytes:
    """The baseline JPEG of uint8 RGB [H, W, 3] or grey [H, W] / [H, W, 1]
    that ``cv2.imwrite`` writes (of the BGR image) at
    ``IMWRITE_JPEG_QUALITY=quality`` (see the module's docstring)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"encode_jpeg takes uint8, got {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"encode_jpeg takes [H, W, 3] or [H, W], got {img.shape}")
    height, width = img.shape[:2]
    if not (0 < height <= 65535 and 0 < width <= 65535):
        raise ValueError(f"JPEG size {width}x{height} is out of range")
    img = np.ascontiguousarray(img)
    channels = 1 if img.ndim == 2 else 3
    ntab = 1 if channels == 1 else 2
    qtables = quality_tables(quality)
    htables = np.zeros((4, 272), np.uint8)
    for i, (cls, tid) in enumerate(((0, 0), (1, 0), (0, 1), (1, 1))):
        counts, vals = STD_HUFFMAN[(cls, tid)]
        htables[i, :16 + len(vals)] = np.frombuffer(counts + vals, np.uint8)
    head = [SOI[:2], _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for t in range(ntab):
        head.append(_segment(0xDB, bytes([t]) + qtables[t][ZIGZAG].astype(np.uint8).tobytes()))
    comps = [(1, 0x22, 0), (2, 0x11, 1), (3, 0x11, 1)] if channels == 3 else [(1, 0x11, 0)]
    head.append(_segment(0xC0, struct.pack(">BHHB", 8, height, width, len(comps))
                         + b"".join(bytes(c) for c in comps)))
    for t in range(ntab):
        for cls in (0, 1):
            counts, vals = STD_HUFFMAN[(cls, t)]
            head.append(_segment(0xC4, bytes([16 * cls + t]) + counts + vals))
    head.append(_segment(0xDA, bytes([len(comps)]) + b"".join(
        bytes([cid, 0x11 * tq]) for cid, _, tq in comps) + b"\x00\x3f\x00"))
    lib = _lib()
    scratch = np.empty(height * width * channels, np.uint8)
    cap = height * width * channels + 4096
    while True:
        out = np.empty(cap, np.uint8)
        n = lib.iseg_jpeg_encode(img.ctypes.data, height, width, channels, qtables.ctypes.data,
                                 htables.ctypes.data, scratch.ctypes.data, out.ctypes.data, cap)
        if n >= 0:
            break
        cap = -n
    return b"".join(head) + out[:n].tobytes() + b"\xff\xd9"


def write_jpeg(path: str, img: np.ndarray, quality: int = 95) -> None:
    """Write ``encode_jpeg(img, quality)`` to ``path``."""
    with open(path, "wb") as f:
        f.write(encode_jpeg(img, quality))
