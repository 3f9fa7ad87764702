"""The port's JPEG codec (``utils/jpeg.py`` + ``csrc/jpeg_codec.c``) against
OpenCV 5.0 (its bundled libjpeg-turbo) on the CPU, with no tolerance: the
decoder equals ``cv2.imread`` bit for bit on files written by ``cv2.imwrite``
(qualities 30/75/95/100, sampling 4:4:4, 4:2:2, 4:2:0, 4:4:0 and 4:1:1,
progressive, restart intervals, grey, odd sizes) and by PIL (EXIF
orientation tags 1-8, another encoder's tables); the encoder equals
``cv2.imwrite`` byte for byte at qualities 50, 75 and 95 (and 30, 100, grey,
odd sizes); the kinds that are not read raise naming the file; the
committed digests of ``tools/jpeg_digests.json`` equal OpenCV's."""

import io
import json
import os
import struct

import cv2
import numpy as np
import pytest

from instance_segmentation_torch.data.cityscapes import load_rgb_image
from instance_segmentation_torch.test import write_image
from instance_segmentation_torch.tools import jpeg_digests
from instance_segmentation_torch.utils import jpeg
from instance_segmentation_torch.utils.png import write_png

SIZES = [(479, 637), (64, 96), (17, 33), (1, 1), (8, 8), (16, 24), (3, 250)]
SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}
WRITERS = {
    **{f"q{q}": [cv2.IMWRITE_JPEG_QUALITY, q] for q in (30, 75, 95, 100)},
    **{f"s{k}": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, v] for k, v in SAMPLING.items()},
    "progressive": [cv2.IMWRITE_JPEG_PROGRESSIVE, 1],
    "progressive_q100_444": [cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_QUALITY, 100,
                             cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING["444"]],
    "restart3": [cv2.IMWRITE_JPEG_RST_INTERVAL, 3],
    "progressive_restart2": [cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_RST_INTERVAL, 2],
    "restart1_s422": [cv2.IMWRITE_JPEG_RST_INTERVAL, 1, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                      SAMPLING["422"]],
    "optimized": [cv2.IMWRITE_JPEG_OPTIMIZE, 1, cv2.IMWRITE_JPEG_QUALITY, 60],
}


def frame(h, w, seed=0, kind="smooth"):
    """RGB uint8: a smooth field with noise, or uniform noise, or saturated
    colours (the colour conversion's clamps)."""
    rng = np.random.default_rng([seed, h, w])
    if kind == "noise":
        return rng.integers(0, 256, (h, w, 3), np.uint8)
    if kind == "saturated":
        return (rng.integers(0, 2, (h, w, 3)) * 255).astype(np.uint8)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1), (x + y) * 3 % 256], -1)
    return np.clip(img + rng.integers(-30, 31, img.shape), 0, 255).astype(np.uint8)


def cv2_read(blob: bytes) -> np.ndarray:
    return cv2.imdecode(np.frombuffer(blob, np.uint8), cv2.IMREAD_COLOR)[..., ::-1]


def cv2_write(img: np.ndarray, params) -> bytes:
    ok, buf = cv2.imencode(".jpg", img if img.ndim == 2 else img[..., ::-1], params)
    assert ok
    return buf.tobytes()


@pytest.mark.parametrize("writer", list(WRITERS))
def test_decoder_equals_imread_on_imwrite_files(writer):
    for h, w in SIZES:
        for kind in ("smooth", "noise"):
            blob = cv2_write(frame(h, w, kind=kind), WRITERS[writer])
            np.testing.assert_array_equal(jpeg.decode_jpeg(blob), cv2_read(blob),
                                          err_msg=f"{writer} {h}x{w} {kind}")


@pytest.mark.parametrize("quality", [30, 95])
def test_decoder_equals_imread_on_grey_and_saturated(quality):
    for h, w in SIZES:
        grey = cv2_write(frame(h, w)[..., 1], [cv2.IMWRITE_JPEG_QUALITY, quality])
        got = jpeg.decode_jpeg(grey)
        assert got.shape == (h, w, 3)
        np.testing.assert_array_equal(got, cv2_read(grey))
        sat = cv2_write(frame(h, w, kind="saturated"), [cv2.IMWRITE_JPEG_QUALITY, quality])
        np.testing.assert_array_equal(jpeg.decode_jpeg(sat), cv2_read(sat))
    prog_grey = cv2_write(frame(33, 47)[..., 0], [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    np.testing.assert_array_equal(jpeg.decode_jpeg(prog_grey), cv2_read(prog_grey))


def _pil_jpeg(img, **kw) -> bytes:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", **kw)
    return buf.getvalue()


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_applied_as_imread(orientation):
    """Tags 3, 6 and 8 (and the rest) as ``cv2.imread`` applies them; the
    APP1 segment is PIL's, little-endian TIFF."""
    from PIL import Image
    img = frame(40, 64, seed=orientation)
    exif = Image.Exif()
    exif[0x0112] = orientation
    blob = _pil_jpeg(img, exif=exif.tobytes(), quality=90)
    got, want = jpeg.decode_jpeg(blob), cv2_read(blob)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_big_endian_exif_and_other_encoders():
    """A hand-written big-endian APP1 (tag 6), and PIL's own tables and
    sampling choices, progressive included."""
    img = frame(30, 52, seed=9)
    base = cv2_write(img, [])
    ifd = struct.pack(">H", 1) + struct.pack(">HHIHH", 0x0112, 3, 1, 6, 0) + b"\0\0\0\0"
    tiff = b"MM\x00\x2a" + struct.pack(">I", 8) + ifd
    app1 = b"\xff\xe1" + struct.pack(">H", len(tiff) + 8) + b"Exif\0\0" + tiff
    blob = base[:2] + app1 + base[2:]
    got = jpeg.decode_jpeg(blob)
    assert got.shape == (52, 30, 3)
    np.testing.assert_array_equal(got, cv2_read(blob))
    for kw in (dict(subsampling=0), dict(subsampling=1), dict(subsampling=2, progressive=True),
               dict(quality=5), dict(quality=100, subsampling=0)):
        blob = _pil_jpeg(frame(37, 45, kind="noise"), **kw)
        np.testing.assert_array_equal(jpeg.decode_jpeg(blob), cv2_read(blob), err_msg=str(kw))


@pytest.mark.parametrize("quality", [50, 75, 95, 30, 100])
def test_encoder_equals_imwrite_bytes(quality):
    for h, w in SIZES:
        for kind in ("smooth", "noise", "saturated"):
            img = frame(h, w, kind=kind)
            assert jpeg.encode_jpeg(img, quality) == \
                cv2_write(img, [cv2.IMWRITE_JPEG_QUALITY, quality]), (h, w, kind)
        grey = frame(h, w)[..., 2]
        assert jpeg.encode_jpeg(grey, quality) == \
            cv2_write(grey, [cv2.IMWRITE_JPEG_QUALITY, quality]), (h, w, "grey")


def test_write_paths_follow_imwrite(tmp_path):
    """``write_jpeg`` at the default quality 95, ``write_image`` by
    extension (JPEG for .jpg/.jpeg, PNG otherwise), and ``load_rgb_image``
    choosing the reader by the magic bytes, whatever the name says."""
    img = frame(45, 61, seed=3)
    for name in ("a.jpg", "b.jpeg"):
        mine, ref = str(tmp_path / name), str(tmp_path / ("ref_" + name))
        write_image(mine, img)
        cv2.imwrite(ref, img[..., ::-1])
        assert open(mine, "rb").read() == open(ref, "rb").read(), name
    png_path = str(tmp_path / "c.png")          # PNG: equal pixels (zlib's bytes may differ)
    write_image(png_path, img)
    assert open(png_path, "rb").read(8) == b"\x89PNG\r\n\x1a\n"
    np.testing.assert_array_equal(cv2.imread(png_path)[..., ::-1], img)
    named_png = str(tmp_path / "jpeg_inside.png")
    jpeg.write_jpeg(named_png, img)
    np.testing.assert_array_equal(load_rgb_image(named_png), cv2.imread(named_png)[..., ::-1])
    named_jpg = str(tmp_path / "png_inside.jpg")
    write_png(named_jpg, img)
    np.testing.assert_array_equal(load_rgb_image(named_jpg), img)
    other = str(tmp_path / "other.jpg")
    open(other, "wb").write(b"GIF89a....")
    with pytest.raises(ValueError, match="other.jpg"):
        load_rgb_image(other)


def _patched(blob: bytes, marker: int, offset: int, value: int) -> bytes:
    """``blob`` with the byte ``offset`` bytes after the first 0xFF ``marker``
    set to ``value``."""
    i = blob.index(bytes([0xFF, marker]))
    out = bytearray(blob)
    out[i + offset] = value
    return bytes(out)


def test_unsupported_kinds_raise_naming_the_file(tmp_path):
    from PIL import Image
    base = cv2_write(frame(16, 16), [])
    cmyk = io.BytesIO()
    Image.fromarray(frame(16, 16)).convert("CMYK").save(cmyk, format="JPEG")
    cases = {
        "arithmetic": (_patched(base, 0xC0, 1, 0xC9), "arithmetic"),
        "arith_progressive": (_patched(base, 0xC0, 1, 0xCA), "arithmetic"),
        "lossless": (_patched(base, 0xC0, 1, 0xC3), "lossless"),
        "hierarchical": (_patched(base, 0xC0, 1, 0xC5), "hierarchical"),
        "twelve_bit": (_patched(base, 0xC0, 4, 12), "12-bit"),
        "cmyk": (cmyk.getvalue(), "CMYK"),
        "truncated": (base[:40], "truncated"),
        "not_jpeg": (b"\x89PNG\r\n\x1a\n", "not a JPEG"),
    }
    for name, (blob, what) in cases.items():
        path = str(tmp_path / f"{name}.jpg")
        open(path, "wb").write(blob)
        with pytest.raises(ValueError, match=what) as info:
            jpeg.read_jpeg(path)
        assert path in str(info.value), name


def test_committed_digests_equal_opencv():
    """The digests ``tests/test_torch_on_card.py`` holds the codec to on the
    card's host are OpenCV's bytes and pixels for these frames, and the port
    meets them."""
    with open(jpeg_digests.PATH) as f:
        assert json.load(f) == jpeg_digests.opencv_digests()
    rows = jpeg_digests.check()
    assert [r["case"] for r in rows] == [jpeg_digests.key(*c) for c in jpeg_digests.CASES]
    assert all(r["bytes_ok"] and r["pixels_ok"] for r in rows)
    assert os.path.basename(jpeg_digests.PATH) == "jpeg_digests.json"
