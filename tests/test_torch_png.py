"""The port's PNG reader and writer (``utils/png.py``) against OpenCV: decode
equals ``cv2.imread`` (as RGB) bit for bit on PNGs that OpenCV and PIL write
(grey, grey+alpha, RGB, RGBA, palette; several compression levels), a corpus
that holds all five row filters; the writer round-trips through
``cv2.imread``; 16-bit, interlaced and JPEG input raise, naming the file.
The C row unfilter (``csrc/png_unfilter.c``, which ``read_png`` uses) is
held bit for bit to its numpy twin on rows of every filter type at 1-4
bytes a pixel, and the encoder ``filter_rows`` to one written here."""

import os
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from instance_segmentation_torch.utils import png


def _natural(rng, h, w):
    """Smooth gradients plus noise: rows that libpng's filter heuristic
    encodes with different filters."""
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([(x * 3 + y) % 256, (y * 2) % 256, ((x + y) // 2) % 256], -1)
    return np.clip(base + rng.normal(0, 10, base.shape), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("png")
    rng = np.random.default_rng(0)
    files = []
    for channels in (1, 3, 4):
        for level in (0, 1, 9):
            img = _natural(rng, 37, 53)
            img = np.dstack([img, img[..., :1]]) if channels == 4 else img
            p = str(d / f"cv_{channels}_{level}.png")
            cv2.imwrite(p, img[..., 0] if channels == 1 else img[..., :channels],
                        [cv2.IMWRITE_PNG_COMPRESSION, level])
            files.append(p)
    for mode in ("L", "LA", "RGB", "RGBA"):
        for level in (0, 6, 9):
            p = str(d / f"pil_{mode}_{level}.png")
            Image.fromarray(_natural(rng, 41, 29)).convert(mode).save(p, compress_level=level)
            files.append(p)
    p = str(d / "pil_P.png")
    Image.fromarray(_natural(rng, 33, 47)).convert("P", palette=Image.ADAPTIVE,
                                                   colors=200).save(p)
    files.append(p)
    return files


def _filter_types(path):
    """The filter-type byte of every row of a PNG."""
    with open(path, "rb") as f:
        blob = f.read()
    width, height, color = png._header(blob, path)
    stream = zlib.decompress(b"".join(d for k, d in png._chunks(blob) if k == b"IDAT"))
    rowbytes = width * {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    return np.frombuffer(stream, np.uint8).reshape(height, rowbytes + 1)[:, 0]


def test_corpus_holds_all_five_filters(corpus):
    seen = set()
    for p in corpus:
        seen |= set(_filter_types(p).tolist())
    assert seen == {0, 1, 2, 3, 4}


def test_read_equals_cv2_imread(corpus):
    for p in corpus:
        want = cv2.imread(p, cv2.IMREAD_COLOR)[..., ::-1]
        got = png.read_png(p)
        assert got.dtype == np.uint8 and got.shape == want.shape, p
        np.testing.assert_array_equal(got, want, err_msg=os.path.basename(p))


@pytest.mark.parametrize("grey", [False, True])
def test_writer_round_trips_through_cv2(tmp_path, grey):
    img = np.random.default_rng(1).integers(0, 256, (19, 23, 3), dtype=np.uint8)
    p = str(tmp_path / "w.png")
    if grey:
        png.write_png(p, img[..., 0])
        np.testing.assert_array_equal(cv2.imread(p, cv2.IMREAD_UNCHANGED), img[..., 0])
    else:
        png.write_png(p, img)
        np.testing.assert_array_equal(cv2.imread(p, cv2.IMREAD_COLOR)[..., ::-1], img)
    np.testing.assert_array_equal(png.read_png(p), np.repeat(img[..., :1], 3, 2) if grey
                                  else img)


def _encode(img, types, bpp):
    """Rows [H, R] filtered by hand, each with its type: the PNG stream
    [H, R + 1], by a numpy encoder independent of the module's."""
    img = img.astype(np.int64)
    raw = np.zeros((img.shape[0], img.shape[1] + 1), np.uint8)
    for r in range(img.shape[0]):
        up = img[r - 1] if r else np.zeros(img.shape[1], np.int64)
        left = np.concatenate([np.zeros(bpp, np.int64), img[r, :-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        p = left + up - ul
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
        pred = [0, left, up, (left + up) // 2, paeth][types[r]]
        raw[r, 0] = types[r]
        raw[r, 1:] = (img[r] - pred) % 256
    return raw


def test_unfilter_numpy_on_every_filter_type():
    """Each row filtered by hand with one of the five filters (numpy
    encoder, independent of the decoder) decodes back."""
    rng = np.random.default_rng(2)
    h, w, bpp = 9, 7, 3
    img = rng.integers(0, 256, (h, w * bpp)).astype(np.int64)
    types = np.array([0, 1, 2, 3, 4, 4, 3, 2, 1])
    raw = _encode(img, types, bpp)
    np.testing.assert_array_equal(png.unfilter_numpy(raw.reshape(-1), h, w * bpp, bpp), img)
    raw[4, 0] = 5
    with pytest.raises(ValueError, match="filter type 5"):
        png.unfilter_numpy(raw.reshape(-1), h, w * bpp, bpp)


@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
def test_c_unfilter_equals_numpy_twin(bpp):
    """The C helper and its numpy twin, bit for bit, on rows of all five
    filter types (random and hand-encoded), and on the module's own
    encoder's choice; an unknown type raises in both."""
    rng = np.random.default_rng(10 + bpp)
    h, w = 67, 129
    y, x = np.mgrid[0:h, 0:w * bpp]
    img = ((x * 3 + y * 5) % 256 + rng.integers(0, 16, (h, w * bpp))).astype(np.uint8)
    types = rng.integers(0, 5, h)
    types[:5] = np.arange(5)
    for raw in (_encode(img, types, bpp), png.filter_rows(img, bpp)):
        args = (raw.reshape(-1), h, w * bpp, bpp)
        np.testing.assert_array_equal(png.unfilter_native(*args), png.unfilter_numpy(*args))
        np.testing.assert_array_equal(png.unfilter_native(*args), img)
    raw = _encode(img, types, bpp)
    raw[7, 0] = 6
    for unfilter in (png.unfilter_native, png.unfilter_numpy):
        with pytest.raises(ValueError, match="filter type 6"):
            unfilter(raw.reshape(-1), h, w * bpp, bpp)


def test_filter_rows_encodes_as_given_and_picks_by_the_heuristic():
    """``filter_rows`` with given types equals the hand encoder; by default
    each row takes the type whose bytes, read as int8, have the least sum of
    magnitudes, and a smooth image takes more than one type."""
    rng = np.random.default_rng(4)
    img = _natural(rng, 31, 43).reshape(31, -1)
    types = rng.integers(0, 5, 31)
    np.testing.assert_array_equal(png.filter_rows(img, 3, types), _encode(img, types, 3))
    picked = png.filter_rows(img, 3)
    costs = np.stack([np.abs(_encode(img, np.full(31, t), 3)[:, 1:].view(np.int8)
                             .astype(np.int64)).sum(-1) for t in range(5)])
    np.testing.assert_array_equal(picked[:, 0], costs.argmin(0))
    np.testing.assert_array_equal(picked, _encode(img, picked[:, 0], 3))
    assert len(set(picked[:, 0].tolist())) > 1


def test_unsupported_input_raises_naming_the_file(tmp_path):
    img = np.random.default_rng(3).integers(0, 256, (8, 8, 3), dtype=np.uint8)
    deep = str(tmp_path / "deep.png")
    cv2.imwrite(deep, img.astype(np.uint16) * 257)
    jpeg = str(tmp_path / "frame.jpg")
    cv2.imwrite(jpeg, img)
    interlaced = str(tmp_path / "interlaced.png")
    png.write_png(interlaced, img)
    with open(interlaced, "r+b") as f:      # IHDR's interlace byte, and its CRC
        blob = bytearray(f.read())
        blob[28] = 1
        blob[29:33] = zlib.crc32(bytes(blob[12:29])).to_bytes(4, "big")
        f.seek(0)
        f.write(blob)
    other = str(tmp_path / "other.png")
    with open(other, "wb") as f:
        f.write(b"not an image")
    for path, what in ((deep, "16-bit"), (jpeg, "JPEG"), (interlaced, "interlaced"),
                       (other, "not a PNG")):
        with pytest.raises(ValueError, match=what) as info:
            png.read_png(path)
        assert path in str(info.value)

