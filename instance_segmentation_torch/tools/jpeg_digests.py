"""The JPEG codec's fixed points: seeded frames and the SHA-256 digests of
what OpenCV makes of them.

``jpeg_digests.json`` (beside this file) holds, for each case of ``CASES``
(frame height, width, quality), the digest of ``cv2.imwrite``'s bytes for
the frame and the digest of ``cv2.imread``'s pixels (RGB) of the port's
bytes for it. ``check`` holds the port's encoder and decoder to them on a
machine without OpenCV; ``tests/test_torch_jpeg.py`` recomputes them with
OpenCV and fails on any drift. ``python -m
instance_segmentation_torch.tools.jpeg_digests --write`` rewrites the file
(OpenCV needed).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import time
from typing import Dict, List

import numpy as np

from instance_segmentation_torch.tools.make_synthetic_coco import make_frame
from instance_segmentation_torch.utils.jpeg import decode_jpeg, encode_jpeg

PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "jpeg_digests.json")
CASES = ((480, 640, 75), (480, 640, 95), (1024, 2048, 75), (1024, 2048, 95))


def frame(h: int, w: int, seed: int = 0) -> np.ndarray:
    """A seeded RGB frame: a synthetic COCO frame of that size."""
    return make_frame(np.random.default_rng([seed, h, w]), h, w, 0, 1)[0]


def sha256(data) -> str:
    return hashlib.sha256(bytes(np.ascontiguousarray(data).data)
                          if isinstance(data, np.ndarray) else data).hexdigest()


def key(h: int, w: int, q: int) -> str:
    return f"{h}x{w}q{q}"


def opencv_digests() -> Dict[str, Dict[str, str]]:
    """The digests of OpenCV's bytes and pixels for every case."""
    import cv2
    out = {}
    for h, w, q in CASES:
        img = frame(h, w)
        ok, ref = cv2.imencode(".jpg", img[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, q])
        assert ok
        mine = np.frombuffer(encode_jpeg(img, q), np.uint8)
        pixels = cv2.imdecode(mine, cv2.IMREAD_COLOR)[..., ::-1]
        out[key(h, w, q)] = {"bytes": sha256(ref.tobytes()), "pixels": sha256(pixels)}
    return out


def check() -> List[Dict]:
    """The port's encoder and decoder on every case against the committed
    digests, each timed once (after one warm-up pass over the cases):
    [{case, bytes_ok, pixels_ok, encode_ms, decode_ms}]."""
    with open(PATH) as f:
        want = json.load(f)
    frames = {(h, w): frame(h, w) for h, w, _ in CASES}
    for h, w, q in CASES:
        decode_jpeg(encode_jpeg(frames[h, w], q))
    rows = []
    for h, w, q in CASES:
        t0 = time.perf_counter()
        blob = encode_jpeg(frames[h, w], q)
        t1 = time.perf_counter()
        pixels = decode_jpeg(blob)
        t2 = time.perf_counter()
        ref = want[key(h, w, q)]
        rows.append({"case": key(h, w, q), "bytes_ok": sha256(blob) == ref["bytes"],
                     "pixels_ok": sha256(pixels) == ref["pixels"],
                     "encode_ms": (t1 - t0) * 1e3, "decode_ms": (t2 - t1) * 1e3})
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--write", action="store_true", help="rewrite the digests (needs OpenCV)")
    args = ap.parse_args()
    if args.write:
        with open(PATH, "w") as f:
            json.dump(opencv_digests(), f, indent=1, sort_keys=True)
            f.write("\n")
    for row in check():
        print(json.dumps(row))
