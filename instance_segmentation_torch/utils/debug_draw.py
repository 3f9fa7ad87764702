"""Decode debug rendering (the reference's ``draw_flag``).

Counterpart of ``instance_segmentation_tpu/utils/debug_draw.py`` (ref
utils/decode.py draw_kp_mask/draw_kp/draw_box/draw_candid :207-251): with
``draw_flag`` on, the test entry point writes three overlays of each frame
into ``save_dir`` as PNGs: the detected boxes, the grouped boundary
keypoints of each object with its bounding rectangle, and the filled
polygons. It reads the packed ``Detections`` (one host copy), so the decode
itself does not change. The frame is read as ``cv2.imread`` does (BGR) and
drawn on in that order, as there.
"""

from __future__ import annotations

import os

import numpy as np

from instance_segmentation_torch.data.cityscapes import load_rgb_image
from instance_segmentation_torch.utils.png import write_png
from instance_segmentation_torch.utils.visualize import (
    draw_rectangle, visualize_boxes, visualize_instances, visualize_keypoints,
)


def dump_detections(dets, index: int, img_path: str, save_dir: str,
                    scale: float = 2.0) -> None:
    """Write ``<base>_box.png``, ``<base>_candid.png`` and
    ``<base>_instances.png`` for image ``index`` of a batch of ``dets``.
    A frame that cannot be read is skipped, as ``cv2.imread``'s None is."""
    os.makedirs(save_dir, exist_ok=True)
    base = os.path.splitext(os.path.basename(img_path))[0]
    try:
        img = np.ascontiguousarray(load_rgb_image(img_path)[..., ::-1])   # BGR
    except (OSError, ValueError):
        return

    def host(t):
        return t[index].cpu().numpy()

    boxes, det_valid, centers = host(dets.boxes), host(dets.det_valid), host(dets.centers)
    polys, lens, obj_valid = host(dets.polygons), host(dets.poly_len), host(dets.obj_valid)

    def save(name, bgr):
        write_png(os.path.join(save_dir, f"{base}_{name}.png"), bgr[..., ::-1])

    box_img = img.copy()
    sizes = [((b[2] - b[0]) * scale, (b[3] - b[1]) * scale) for b in boxes[det_valid]]
    visualize_boxes(box_img, centers[det_valid], sizes)
    save("box", box_img)

    cand_img = img.copy()
    rng = np.random.default_rng(0)
    for d in np.nonzero(obj_valid)[0]:
        color = tuple(int(c) for c in rng.integers(0, 256, 3))
        pts = polys[d][: lens[d]]
        visualize_keypoints(cand_img, pts, color=color)
        x1, y1 = pts.min(0).astype(int)
        x2, y2 = pts.max(0).astype(int)
        draw_rectangle(cand_img, (x1, y1), (x2, y2), color)
    save("candid", cand_img)

    save("instances", visualize_instances(img, [polys[d][: lens[d]]
                                                for d in np.nonzero(obj_valid)[0]]))
