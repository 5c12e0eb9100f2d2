"""COCO results visualiser of the PyTorch port (port of
``tools/plot_coco.py``; parity role: the reference's
visualization/plot_coco.py):

    python -m udp_pose_tpu_torch.plot_coco --results results.json \
        --image-dir dir/ [--style chunhua] [--save-dir plots/] \
        [--score-thre 0.3]

Draws per-image skeleton overlays from a results json (the file
``dataset.evaluate`` writes) in the paper's two colour styles (the
reference's :20-88 Chunhua / Xiaochu palettes).  Host only: OpenCV and
numpy, no device.
"""

from __future__ import annotations

import argparse
import json
import os
from collections import defaultdict

import numpy as np

# COCO skeleton (1-based) + per-limb colours, per the reference's styles
SKELETON = [[16, 14], [14, 12], [17, 15], [15, 13], [12, 13], [6, 12],
            [7, 13], [6, 7], [6, 8], [7, 9], [8, 10], [9, 11], [2, 3],
            [1, 2], [1, 3], [2, 4], [3, 5], [4, 6], [5, 7]]

STYLES = {
    "chunhua": [(0, 215, 255), (0, 255, 204), (0, 134, 255), (0, 255, 50),
                (77, 255, 222), (77, 196, 255), (77, 135, 255),
                (191, 255, 77), (77, 255, 77), (77, 222, 255),
                (255, 156, 127), (0, 127, 255), (255, 127, 77),
                (0, 77, 255), (255, 77, 36), (0, 77, 255), (0, 77, 255),
                (0, 215, 255), (0, 215, 255)],
    "xiaochu": [(255, 0, 0)] * 5 + [(0, 255, 0)] * 7 + [(0, 0, 255)] * 7,
}


def expanded_overlap(gt_bbox, dt_bbox):
    """The reference's double-box overlap ratio (visualization/
    plot_coco.py:190-210): each xywh box is expanded to 3x its extent
    around itself, overlap = (joint-overlap span product) / (joint-total
    span product).  Negative spans are not clamped: the arithmetic is
    the reference's, quirk included."""
    x0 = gt_bbox[0] - gt_bbox[2]
    x1 = gt_bbox[0] + gt_bbox[2] * 2
    y0 = gt_bbox[1] - gt_bbox[3]
    y1 = gt_bbox[1] + gt_bbox[3] * 2
    dt_x0 = dt_bbox[0] - dt_bbox[2]
    dt_x1 = dt_bbox[0] + dt_bbox[2] * 2
    dt_y0 = dt_bbox[1] - dt_bbox[3]
    dt_y1 = dt_bbox[1] + dt_bbox[3] * 2
    ol_x = min(x1, dt_x1) - max(x0, dt_x0)
    ol_y = min(y1, dt_y1) - max(y0, dt_y0)
    s_x = max(x1, dt_x1) - min(x0, dt_x0)
    s_y = max(y1, dt_y1) - min(y0, dt_y0)
    return (ol_x * ol_y) / (s_x * s_y + np.spacing(1))


def matched_pairs(gts, dts, threshold=0.3, max_dets=20, iou_min=0.1):
    """The reference's matched-rendering selection for one image
    (plot_coco.py:157-212): dts sorted by -score (mergesort, stable) and
    capped at ``max_dets``; nothing drawn unless the image has both gts
    and dts; every (gt, dt) pair with expanded overlap >= ``iou_min`` and
    dt score >= ``threshold`` is selected, so a dt near two gts renders
    twice, as the reference's nested loop does."""
    inds = np.argsort([-d["score"] for d in dts], kind="mergesort")
    dts = [dts[i] for i in inds][:max_dets]
    if not gts or not dts:
        return []
    pairs = []
    for gt in gts:
        for dt in dts:
            iou = expanded_overlap(gt["bbox"], dt["bbox"])
            if iou < iou_min or dt["score"] < threshold:
                continue
            pairs.append((gt, dt))
    return pairs


def plot(results_file, image_dir, save_dir, style="chunhua",
         score_thre=0.3, vis_thre=0.2, match_gt=None, joint_thres=0.2):
    """Write one annotated ``%012d.jpg`` to ``save_dir`` for each image
    of ``image_dir`` that has detections in ``results_file``; returns how
    many.  ``match_gt`` (a COCO gt json) switches to the reference's
    matched-rendering protocol (plot_coco.py:141-263): only detections
    paired to a ground-truth box by :func:`matched_pairs` draw, links and
    rings gate on dt confidence >= ``joint_thres`` and the matched gt's
    per-joint visibility, with the reference's quirk that the ring loop
    tests ``vg`` at the last link pair's endpoints (:246-248), not at the
    ring's joint."""
    import cv2
    with open(results_file) as f:
        results = json.load(f)
    by_image = defaultdict(list)
    for r in results:
        if match_gt is not None or r["score"] >= score_thre:
            by_image[r["image_id"]].append(r)
    gts_by_image = None
    if match_gt is not None:
        with open(match_gt) as f:
            gt = json.load(f)
        gts_by_image = defaultdict(list)
        for a in gt["annotations"]:
            if not a.get("iscrowd", 0):
                gts_by_image[a["image_id"]].append(a)
    colors = STYLES[style]
    os.makedirs(save_dir, exist_ok=True)
    n = 0
    for image_id, dets in by_image.items():
        path = os.path.join(image_dir, "%012d.jpg" % image_id)
        img = cv2.imread(path)
        if img is None:
            continue
        if gts_by_image is None:
            draw_list = [(None, det) for det in dets]
        else:
            draw_list = matched_pairs(gts_by_image.get(image_id, []),
                                      dets, threshold=score_thre)
            if not draw_list:
                continue
        h, w = img.shape[:2]
        for gt_ann, det in draw_list:
            kp = np.asarray(det["keypoints"]).reshape(-1, 3)
            vg = (np.asarray(gt_ann["keypoints"])[2::3]
                  if gt_ann is not None else None)
            last_pair = SKELETON[-1]
            for li, (a, b) in enumerate(SKELETON):
                pa, pb = kp[a - 1], kp[b - 1]
                if gt_ann is not None:
                    last_pair = (a, b)
                    if (pa[2] < joint_thres or pb[2] < joint_thres
                            or vg[a - 1] == 0 or vg[b - 1] == 0):
                        continue
                elif not (pa[2] > vis_thre and pb[2] > vis_thre):
                    continue
                cv2.line(img, (int(pa[0]), int(pa[1])),
                         (int(pb[0]), int(pb[1])),
                         colors[li % len(colors)], 2, cv2.LINE_AA)
            for p in kp:
                if gt_ann is not None:
                    # the reference's ring gate (:246-251): vg tested at
                    # the leftover link pair's endpoints, and in bounds
                    a, b = last_pair
                    if (p[2] < joint_thres or vg[a - 1] == 0
                            or vg[b - 1] == 0):
                        continue
                    if p[0] > w or p[1] > h:
                        continue
                elif not p[2] > vis_thre:
                    continue
                cv2.circle(img, (int(p[0]), int(p[1])), 2,
                           (255, 255, 255), -1, cv2.LINE_AA)
        out = os.path.join(save_dir, "%012d.jpg" % image_id)
        cv2.imwrite(out, img)
        n += 1
    print(f"wrote {n} annotated images to {save_dir}")
    return n


def main(argv=None):
    p = argparse.ArgumentParser(description="Draw skeleton overlays of a "
                                            "COCO results json")
    p.add_argument("--results", required=True)
    p.add_argument("--image-dir", required=True)
    p.add_argument("--save-dir", default="plots")
    p.add_argument("--style", default="chunhua", choices=sorted(STYLES))
    p.add_argument("--score-thre", type=float, default=0.3)
    args = p.parse_args(argv)
    return plot(args.results, args.image_dir, args.save_dir, args.style,
                args.score_thre)


if __name__ == "__main__":
    main()
