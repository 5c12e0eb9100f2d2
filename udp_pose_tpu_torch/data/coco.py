"""COCO keypoints dataset, pycocotools-free (port of
``udp_pose_tpu/data/coco.py``).

Parity: deep_hrnet/lib/dataset/coco.py — annotation loading :136-208,
detector-box loading :246-287, box→center/scale :210-229, evaluate
(rescoring + OKS-NMS + keypoint AP) :289-366.  The json is parsed
directly; AP comes from the port's native evaluator (eval/cocoeval.py).
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Dict, List

import numpy as np

from ..eval.cocoeval import COCOKeypointEval
from ..ops.nms import oks_nms, soft_oks_nms
from .base import JointsDataset


class COCODataset(JointsDataset):
    num_joints = 17
    flip_pairs = [[1, 2], [3, 4], [5, 6], [7, 8], [9, 10], [11, 12],
                  [13, 14], [15, 16]]
    upper_body_ids = (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10)
    lower_body_ids = (11, 12, 13, 14, 15, 16)
    joints_weight = np.array(
        [1., 1., 1., 1., 1., 1., 1., 1.2, 1.2, 1.5, 1.5, 1., 1., 1.2, 1.2,
         1.5, 1.5], np.float32).reshape((17, 1))

    def __init__(self, cfg, root, image_set, is_train):
        super().__init__(cfg, root, image_set, is_train)
        self.use_gt_bbox = cfg.TEST.USE_GT_BBOX
        self.bbox_file = cfg.TEST.COCO_BBOX_FILE
        self.image_thre = cfg.TEST.IMAGE_THRE
        self.in_vis_thre = cfg.TEST.IN_VIS_THRE
        self.oks_thre = cfg.TEST.OKS_THRE
        self.soft_nms = cfg.TEST.SOFT_NMS

        self._ann_file = os.path.join(
            root, "annotations",
            ("person_keypoints" if "test" not in image_set
             else "image_info") + f"_{image_set}.json")
        self._images: Dict[int, dict] = {}
        self._anns_by_image: Dict[int, List[dict]] = defaultdict(list)
        self._person_cat_id = 1
        self._load_json()
        self.image_ids = sorted(self._images)

        if is_train or self.use_gt_bbox:
            self.db = self._load_gt_db()
        else:
            self.db = self._load_detection_db()
        if is_train and cfg.DATASET.SELECT_DATA:
            self.db = self.select_data(self.db)

    # -- json parsing -------------------------------------------------------

    def _load_json(self):
        with open(self._ann_file) as f:
            data = json.load(f)
        for img in data.get("images", []):
            self._images[img["id"]] = img
        for cat in data.get("categories", []):
            if cat["name"] == "person":
                self._person_cat_id = cat["id"]
        self._ann_list = []
        for ann in data.get("annotations", []):
            if ann.get("category_id") == self._person_cat_id:
                self._anns_by_image[ann["image_id"]].append(ann)
                self._ann_list.append(ann)  # global ann-file order (RSN db)

    def image_path(self, image_id):
        """Parity: image_path_from_index (coco.py:231-244)."""
        file_name = "%012d.jpg" % image_id
        if "2014" in self.image_set:
            file_name = f"COCO_{self.image_set}_" + file_name
        prefix = "test2017" if "test" in self.image_set else self.image_set
        return os.path.join(self.root, "images", prefix, file_name)

    def _xywh2cs(self, x, y, w, h):
        """Parity: coco.py:214-229."""
        center = np.array([x + w * 0.5, y + h * 0.5], np.float32)
        if w > self.aspect_ratio * h:
            h = w * 1.0 / self.aspect_ratio
        elif w < self.aspect_ratio * h:
            w = h * self.aspect_ratio
        scale = np.array([w / self.pixel_std, h / self.pixel_std], np.float32)
        if center[0] != -1:
            scale = scale * 1.25
        return center, scale

    def _load_gt_db(self):
        """Parity: coco.py:143-208 (bbox sanitising, vis clamp)."""
        db = []
        for image_id in self.image_ids:
            im = self._images[image_id]
            width, height = im["width"], im["height"]
            for obj in self._anns_by_image.get(image_id, []):
                if obj.get("iscrowd"):
                    continue
                x, y, w, h = obj["bbox"]
                x1, y1 = max(0, x), max(0, y)
                x2 = min(width - 1, x1 + max(0, w - 1))
                y2 = min(height - 1, y1 + max(0, h - 1))
                if obj.get("area", 0) <= 0 or x2 < x1 or y2 < y1:
                    continue
                if max(obj["keypoints"]) == 0:
                    continue
                kp = np.asarray(obj["keypoints"], np.float64).reshape(-1, 3)
                joints = np.zeros((self.num_joints, 3))
                vis = np.zeros((self.num_joints, 3))
                joints[:, :2] = kp[:, :2]
                tv = np.minimum(kp[:, 2], 1)
                vis[:, 0] = tv
                vis[:, 1] = tv
                center, scale = self._xywh2cs(x1, y1, x2 - x1, y2 - y1)
                db.append({
                    "image": self.image_path(image_id),
                    "image_id": image_id,
                    "center": center, "scale": scale,
                    "joints_3d": joints, "joints_3d_vis": vis,
                })
        return db

    def _load_detection_db(self):
        """Parity: coco.py:246-287 (det json, IMAGE_THRE filter)."""
        with open(self.bbox_file) as f:
            all_boxes = json.load(f)
        db = []
        for det in all_boxes:
            if det.get("category_id") != 1:
                continue
            if det["score"] < self.image_thre:
                continue
            center, scale = self._xywh2cs(*det["bbox"][:4])
            db.append({
                "image": self.image_path(det["image_id"]),
                "image_id": det["image_id"],
                "center": center, "scale": scale,
                "score": det["score"],
                "joints_3d": np.zeros((self.num_joints, 3)),
                "joints_3d_vis": np.ones((self.num_joints, 3)),
            })
        return db

    # -- evaluation ---------------------------------------------------------

    def evaluate(self, cfg, preds, output_dir, all_boxes, img_path,
                 *args, **kwargs):
        """Rescoring + OKS-NMS + AP (parity: coco.py:289-366).

        preds (N, J, 3) [x, y, maxval] in source space; all_boxes (N, 6)
        [cx, cy, sx, sy, area, box_score]; img_path list with COCO names.
        """
        kpts_by_image = defaultdict(list)
        for i, kpt in enumerate(preds):
            image_id = int(os.path.basename(str(img_path[i]))[-16:-4])
            kpts_by_image[image_id].append({
                "keypoints": np.asarray(kpt),
                "center": np.asarray(all_boxes[i][0:2]),
                "scale": np.asarray(all_boxes[i][2:4]),
                "area": float(all_boxes[i][4]),
                "score": float(all_boxes[i][5]),
                "image": image_id,
            })

        results = []
        for image_id, img_kpts in kpts_by_image.items():
            for p in img_kpts:
                kscores = p["keypoints"][:, 2]
                valid = kscores > self.in_vis_thre
                kpt_score = kscores[valid].mean() if valid.any() else 0.0
                p["score"] = float(kpt_score * p["score"])
            kflat = np.stack([p["keypoints"].ravel() for p in img_kpts])
            scores = np.array([p["score"] for p in img_kpts])
            areas = np.array([p["area"] for p in img_kpts])
            nms = soft_oks_nms if self.soft_nms else oks_nms
            keep = nms(kflat, scores, areas, self.oks_thre)
            kept = img_kpts if not keep else [img_kpts[k] for k in keep]
            for p in kept:
                results.append({
                    "image_id": image_id,
                    "category_id": self._person_cat_id,
                    "keypoints": p["keypoints"].ravel().tolist(),
                    "score": p["score"],
                    "center": p["center"].tolist(),
                    "scale": p["scale"].tolist(),
                })

        if output_dir:
            res_dir = os.path.join(output_dir, "results")
            os.makedirs(res_dir, exist_ok=True)
            res_file = os.path.join(
                res_dir, f"keypoints_{self.image_set}_results_0.json")
            with open(res_file, "w") as f:
                json.dump(results, f, sort_keys=True, indent=4)

        if "test" in self.image_set:
            return {"Null": 0}, 0

        gt_anns = [a for anns in self._anns_by_image.values() for a in anns]
        evaluator = COCOKeypointEval(gt_anns, self.image_ids)
        name_values = evaluator.evaluate(results)
        return name_values, name_values["AP"]
