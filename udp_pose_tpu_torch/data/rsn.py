"""RSN's datasets: COCO and MPII with RSN's boxes, augmentation, labels
and evaluation.

Port of ``udp_pose_tpu/data/rsn.py`` (parity: RSN/dataset/attribute.py
:8-100 for the constants; RSN/dataset/JointsDataset.py:124-224 for
``__getitem__``: the basic and random box extension, the aspect fit,
the shrink-scale augmentation, the inverse-warp joint transform with
out-of-bounds joints invalidated and the five-kernel 255-scale label
pyramid; RSN/dataset/COCO/coco.py for the gt and detection dbs).  The
json parsing is :class:`.coco.COCODataset`'s and the MPII db
:class:`.mpii.MPIIDataset`'s.  RSN reads BGR images (``COLOR_RGB
false`` in its yamls).  Samples: image (H, W, 3) u8, labels (5, J, h, w)
and valid (J, 1) in training, and center, scale, score, image_path.
"""

from __future__ import annotations

import copy
import json
import os

import numpy as np

from ..ops.affine import udp_rotate_joints_np, udp_warp_matrix_np
from ..ops.targets import rsn_targets_np
from .base import JointsDataset
from .coco import COCODataset
from .mpii import MPIIDataset

# RSN/dataset/attribute.py constants (COCO)
RSN_COCO = dict(
    basic_ext=0.05, rand_ext=True, x_ext=0.6, y_ext=0.8,
    scale_factor_low=-0.25, scale_factor_high=0.25, scale_shrink_ratio=0.8,
    rotation_factor=45, prob_rotation=0.5, prob_flip=0.5,
    num_keypoints_half_body=3, prob_half_body=0.3,
    x_ext_half_body=0.6, y_ext_half_body=0.8,
    gaussian_kernels=(15, 11, 9, 7, 5),
    test_x_ext=0.09, test_y_ext=0.135,
    test_shift_ratios=(0.25,), test_gaussian_kernel=5,
)
RSN_MPII = dict(
    basic_ext=0.0, rand_ext=False, x_ext=0.25, y_ext=0.25,
    scale_factor_low=-0.25, scale_factor_high=0.25, scale_shrink_ratio=1.0,
    rotation_factor=60, prob_rotation=0.5, prob_flip=0.5,
    num_keypoints_half_body=8, prob_half_body=0.5,
    x_ext_half_body=0.6, y_ext_half_body=0.6,
    gaussian_kernels=(15, 11, 9, 7, 5),
    test_x_ext=0.25, test_y_ext=0.25,
    test_shift_ratios=(0.25,), test_gaussian_kernel=9,
)


class RSNCOCODataset(COCODataset):
    """COCO with RSN's db, augmentation, five-kernel targets and
    evaluation."""

    kp_load_min_num = 1  # RSN/dataset/attribute.py KEYPOINT.LOAD_MIN_NUM

    def __init__(self, cfg, root, image_set, is_train):
        super().__init__(cfg, root, image_set, is_train)
        self.attr = dict(RSN_COCO)
        self.w_h_ratio = self.aspect_ratio

    # -- db: RSN's semantics, not deep_hrnet's ------------------------------

    def _xywh2cs(self, x, y, w, h):
        """RSN _bbox_to_center_and_scale (RSN/dataset/COCO/coco.py:128-138):
        the raw box → center/scale, with no aspect fit and no ×1.25 (the
        fit and the test extension happen in ``__getitem__``)."""
        center = np.array([x + w / 2.0, y + h / 2.0], np.float32)
        scale = np.array([w / self.pixel_std, h / self.pixel_std],
                         np.float32)
        return center, scale

    def _load_gt_db(self):
        """RSN gt loading (RSN/dataset/COCO/coco.py:53-90): the ann file's
        order, crowds dropped, the visible-count and num_keypoints
        filters, the raw visibility flags kept (the loss gates them at
        > 1 and > 0, RSN/lib/utils/loss.py:30,37); no box sanitising."""
        db = []
        for obj in self._ann_list:
            image_id = obj["image_id"]
            if image_id not in self._images or obj.get("iscrowd"):
                continue
            joints = np.asarray(obj["keypoints"], np.float64).reshape(-1, 3)
            if (joints[:, 2] > 0).sum() < self.kp_load_min_num or \
                    obj.get("num_keypoints", 0) == 0:
                continue
            center, scale = self._xywh2cs(*np.asarray(obj["bbox"],
                                                      np.float64)[:4])
            vis = np.zeros((self.num_joints, 3))
            vis[:, 0] = joints[:, 2]
            vis[:, 1] = joints[:, 2]
            db.append({
                "image": self.image_path(image_id), "image_id": image_id,
                "center": center, "scale": scale,
                "joints_3d": joints, "joints_3d_vis": vis,
            })
        return db

    def _load_detection_db(self):
        """RSN detection loading (RSN/dataset/COCO/coco.py:92-125): every
        person box whose image exists, with no score threshold."""
        with open(self.bbox_file) as f:
            dets = json.load(f)
        db = []
        for det in dets:
            if det.get("category_id") != 1 or \
                    det["image_id"] not in self._images:
                continue
            center, scale = self._xywh2cs(*np.asarray(det["bbox"],
                                                      np.float64)[:4])
            db.append({
                "image": self.image_path(det["image_id"]),
                "image_id": det["image_id"],
                "center": center, "scale": scale,
                "score": det["score"],
                "joints_3d": np.zeros((self.num_joints, 3)),
                "joints_3d_vis": np.zeros((self.num_joints, 3)),
            })
        return db

    # -- evaluation: RSN's protocol -----------------------------------------

    def evaluate(self, cfg, preds, output_dir, all_boxes, img_path,
                 *args, **kwargs):
        """RSN's results (RSN/exps/RSN18.coco/test.py:98-116,186-195):
        score = box score × the mean of all keypoint maxvals (no
        visibility threshold), and no OKS-NMS: every box keeps its
        result."""
        from ..eval.cocoeval import COCOKeypointEval
        results = []
        for i, kpt in enumerate(preds):
            kpt = np.asarray(kpt)
            image_id = int(os.path.basename(str(img_path[i]))[-16:-4])
            results.append({
                "image_id": image_id,
                "category_id": self._person_cat_id,
                "keypoints": kpt.ravel().tolist(),
                "score": float(all_boxes[i][5]) * float(kpt[:, 2].mean()),
            })
        if output_dir:
            res_dir = os.path.join(output_dir, "results")
            os.makedirs(res_dir, exist_ok=True)
            with open(os.path.join(
                    res_dir,
                    f"keypoints_{self.image_set}_results_0.json"), "w") as f:
                json.dump(results, f, sort_keys=True, indent=4)
        if "test" in self.image_set:
            return {"Null": 0}, 0
        gt_anns = [a for anns in self._anns_by_image.values() for a in anns]
        name_values = COCOKeypointEval(gt_anns,
                                       self.image_ids).evaluate(results)
        return name_values, name_values["AP"]

    # -- samples ------------------------------------------------------------

    def half_body_transform_rsn(self, joints, joints_vis, rng):
        """RSN's half-body box (JointsDataset.py:232-274): the midpoint of
        the selected joints, a random extension, no ×1.5."""
        upper, lower = [], []
        for j in range(self.num_joints):
            if joints_vis[j, 0] > 0:
                (upper if j in self.upper_body_ids else lower).append(
                    joints[j])
        selected = (upper if (rng.standard_normal() < 0.5 and len(upper) > 3)
                    else (lower if len(lower) > 3 else upper))
        if len(selected) < 3:
            return None, None
        selected = np.array(selected, np.float32)
        lt, rb = selected.min(0), selected.max(0)
        center = (lt + rb) / 2
        w = (rb[0] - lt[0]) * (1 + rng.random()
                               * self.attr["x_ext_half_body"])
        h = (rb[1] - lt[1]) * (1 + rng.random()
                               * self.attr["y_ext_half_body"])
        if w > self.w_h_ratio * h:
            h = w / self.w_h_ratio
        else:
            w = h * self.w_h_ratio
        return center, np.array([w / self.pixel_std, h / self.pixel_std],
                                np.float32)

    def __getitem__(self, idx):
        """Parity: RSN JointsDataset.py:124-224, the draws in the JAX
        package's order."""
        rec = copy.deepcopy(self.db[idx])
        rng = self._rng
        a = self.attr
        img = self._read_image(rec["image"])
        joints = rec["joints_3d"][:, :2].copy()
        joints_vis = rec["joints_3d_vis"][:, :1].copy()
        center = np.asarray(rec["center"], np.float64).copy()
        scale = np.asarray(rec["scale"], np.float64).copy()
        score = rec.get("score", 1)
        rotation = 0.0

        if self.is_train:
            scale[0] *= (1 + a["basic_ext"])
            scale[1] *= (1 + a["basic_ext"])
            r0 = rng.random() if a["rand_ext"] else 1.0
            scale[0] *= (1 + r0 * a["x_ext"])
            r1 = rng.random() if a["rand_ext"] else 1.0
            scale[1] *= (1 + r1 * a["y_ext"])
        else:
            scale[0] *= (1 + a["test_x_ext"])
            scale[1] *= (1 + a["test_y_ext"])

        if scale[0] > self.w_h_ratio * scale[1]:
            scale[1] = scale[0] / self.w_h_ratio
        else:
            scale[0] = scale[1] * self.w_h_ratio

        if self.is_train:
            if (np.sum(joints_vis[:, 0] > 0) > a["num_keypoints_half_body"]
                    and rng.random() < a["prob_half_body"]):
                c_hb, s_hb = self.half_body_transform_rsn(joints, joints_vis,
                                                          rng)
                if c_hb is not None:
                    center = c_hb.astype(np.float64)
                    scale = s_hb.astype(np.float64)
            rand = rng.uniform(1 + a["scale_factor_low"],
                               1 + a["scale_factor_high"])
            scale = scale * (a["scale_shrink_ratio"] * rand)
            if rng.random() <= a["prob_rotation"]:
                rotation = rng.uniform(-a["rotation_factor"],
                                       a["rotation_factor"])
            if rng.random() <= a["prob_flip"]:
                # RSN flip_joints (RSN/lib/utils/transforms.py:70-79):
                # mirror x, swap the pairs; visibility is not zeroed
                img = img[:, ::-1, :]
                joints[:, 0] = img.shape[1] - joints[:, 0] - 1
                for p, q in self.flip_pairs:
                    joints[[p, q]] = joints[[q, p]]
                    joints_vis[[p, q]] = joints_vis[[q, p]]
                center[0] = img.shape[1] - center[0] - 1

        wh = (int(self.image_size[0]), int(self.image_size[1]))
        crop = self._warp(img, udp_warp_matrix_np(rotation, center, scale,
                                                  wh))
        sample = {
            "image": np.ascontiguousarray(crop),
            "center": center.astype(np.float32),
            "scale": scale.astype(np.float32),
            "score": np.float32(score),
            "image_path": rec["image"],
        }
        if self.is_train:
            # joints → crop space through the inverse warp; joints out of
            # the crop are invalidated (RSN JointsDataset.py:203-211)
            mapped = udp_rotate_joints_np(joints, rotation, center, scale,
                                          wh)
            valid = joints_vis[:, 0].copy()
            w, h = wh
            for j in range(self.num_joints):
                if valid[j] > 0 and not (0 <= mapped[j, 0] <= w - 1
                                         and 0 <= mapped[j, 1] <= h - 1):
                    valid[j] = 0
            sample["labels"] = rsn_targets_np(
                mapped, valid, tuple(self.heatmap_size),
                tuple(self.image_size), a["gaussian_kernels"])
            sample["valid"] = valid.reshape(-1, 1).astype(np.float32)
        return sample


class RSNMPIIDataset(RSNCOCODataset):
    """RSN's augmentation and targets over the MPII db (attribute.py's
    MPII constants), evaluated with PCKh."""

    num_joints = MPIIDataset.num_joints
    flip_pairs = MPIIDataset.flip_pairs
    upper_body_ids = MPIIDataset.upper_body_ids
    lower_body_ids = MPIIDataset.lower_body_ids

    def __init__(self, cfg, root, image_set, is_train):
        JointsDataset.__init__(self, cfg, root, image_set, is_train)
        self.db = MPIIDataset._get_db(self)
        if is_train and cfg.DATASET.SELECT_DATA:
            self.db = self.select_data(self.db)
        self.attr = dict(RSN_MPII)
        self.w_h_ratio = self.aspect_ratio

    def evaluate(self, cfg, preds, output_dir, *args, **kwargs):
        return MPIIDataset.evaluate(self, cfg, preds, output_dir)
