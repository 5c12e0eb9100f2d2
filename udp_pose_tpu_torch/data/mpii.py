"""MPII dataset and PCKh evaluation (port of ``udp_pose_tpu/data/mpii.py``).

Parity: deep_hrnet/lib/dataset/mpii.py — the json db :43-94 (MATLAB
1-based coordinates, the center's y-shift, the ×1.25 scale) and the
PCKh@0.5 / @0.1 evaluation against the ``.mat`` ground truth :96-181.
scipy is imported inside :meth:`MPIIDataset.evaluate` only.
"""

from __future__ import annotations

import json
import os
from collections import OrderedDict

import numpy as np

from .base import JointsDataset

SC_BIAS = 0.6          # head-box diagonal → head size (mpii.py:128)


class MPIIDataset(JointsDataset):
    num_joints = 16
    flip_pairs = [[0, 5], [1, 4], [2, 3], [10, 15], [11, 14], [12, 13]]
    parent_ids = [1, 2, 6, 6, 3, 4, 6, 6, 7, 8, 11, 12, 7, 7, 13, 14]
    upper_body_ids = (7, 8, 9, 10, 11, 12, 13, 14, 15)
    lower_body_ids = (0, 1, 2, 3, 4, 5, 6)

    def __init__(self, cfg, root, image_set, is_train):
        super().__init__(cfg, root, image_set, is_train)
        self.db = self._get_db()
        if is_train and cfg.DATASET.SELECT_DATA:
            self.db = self.select_data(self.db)

    def _get_db(self):
        file_name = os.path.join(self.root, "annot", self.image_set + ".json")
        with open(file_name) as f:
            anno = json.load(f)
        db = []
        for a in anno:
            c = np.array(a["center"], np.float64)
            s = np.array([a["scale"], a["scale"]], np.float64)
            if c[0] != -1:
                c[1] = c[1] + 15 * s[1]
                s = s * 1.25
            c = c - 1          # MATLAB 1-based → 0-based
            joints = np.zeros((self.num_joints, 3))
            vis = np.zeros((self.num_joints, 3))
            if self.image_set != "test":
                j = np.array(a["joints"], np.float64)
                joints[:, 0:2] = j[:, 0:2] - 1
                jv = np.array(a["joints_vis"], np.float64)
                vis[:, 0] = jv
                vis[:, 1] = jv
            db.append({
                "image": os.path.join(self.root, "images", a["image"]),
                "center": c, "scale": s,
                "joints_3d": joints, "joints_3d_vis": vis,
            })
        return db

    def evaluate(self, cfg, preds, output_dir, *args, **kwargs):
        """PCKh of ``preds`` (N, J, ≥2) in 0-based source pixels against
        ``annot/gt_{TEST_SET}.mat``; writes ``pred.mat`` (1-based) to
        ``output_dir``.  Returns (name_values, mean PCKh@0.5)."""
        from scipy.io import loadmat, savemat

        preds = preds[:, :, 0:2] + 1.0
        if output_dir:
            os.makedirs(output_dir, exist_ok=True)
            savemat(os.path.join(output_dir, "pred.mat"),
                    mdict={"preds": preds})
        if "test" in cfg.DATASET.TEST_SET:
            return {"Null": 0.0}, 0.0

        gt = loadmat(os.path.join(cfg.DATASET.ROOT, "annot",
                                  f"gt_{cfg.DATASET.TEST_SET}.mat"))
        dataset_joints = gt["dataset_joints"]
        jnt_visible = 1 - gt["jnt_missing"]
        pos_gt_src = gt["pos_gt_src"]
        headboxes_src = gt["headboxes_src"]

        def jidx(name):
            return np.where(dataset_joints == name)[1][0]

        uv_err = np.linalg.norm(np.transpose(preds, [1, 2, 0]) - pos_gt_src,
                                axis=1)
        headsizes = np.linalg.norm(
            headboxes_src[1] - headboxes_src[0], axis=0) * SC_BIAS
        # invisible joints are masked after the scaling, as the reference
        scaled = uv_err / headsizes[None, :] * jnt_visible
        jnt_count = jnt_visible.sum(axis=1)
        pckh = (100.0 * ((scaled <= 0.5) * jnt_visible).sum(axis=1)
                / jnt_count)
        pck01 = (100.0 * ((scaled <= 0.11) * jnt_visible).sum(axis=1)
                 / jnt_count)

        mask = np.ones(16, bool)
        mask[6:8] = False          # pelvis and thorax (mpii.py:164-168)
        jc = np.where(mask, jnt_count, 0)
        jnt_ratio = jc / jc.sum()

        def pair(a, b):
            return 0.5 * (pckh[jidx(a)] + pckh[jidx(b)])

        name_value = OrderedDict([
            ("Head", pckh[jidx("head")]),
            ("Shoulder", pair("lsho", "rsho")),
            ("Elbow", pair("lelb", "relb")),
            ("Wrist", pair("lwri", "rwri")),
            ("Hip", pair("lhip", "rhip")),
            ("Knee", pair("lkne", "rkne")),
            ("Ankle", pair("lank", "rank")),
            ("Mean", float((pckh * jnt_ratio).sum())),
            ("Mean@0.1", float((pck01 * jnt_ratio).sum())),
        ])
        return name_value, name_value["Mean"]
