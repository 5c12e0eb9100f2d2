"""Top-down pose engine: ``infer_pose(img, boxes) → (keypoints, maxvals)``.

Port of ``udp_pose_tpu/engine/pose_engine.py`` (reference deep_hrnet/
pose_engine.py:15-228).  Person crops are warped on the host by the
native batch warp (``server.host_crops``), padded to a power-of-two
bucket, and run through one :func:`..core.infer.make_infer_fn` graph on
the device.  Box → crop geometry is the reference's: xyxy → center/scale
with the model aspect ratio and ×1.25 (:55-63), then the classic 3-point
affine (tools/infer_utils/utils.py:157-177).
"""

from __future__ import annotations

import os

import numpy as np

from ..utils.platform import resolve_device


def _next_bucket(n, buckets=(1, 2, 4, 8, 16, 32, 64, 128)):
    for b in buckets:
        if n <= b:
            return b
    return ((n + 127) // 128) * 128


class UdpPosePipeline:
    """Build from a config (yaml path or Node) + weights on ``device``.

    ``weights``: a reference ``.pth`` path, the JAX package's variables
    (a dict with ``params`` and ``batch_stats``), or a state_dict of the
    port's keys; None keeps the seeded random init (smoke mode).
    """

    def __init__(self, cfg, weights=None, flip_test=None, device="cuda",
                 seed=0):
        from ..config import Node, load_config
        from ..core.infer import (COCO_FLIP_PAIRS, MPII_FLIP_PAIRS,
                                  make_infer_fn)
        from ..models import build_model

        self.device = resolve_device(device)
        if not isinstance(cfg, Node):
            cfg = load_config(cfg)
        self.cfg = cfg
        self.input_wh = tuple(cfg.MODEL.IMAGE_SIZE)
        self.num_joints = cfg.MODEL.NUM_JOINTS
        dataset = cfg.DATASET.DATASET.lower()
        self.flip_pairs = (MPII_FLIP_PAIRS if dataset == "mpii"
                           else COCO_FLIP_PAIRS)
        self.model = build_model(cfg, device=self.device, seed=seed)
        if weights is not None:
            self.load_weights(weights)
        self.flip_test = bool(cfg.TEST.FLIP_TEST if flip_test is None
                              else flip_test)
        self.infer_fn = make_infer_fn(
            self.model, target_type=cfg.MODEL.TARGET_TYPE,
            flip_test=self.flip_test, post_process=cfg.TEST.POST_PROCESS,
            kpd=cfg.LOSS.KPD, flip_pairs=self.flip_pairs,
            flip_mode=cfg.TEST.get("FLIP_MODE", "fold"),
            return_heatmaps=False)

    def load_weights(self, weights):
        """Load ``weights`` (see the class doc) with ``strict=True``."""
        from ..utils.convert import (load_torch_state_dict,
                                     state_dict_to_torch,
                                     variables_to_state_dict)
        if isinstance(weights, (str, os.PathLike)):
            if not str(weights).endswith(".pth"):
                raise ValueError(f"weights {weights!r}: only reference "
                                 ".pth files load in the port so far")
            sd = load_torch_state_dict(weights)
        elif "params" in weights:
            sd = variables_to_state_dict(weights, self.cfg)
        else:
            sd = weights
        self.model.load_state_dict(state_dict_to_torch(sd), strict=True)

    def infer_crops(self, crops_u8, center, scale):
        """(n, h, w, 3) u8 crops + (n, 2) center/scale → numpy
        (keypoints (n, J, 2), maxvals (n, J, 1)); the batch is padded to
        its power-of-two bucket by repeating the first crop."""
        n = crops_u8.shape[0]
        pad = _next_bucket(n) - n
        if pad:
            crops_u8 = np.concatenate(
                [crops_u8, np.repeat(crops_u8[:1], pad, axis=0)])
            center = np.concatenate([center, np.repeat(center[:1], pad, 0)])
            scale = np.concatenate([scale, np.repeat(scale[:1], pad, 0)])
        preds, maxvals, _ = self.infer_fn(crops_u8, center, scale)
        return preds.cpu().numpy()[:n], maxvals.cpu().numpy()[:n]

    def infer_pose(self, img, boxes):
        """img (H, W, 3) RGB uint8; boxes (N, ≥4) xyxy.
        Returns (keypoints (N, J, 2) float32, maxvals (N, J, 1))."""
        from .server import host_crops

        boxes = np.asarray(boxes, np.float32)
        if boxes.shape[0] == 0:
            return (np.zeros((0, self.num_joints, 2), np.float32),
                    np.zeros((0, self.num_joints, 1), np.float32))
        return self.infer_crops(*host_crops(img, boxes, self.input_wh))
