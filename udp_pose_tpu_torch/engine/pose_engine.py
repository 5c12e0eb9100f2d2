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
import torch

from ..utils.platform import resolve_device

SKELETONS = {  # 1-based joint pairs (pose_engine.py:17-26)
    "coco": [[16, 14], [14, 12], [17, 15], [15, 13], [12, 13], [6, 12],
             [7, 13], [6, 7], [6, 8], [7, 9], [8, 10], [9, 11], [2, 3],
             [1, 2], [1, 3], [2, 4], [3, 5], [4, 6], [5, 7]],
    "mpii": [[9, 10], [12, 13], [12, 11], [3, 2], [2, 1], [14, 15],
             [15, 16], [4, 5], [5, 6], [9, 8], [8, 7], [7, 3], [7, 4],
             [9, 13], [9, 14]],
}


def _next_bucket(n, buckets=(1, 2, 4, 8, 16, 32, 64, 128)):
    for b in buckets:
        if n <= b:
            return b
    return ((n + 127) // 128) * 128


class UdpPosePipeline:
    """Build from a config (yaml path or Node) + weights on ``device``.

    ``weights``: a reference ``.pth`` path, a ``.msgpack`` path of the JAX
    package's variables (its ``save_weights``), those variables (a dict
    with ``params`` and ``batch_stats``), or a state_dict of the port's
    keys; None keeps the seeded random init (smoke mode).
    ``quantize="int8"`` serves w8a8 convs (:mod:`..models.quantize`);
    ``act_scales`` is a calibration table (dict or json path), and without
    one the first ``calib_batches`` batches (default
    ``TPU.QUANTIZE_CALIB_BATCHES``) calibrate it.
    """

    def __init__(self, cfg, weights=None, flip_test=None, device="cuda",
                 seed=0, quantize=None, act_scales=None, calib_batches=None):
        from ..config import Node, load_config
        from ..core.infer import COCO_FLIP_PAIRS, MPII_FLIP_PAIRS
        from ..models import build_model
        from ..models.quantize import SelfCalibrating

        self.device = resolve_device(device)
        if not isinstance(cfg, Node):
            cfg = load_config(cfg)
        if cfg.MODEL.NAME == "rsn":
            # RSN reads BGR crops with its own constants and decodes by
            # blur and shifted argmax (core.rsn.make_rsn_infer_fn), none of
            # which this pipeline's graph or the detect-then-pose graph has
            raise NotImplementedError(
                "serving RSN (MODEL.NAME rsn) through UdpPosePipeline is "
                "not ported to udp_pose_tpu_torch yet: evaluate it with "
                "python -m udp_pose_tpu_torch.test")
        self.cfg = cfg
        self.input_wh = tuple(cfg.MODEL.IMAGE_SIZE)
        self.num_joints = cfg.MODEL.NUM_JOINTS
        dataset = cfg.DATASET.DATASET.lower()
        self.skeleton = SKELETONS.get(dataset)
        self.flip_pairs = (MPII_FLIP_PAIRS if dataset == "mpii"
                           else COCO_FLIP_PAIRS)
        self.model = build_model(cfg, device=self.device, seed=seed)
        if weights is not None:
            self.load_weights(weights)
        self.flip_test = bool(cfg.TEST.FLIP_TEST if flip_test is None
                              else flip_test)
        # int8 PTQ serving (models/quantize.py), gated as in the JAX
        # package: an explicit quantize= wins ("" is off), else a table is
        # the int8 request, else cfg.TPU.QUANTIZE.  Without a table the
        # first calib_batches batches serve in float while recording each
        # conv site's input amax, then the pipeline switches itself.
        self.int8 = SelfCalibrating(
            self.model, quantize, act_scales,
            cfg.TPU.QUANTIZE_CALIB_BATCHES if calib_batches is None
            else calib_batches, default=cfg.TPU.QUANTIZE)
        self._infer_fp = self._make_infer(self.model)
        self._infer_q = None

    def _make_infer(self, model):
        from ..core.infer import make_infer_fn
        cfg = self.cfg
        return make_infer_fn(
            model, target_type=cfg.MODEL.TARGET_TYPE,
            flip_test=self.flip_test, post_process=cfg.TEST.POST_PROCESS,
            kpd=cfg.LOSS.KPD, flip_pairs=self.flip_pairs,
            flip_mode=cfg.TEST.get("FLIP_MODE", "fold"),
            return_heatmaps=False)

    def active_infer(self):
        """The graph that serves now: int8 once a table exists (its
        :class:`..models.quantize.QuantizedModel` is built at first use),
        else the float one."""
        model = self.int8.active()
        if model is self.model:
            return self._infer_fp
        if self._infer_q is None:
            self._infer_q = self._make_infer(model)
        return self._infer_q

    def infer_fn(self, crops_u8, center, scale):
        """(B, h, w, 3) u8 crops + (B, 2) center/scale → device tensors
        (preds (B, J, 2), maxvals (B, J, 1), None) through
        :meth:`active_infer`."""
        return self.active_infer()(crops_u8, center, scale)

    def save_act_scales(self, path):
        """Persist the calibration table (json) for later runs."""
        self.int8.save(path)

    def calibrate_crops(self, crops_u8):
        """Record each conv site's input amax on a u8 crop batch (n, h, w,
        3), normalised and cast to the compute dtype as serving feeds the
        stem; after ``calib_batches`` batches the table freezes and
        :meth:`active_infer` turns int8."""
        from ..core.infer import cast_to_compute_dtype, normalize_images
        x = normalize_images(torch.as_tensor(crops_u8, device=self.device))
        self.int8.record(cast_to_compute_dtype(self.model, x)
                         .permute(0, 3, 1, 2))

    def load_weights(self, weights):
        """Load ``weights`` (see the class doc) with ``strict=True``."""
        from ..utils.convert import (read_weights, state_dict_to_torch,
                                     variables_to_state_dict)
        if isinstance(weights, (str, os.PathLike)):
            sd = read_weights(weights, self.cfg)
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
        # while calibrating, the padded bucket is recorded and served in
        # float, the freeze batch included (pose_engine.py:273-284 there)
        calibrating = self.int8.calibrating
        if calibrating:
            self.calibrate_crops(crops_u8)
        infer = self._infer_fp if calibrating else self.active_infer()
        preds, maxvals, _ = infer(crops_u8, center, scale)
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

    def draw_keypoints(self, image, keypoints, radius=1):
        """Draw ``keypoints`` (N, J, 2) and the skeleton on ``image`` in
        place (OpenCV); returns it."""
        from .io import draw_keypoints
        return draw_keypoints(image, keypoints, self.skeleton, radius)
