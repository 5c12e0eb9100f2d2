"""Top-down pose engine: ``infer_pose(img, boxes) → (keypoints, maxvals)``.

Port of ``udp_pose_tpu/engine/pose_engine.py`` (reference deep_hrnet/
pose_engine.py:15-228).  :meth:`UdpPosePipeline.infer_pose` uploads the
frame once as u8 and warps every person's crop out of it on the device
(``ops/affine.crop_boxes``, float, not rounded), padded to a power-of-two
bucket; the crops of ``/v1/pose``'s batcher are warped on the host by
the native batch warp (``server.host_crops``, u8) and go through
:meth:`UdpPosePipeline.infer_crops`.  Either batch runs through one
serving graph: :func:`..core.infer.make_infer_fn` (normalise, forward,
flip test, the UDP decode), or for RSN :func:`..core.rsn.
make_rsn_infer_fn` on the crops in BGR order.  Box → crop geometry is
the reference's: xyxy → center/scale with the model aspect ratio and
×1.25 (:55-63), then the classic 3-point affine
(tools/infer_utils/utils.py:157-177).
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


def tile_first(pad, *arrays):
    """Each host array with its first row repeated ``pad`` times at the
    end: a batch padded to its bucket."""
    return tuple(np.concatenate([a, np.repeat(a[:1], pad, axis=0)])
                 for a in arrays)


def upload(array, device):
    """A host array onto ``device`` without waiting for it: staged in
    pinned memory when the device is a card, then copied on the current
    stream."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


class UdpPosePipeline:
    """Build from a config (yaml path or Node) + weights on ``device``.

    ``weights``: a reference ``.pth`` path, a ``.msgpack`` path of the JAX
    package's variables (its ``save_weights``), an ``.onnx`` artifact of
    the exporter (:mod:`..export`), those variables (a dict with
    ``params`` and ``batch_stats``), or a state_dict of the port's keys;
    None keeps the seeded random init (smoke mode).  ``MODEL.NAME rsn``
    serves through RSN's own inference (:func:`..core.rsn.
    make_rsn_infer_fn`: BGR crops, RSN's constants, its decode).
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
        self.cfg = cfg
        #: RSN reads BGR crops normalised with its BGR constants and
        #: decodes by blur and shifted argmax (core.rsn.make_rsn_infer_fn);
        #: the pipeline's public crops and frames are RGB
        self.bgr = cfg.MODEL.NAME == "rsn"
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
        if self.bgr:
            from ..core.rsn import make_rsn_infer_fn_from_cfg
            return make_rsn_infer_fn_from_cfg(
                model, cfg, self.flip_pairs, flip_test=self.flip_test)
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

    def infer_fn(self, crops, center, scale):
        """(B, h, w, 3) RGB crops (u8 or float in [0, 255], numpy or
        tensors) + (B, 2) center/scale → device tensors (preds (B, J, 2),
        maxvals (B, J, 1), heatmaps or None) through :meth:`active_infer`."""
        return self.active_infer()(self._model_order(crops), center, scale)

    def _model_order(self, x):
        """RGB images (..., 3) in the channel order the model reads: BGR
        for RSN (on the host for numpy, on the device for tensors)."""
        if not self.bgr:
            return x
        if torch.is_tensor(x):
            return x.flip(-1)
        return np.ascontiguousarray(np.asarray(x)[..., ::-1])

    def save_act_scales(self, path):
        """Persist the calibration table (json) for later runs."""
        self.int8.save(path)

    def calibrate_crops(self, crops):
        """Record each conv site's input amax on an RGB crop batch (n, h,
        w, 3), u8 or float, normalised and cast to the compute dtype as
        serving feeds the stem; after ``calib_batches`` batches the table
        freezes and :meth:`active_infer` turns int8."""
        self._record(self._model_order(crops))

    def _record(self, x):
        from ..core.infer import (cast_to_compute_dtype, normalize_images,
                                  serving_normalizer)
        x = normalize_images(torch.as_tensor(x, device=self.device),
                             *serving_normalizer(self.cfg))
        self.int8.record(cast_to_compute_dtype(self.model, x)
                         .permute(0, 3, 1, 2))

    def _serve(self, x, center, scale, n):
        """Serve a bucket-padded batch ``x`` in the model's channel order
        → numpy (keypoints (n, J, 2), maxvals (n, J, 1)) of its first
        ``n`` rows.  While int8 calibrates, the padded batch is recorded
        and served in float, the freeze batch included
        (pose_engine.py:127-138, :273-284 there)."""
        calibrating = self.int8.calibrating
        if calibrating:
            self._record(x)
        infer = self._infer_fp if calibrating else self.active_infer()
        preds, maxvals, _ = infer(x, center, scale)
        return preds.cpu().numpy()[:n], maxvals.cpu().numpy()[:n]

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
        """(n, h, w, 3) RGB u8 crops + (n, 2) center/scale → numpy
        (keypoints (n, J, 2), maxvals (n, J, 1)).  A host batch is padded
        to its power-of-two bucket by repeating the first crop; a batch of
        tensors already on the device must come padded to its bucket
        (``CropBatcher(pad_on_device=True)``)."""
        n = crops_u8.shape[0]
        pad = _next_bucket(n) - n
        if pad:
            if torch.is_tensor(crops_u8):
                raise ValueError(f"{n} device crops: pad them to the bucket "
                                 f"({n + pad}) on the device first")
            crops_u8, center, scale = tile_first(pad, crops_u8, center, scale)
        return self._serve(self._model_order(crops_u8), center, scale, n)

    def crop_frame(self, img, center, scale):
        """The frame's person crops on the device: ``img`` (H, W, 3) RGB u8
        uploaded once as u8, the destination → source classic affine of
        each (center, scale) row (:func:`..ops.affine.
        classic_affine_matrix`, inverted), and the bilinear warp
        (:func:`..ops.affine.crop_boxes`) → (B, h, w, 3) float32 crops in
        [0, 255], not rounded, as the JAX graph makes them
        (``udp_pose_tpu/engine/pose_engine.py:192-205``)."""
        from ..ops.affine import classic_affine_matrix, crop_boxes
        w, h = self.input_wh
        frame = upload(img, self.device)
        center = torch.as_tensor(center, dtype=torch.float32,
                                 device=self.device)
        scale = torch.as_tensor(scale, dtype=torch.float32,
                                device=self.device)
        mats = classic_affine_matrix(center, scale, 0.0, (w, h), inv=True)
        return crop_boxes(frame, mats, (h, w))

    @torch.inference_mode()
    def infer_pose(self, img, boxes):
        """img (H, W, 3) RGB uint8; boxes (N, ≥4) xyxy.
        Returns (keypoints (N, J, 2) float32, maxvals (N, J, 1)): the boxes
        padded to their bucket by repeating the first, the crops warped on
        the device (:meth:`crop_frame`), then the serving graph."""
        from ..ops.boxes import xyxy_to_cs

        boxes = np.asarray(boxes, np.float32)
        n = boxes.shape[0]
        if n == 0:
            return (np.zeros((0, self.num_joints, 2), np.float32),
                    np.zeros((0, self.num_joints, 1), np.float32))
        center, scale = xyxy_to_cs(boxes[:, :4], self.input_wh)
        center, scale = tile_first(_next_bucket(n) - n, center, scale)
        crops = self.crop_frame(img, center, scale)
        return self._serve(self._model_order(crops), center, scale, n)

    def draw_keypoints(self, image, keypoints, radius=1):
        """Draw ``keypoints`` (N, J, 2) and the skeleton on ``image`` in
        place (OpenCV); returns it."""
        from .io import draw_keypoints
        return draw_keypoints(image, keypoints, self.skeleton, radius)
