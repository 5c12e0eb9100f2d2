"""Dependency-light standalone pose engine.

Port of ``udp_pose_tpu/engine/standalone.py`` (parity:
deep_hrnet/tools/infer_standalone.py:11-179): no config object, no
training stack, resize-only preprocessing (:90-99, no letterbox) and the
plain argmax decode mapped back through the resize (:101-103).  The
backend is any callable ``(B, H, W, 3) float32 normalised → (B, h, w, J)
heatmaps``; :func:`onnx_model_fn` runs an exported ``.onnx`` artifact
through the port's evaluator on the card.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from ..core.infer import IMAGENET_MEAN, IMAGENET_STD


def onnx_model_fn(model_or_path, device="cuda") -> Callable:
    """Backend over an exported ``.onnx`` artifact — the counterpart of the
    reference's onnxruntime engine (tools/infer_standalone.py:110-127),
    executed by :mod:`..export.onnx_eval` on ``device``.

    Accepts a path, serialized bytes or a loaded model.  Takes and
    returns NHWC numpy arrays; the graph computes NCHW.  Inputs are
    chunked and zero-padded to the graph's fixed batch, so any person
    count works.  The initializers go to the device once, when the
    backend is made.
    """
    from ..export.onnx_eval import initializers_on, run_graph
    from ..export.onnx_pb import load_model
    from ..utils.platform import resolve_device

    device = resolve_device(device)
    if isinstance(model_or_path, str):
        with open(model_or_path, "rb") as f:
            model_or_path = f.read()
    model = (load_model(model_or_path)
             if isinstance(model_or_path, (bytes, bytearray))
             else model_or_path)
    initializers_on(model, device)
    in_name, in_shape = model.graph.inputs[0]
    out_name = model.graph.outputs[0][0]
    gb = int(in_shape[0])

    @torch.inference_mode()
    def fn(x_nhwc):
        x = torch.from_numpy(np.ascontiguousarray(x_nhwc, np.float32))
        x = x.to(device).permute(0, 3, 1, 2).contiguous()
        outs = []
        for i in range(0, x.shape[0], gb):
            chunk = x[i:i + gb]
            n = chunk.shape[0]
            if n < gb:
                chunk = torch.cat([chunk, chunk.new_zeros(
                    (gb - n, *chunk.shape[1:]))])
            outs.append(run_graph(model, {in_name: chunk},
                                  device)[out_name][:n])
        return torch.cat(outs).permute(0, 2, 3, 1).cpu().numpy()

    return fn


class StandalonePoseEngine:
    def __init__(self, model_fn: Callable,
                 input_wh: Tuple[int, int] = (192, 256)):
        self.model_fn = model_fn
        self.input_wh = input_wh

    def _preprocess(self, img, boxes):
        import cv2
        w, h = self.input_wh
        crops, metas = [], []
        for x1, y1, x2, y2 in np.asarray(boxes, int)[:, :4]:
            patch = img[y1:y2, x1:x2]
            if patch.size == 0:
                patch = np.zeros((h, w, 3), np.uint8)
            crop = cv2.resize(patch, (w, h), interpolation=cv2.INTER_LINEAR)
            crops.append(crop)
            metas.append((x1, y1, max(x2 - x1, 1), max(y2 - y1, 1)))
        x = np.stack(crops).astype(np.float32) / 255.0
        x = (x - np.asarray(IMAGENET_MEAN)) / np.asarray(IMAGENET_STD)
        return x.astype(np.float32), metas

    def infer_pose(self, img, boxes):
        """img RGB uint8; boxes (N, ≥4) xyxy → (keypoints (N, J, 2),
        maxvals (N, J, 1)) in source space."""
        x, metas = self._preprocess(img, boxes)
        out = np.asarray(self.model_fn(x))           # (N, h, w, J)
        out = out.transpose(0, 3, 1, 2)
        N, J, hh, hw = out.shape
        flat = out.reshape(N, J, -1)
        idx = flat.argmax(2)
        maxvals = flat.max(2)[..., None]
        px = (idx % hw).astype(np.float32)
        py = (idx // hw).astype(np.float32)
        w, h = self.input_wh
        kps = np.zeros((N, J, 2), np.float32)
        for i, (x1, y1, bw, bh) in enumerate(metas):
            kps[i, :, 0] = px[i] * (w / hw) * (bw / w) + x1
            kps[i, :, 1] = py[i] * (h / hh) * (bh / h) + y1
        return kps, maxvals
