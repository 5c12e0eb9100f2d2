"""ONNX emitter for the YOLOv5 detector (opset 11, NCHW; a copy of
``udp_pose_tpu/export/onnx_yolo.py``).

Consumes an ultralytics-layout state_dict without the ``model.`` prefix
(:func:`export_yolov5` strips the port's) and emits the FULL detector —
CSP backbone, SPPF, PANet, and the anchor decode to sigmoided
``(B, N, 5+nc)`` raw predictions in the exact row order of
models/yolov5.YOLOv5 — so the detect side of the detect-then-pose system
deploys beside the exported pose nets (the reference gets its detector
ONNX from the yolov5 submodule's own exporter).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..models.yolov5 import ANCHORS, STRIDES, VARIANTS, _make_divisible
from .onnx_build import GraphBuilder


def _silu(g: GraphBuilder, x: str) -> str:
    return g.mul(x, g.sigmoid(x))


def _unit(g: GraphBuilder, x: str, tp: str, stride: int = 1) -> str:
    """Conv-BN-SiLU (BN eps 1e-3, ultralytics convention)."""
    return _silu(g, g.bn(g.conv(x, f"{tp}.conv", stride=stride),
                         f"{tp}.bn", eps=1e-3))


def _bottleneck(g: GraphBuilder, x: str, tp: str, shortcut: bool,
                add_ok: bool) -> str:
    y = _unit(g, x, f"{tp}.cv1")
    y = _unit(g, y, f"{tp}.cv2")
    return g.add(y, x) if (shortcut and add_ok) else y


def _c3(g: GraphBuilder, x: str, tp: str, n: int, shortcut: bool) -> str:
    # c_ == features//2; bottlenecks keep c_ channels so the residual add
    # is always shape-legal inside C3
    a = _unit(g, x, f"{tp}.cv1")
    b = _unit(g, x, f"{tp}.cv2")
    for j in range(n):
        a = _bottleneck(g, a, f"{tp}.m.{j}", shortcut, True)
    return _unit(g, g.concat([a, b]), f"{tp}.cv3")


def _sppf(g: GraphBuilder, x: str, tp: str) -> str:
    x = _unit(g, x, f"{tp}.cv1")
    y1 = g.maxpool(x, kernel=5, stride=1, pad=2)
    y2 = g.maxpool(y1, kernel=5, stride=1, pad=2)
    y3 = g.maxpool(y2, kernel=5, stride=1, pad=2)
    return _unit(g, g.concat([x, y1, y2, y3]), f"{tp}.cv2")


def build_yolov5(sd: Dict[str, np.ndarray], variant: str = "n",
                 num_classes: int = 80, image_hw=(640, 640),
                 batch: int = 1) -> bytes:
    """YOLOv5 → ONNX bytes (raw predictions, the model's row order)."""
    d, w = VARIANTS[variant]
    ch = lambda c: _make_divisible(c * w)                # noqa: E731
    dn = lambda n: max(round(n * d), 1)                  # noqa: E731
    H, W = int(image_hw[0]), int(image_hw[1])
    no = 5 + num_classes

    g = GraphBuilder(sd, f"yolov5{variant}")
    x = _unit(g, "images", "0", stride=2)
    x = _unit(g, x, "1", stride=2)
    x = _c3(g, x, "2", dn(3), True)
    x = _unit(g, x, "3", stride=2)
    p3 = _c3(g, x, "4", dn(6), True)
    x = _unit(g, p3, "5", stride=2)
    p4 = _c3(g, x, "6", dn(9), True)
    x = _unit(g, p4, "7", stride=2)
    x = _c3(g, x, "8", dn(3), True)
    p5 = _sppf(g, x, "9")

    h10 = _unit(g, p5, "10")
    x = g.concat([g.upsample(h10, 2), p4])
    h13 = _c3(g, x, "13", dn(3), False)
    h14 = _unit(g, h13, "14")
    x = g.concat([g.upsample(h14, 2), p3])
    out3 = _c3(g, x, "17", dn(3), False)
    x = _unit(g, out3, "18", stride=2)
    out4 = _c3(g, g.concat([x, h14]), "20", dn(3), False)
    x = _unit(g, out4, "21", stride=2)
    out5 = _c3(g, g.concat([x, h10]), "23", dn(3), False)

    # detect head + anchor decode (models/yolov5.py:160-179 semantics)
    level_preds = []
    for li, feat in enumerate((out3, out4, out5)):
        na = len(ANCHORS[li])
        stride = STRIDES[li]
        fh, fw = H // stride, W // stride
        t = g.conv(feat, f"24.m.{li}", pad=0)             # (B, na*no, h, w)
        t = g.reshape(t, (batch, na, no, fh, fw))
        t = g.transpose(t, (0, 3, 4, 1, 2))               # B,h,w,na,no
        t = g.sigmoid(t)
        xy = g.slice_axis(t, 0, 2, axis=4)
        wh = g.slice_axis(t, 2, 4, axis=4)
        rest = g.slice_axis(t, 4, no, axis=4)

        gx, gy = np.meshgrid(np.arange(fw, dtype=np.float32),
                             np.arange(fh, dtype=np.float32))
        grid = np.stack([gx, gy], -1)[None, :, :, None, :]  # 1,h,w,1,2
        two = g.const("c_two", np.asarray([2.0], np.float32))
        half = g.const("c_half", np.asarray([0.5], np.float32))
        xy = g.node("Sub", [g.mul(xy, two), half])
        xy = g.add(xy, g.const(f"grid_{li}_{fh}x{fw}", grid))
        xy = g.mul(xy, g.const(f"stride_{li}",
                               np.asarray([float(stride)], np.float32)))
        wh = g.mul(wh, two)
        wh = g.mul(wh, wh)
        anchors = np.asarray(ANCHORS[li], np.float32)[None, None, None]
        wh = g.mul(wh, g.const(f"anchors_{li}", anchors))
        pred = g.concat([xy, wh, rest], axis=4)
        level_preds.append(g.reshape(pred, (batch, fh * fw * na, no)))

    g.concat(level_preds, axis=1, out="output")
    n_total = sum((H // s) * (W // s) * len(a)
                  for s, a in zip(STRIDES, ANCHORS))
    return g.finish("images", (batch, 3, H, W), "output",
                    (batch, n_total, no),
                    doc=f"yolov5{variant} {W}x{H} raw predictions")


def export_yolov5(model_or_state_dict, variant: str = "n",
                  image_hw=(640, 640), batch: int = 1) -> bytes:
    """The port's YOLOv5 (or its state dict, ``model.``-prefixed keys) →
    ONNX bytes; the initializers are named as the JAX package's exporter
    names them (the ultralytics keys without ``model.``)."""
    from .onnx_families import numpy_state_dict
    sd = {k[len("model."):] if k.startswith("model.") else k: v
          for k, v in numpy_state_dict(model_or_state_dict).items()}
    return build_yolov5(sd, variant, image_hw=image_hw, batch=batch)
