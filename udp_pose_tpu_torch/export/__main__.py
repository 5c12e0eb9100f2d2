"""Model export CLI of the PyTorch port (port of ``tools/export.py``;
parity role: deep_hrnet/tools/export.py).

    python -m udp_pose_tpu_torch.export --cfg exp.yaml [--weights w.pth]
        [--batch 1] [--out model.onnx] [--format onnx|pth] [--skip-check]
        [--device cuda|cpu] [KEY VALUE ...]
    python -m udp_pose_tpu_torch.export --yolo yolov5n [--det-size 640]
        [--weights yolov5n.pt] [--out yolov5n.onnx]

* ``onnx`` (the default) — an opset-11 ``.onnx`` artifact written by the
  port's own protobuf writer (no onnx package), float32, with the
  reference torch keys as initializer names; unless ``--skip-check``,
  it is run by the port's evaluator on ``--device`` (float32, TF32 off)
  and held against the model's forward there (the reference's
  ``np.testing.assert_allclose``, export.py:56).  ``--yolo`` exports the
  YOLOv5 detector instead, with its anchor decode.
* ``pth`` — the reference-format state dict, which the reference models
  (and ``--weights`` of the port's CLIs) load with ``strict=True``.

``stablehlo``, ``tflite``, ``savedmodel`` and ``--quantize`` are jax2tf
artifacts of the JAX package's exporter; the port does not make them.
``--weights``: a ``.pth``, a ``.msgpack`` of the JAX package's variables
or an ``.onnx`` artifact (for ``--yolo``: an ultralytics state dict or a
``.msgpack`` of the JAX package's YOLOv5); none exports the seeded random
init.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

JAX2TF_FORMATS = ("stablehlo", "tflite", "savedmodel")


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="export a pose model (or --yolo) as .onnx or .pth")
    p.add_argument("--cfg", default="")
    p.add_argument("--yolo", default="",
                   help="export the YOLOv5 detector instead of a pose "
                        "model, e.g. 'yolov5n' (--format onnx only)")
    p.add_argument("--det-size", type=int, default=640)
    p.add_argument("--weights", default="")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--out", default="")
    p.add_argument("--format", default="onnx",
                   choices=("onnx", "pth") + JAX2TF_FORMATS)
    p.add_argument("--quantize", default="",
                   help="TFLite post-training quantisation of the JAX "
                        "package's exporter; the port refuses it")
    p.add_argument("--skip-check", action="store_true",
                   help="skip the output-parity verification run")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu': where the model and "
                        "the parity check run")
    p.add_argument("opts", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def _check(blob, model, x, rtol, atol, device):
    """Hold ``blob`` run by the evaluator against ``model``'s forward of
    ``x`` (NCHW float32) on ``device``, both float32 with TF32 off."""
    from .onnx_eval import check_model, fp32_exact
    with torch.inference_mode(), fp32_exact(device):
        y = model(torch.from_numpy(x).to(device)).float().cpu().numpy()
    atol = atol(y)
    t0 = time.perf_counter()
    err = check_model(blob, x, y, rtol=rtol, atol=atol, device=device)
    print(f"onnx-vs-torch parity OK on {device} (max abs err {err:.2e}, "
          f"atol {atol:.2e}; evaluator {time.perf_counter() - t0:.3f} s)")
    return err


def export_yolo(args, device):
    """The YOLOv5 detector → parity-checked ``.onnx``."""
    from ..models import build_detector
    from ..utils.convert import load_yolov5_weights, state_dict_to_torch
    from .onnx_yolo import export_yolov5

    if args.format != "onnx":
        raise SystemExit("--yolo supports --format onnx")
    variant = args.yolo.replace("yolov5", "") or "n"
    model = build_detector(variant, device=device)
    if args.weights:
        model.load_state_dict(state_dict_to_torch(
            load_yolov5_weights(args.weights)), strict=True)
    s = args.det_size
    blob = export_yolov5(model, variant, image_hw=(s, s), batch=args.batch)
    out_path = args.out or f"yolov5{variant}.onnx"
    with open(out_path, "wb") as f:
        f.write(blob)
    if not args.skip_check:
        x = np.random.default_rng(1).random(
            (args.batch, 3, s, s)).astype(np.float32)
        _check(blob, model, x, 1e-3, lambda y: 2e-3, device)
    print(f"exported {out_path} ({len(blob)} bytes)")
    return out_path


def main(argv=None):
    args = parse_args(argv)
    from ..utils.platform import resolve_device

    if args.format in JAX2TF_FORMATS or args.quantize:
        what = (f"--format {args.format}" if args.format in JAX2TF_FORMATS
                else "--quantize")
        raise SystemExit(
            f"{what} is a jax2tf artifact of the JAX package's exporter "
            "(tools/export.py); the PyTorch port does not make it: use "
            "--format onnx or pth")
    device = resolve_device(args.device)
    if args.yolo:
        return export_yolo(args, device)
    if not args.cfg:
        raise SystemExit("--cfg is required (or use --yolo)")
    from ..config import load_config
    from ..models import build_model
    from ..utils.convert import read_weights, state_dict_to_torch
    from .onnx_families import export_onnx_from_cfg, numpy_state_dict

    cfg = load_config(args.cfg, args.opts)
    # deploy artifacts are float32 (the reference exports fp32 ONNX)
    cfg.TPU.DTYPE = "float32"
    model = build_model(cfg, device=device)
    if args.weights:
        model.load_state_dict(state_dict_to_torch(
            read_weights(args.weights, cfg)), strict=True)
    stem = os.path.splitext(args.cfg)[0]

    if args.format == "pth":
        sd = numpy_state_dict(model)
        out_path = args.out or stem + ".pth"
        torch.save({k: torch.from_numpy(np.array(v, order="C"))
                    for k, v in sd.items()}, out_path)
        print(f"exported reference-format state_dict ({len(sd)} tensors) "
              f"-> {out_path}")
        return out_path

    t0 = time.perf_counter()
    blob = export_onnx_from_cfg(model, cfg, batch=args.batch)
    out_path = args.out or stem + ".onnx"
    with open(out_path, "wb") as f:
        f.write(blob)
    print(f"exported ONNX opset 11 ({len(blob)} bytes, "
          f"{time.perf_counter() - t0:.3f} s) -> {out_path}")
    if not args.skip_check:
        w, h = cfg.MODEL.IMAGE_SIZE
        x = np.random.default_rng(0).normal(
            size=(args.batch, 3, h, w)).astype(np.float32)
        # atol scales with the output: random-init weights can blow the
        # activations up, and with them float32 rounding
        _check(blob, model, x, 1e-2,
               lambda y: max(1e-3, 1e-5 * float(np.abs(y).max())), device)
    return out_path


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
