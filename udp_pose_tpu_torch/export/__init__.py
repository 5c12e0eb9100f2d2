"""ONNX export of the port's models, its evaluator, and the weight reader.

Port of ``udp_pose_tpu/export`` (the reference's deploy surface,
deep_hrnet/tools/export.py): a self-contained protobuf writer and reader
(:mod:`.onnx_pb`, numpy only), the per-family graph emitters over the
models' reference-key state dicts, and the opset-11 evaluator in torch
(:mod:`.onnx_eval`), which runs on the card.  ``python -m
udp_pose_tpu_torch.export`` is the command line (:mod:`.__main__`).
"""

from .onnx_eval import check_model, run_model
from .onnx_families import export_onnx_from_cfg
from .onnx_pb import load_model

__all__ = ["export_onnx_from_cfg", "run_model", "check_model",
           "load_model"]
