"""Pose models and the detector (port of ``udp_pose_tpu/models``):
HRNet and YOLOv5 so far."""

from .registry import (DETECTORS, MODELS, build_detector, build_model,
                       init_weights, register_model)

__all__ = ["DETECTORS", "MODELS", "build_detector", "build_model",
           "init_weights", "register_model"]
