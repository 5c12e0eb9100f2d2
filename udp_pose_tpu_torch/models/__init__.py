"""Pose models (port of ``udp_pose_tpu/models``): HRNet so far."""

from .registry import MODELS, build_model, init_weights, register_model

__all__ = ["MODELS", "build_model", "init_weights", "register_model"]
