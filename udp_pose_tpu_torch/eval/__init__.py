"""Evaluation (port of ``udp_pose_tpu/eval``): native COCO OKS keypoint AP."""

from .cocoeval import COCO_KPT_SIGMAS, COCOKeypointEval

__all__ = ["COCOKeypointEval", "COCO_KPT_SIGMAS"]
