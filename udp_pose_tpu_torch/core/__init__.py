"""Inference core (port of ``udp_pose_tpu/core``): the serving graph."""
