"""Serving engines (port of ``udp_pose_tpu/engine``): the top-down pose
pipeline and the HTTP daemon with cross-request crop batching."""
