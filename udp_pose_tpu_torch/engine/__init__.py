"""Serving engines (port of ``udp_pose_tpu/engine``): the top-down pose
pipeline, the detectors, the detect-then-pose engine and the HTTP daemon
with cross-request crop and frame batching."""
