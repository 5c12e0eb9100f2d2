"""Core (port of ``udp_pose_tpu/core``): the serving graph, and the
losses, train step and validation of training."""
