"""Ops (port of ``udp_pose_tpu/ops``): flip, blur, the peak + offset
kernel, decode, box and affine geometry (host and device), the YOLO
pre/post-processing, training targets and the NMS family (host and
device)."""
