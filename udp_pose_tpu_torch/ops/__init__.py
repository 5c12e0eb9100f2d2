"""Ops (port of ``udp_pose_tpu/ops``): flip, blur, the peak + offset
kernel, decode, the host box/affine geometry, training targets and the
host NMS."""
