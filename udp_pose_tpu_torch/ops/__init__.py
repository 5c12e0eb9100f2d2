"""Decode-side ops (port of ``udp_pose_tpu/ops``): flip, blur, the peak +
offset kernel, decode, and the host box/affine geometry."""
