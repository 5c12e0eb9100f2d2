"""Flip-test alignment ops (port of ``udp_pose_tpu/ops/flip.py``).

The flipped forward's output is un-flipped with a width reverse and a
channel permute on the device (reference deep_hrnet/lib/utils/
transforms.py: ``flip_back`` :15-29, ``flip_back_offset`` :31-47).
Layout (B, C, H, W), as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch


def flip_pair_permutation(num_joints, flip_pairs):
    """Joint permutation that swaps left/right pairs; identity elsewhere."""
    perm = np.arange(num_joints)
    for a, b in flip_pairs:
        perm[a], perm[b] = perm[b], perm[a]
    return perm


def flip_back(output_flipped, flip_pairs):
    """Un-flip (B, J, H, W) heatmaps: width-reverse, swap paired joints."""
    J = output_flipped.shape[1]
    perm = torch.as_tensor(flip_pair_permutation(J, flip_pairs),
                           device=output_flipped.device)
    return output_flipped.flip(3)[:, perm]


def flip_back_offset(output_flipped, flip_pairs):
    """Un-flip interleaved (B, 3J, H, W) [hm, off_x, off_y] maps:
    width-reverse, negate the off_x channels (``1::3``), then swap the
    joint triplets of paired joints."""
    B, C, H, W = output_flipped.shape
    J = C // 3
    sign = torch.ones(C, dtype=output_flipped.dtype,
                      device=output_flipped.device)
    sign[1::3] = -1.0
    out = output_flipped.flip(3) * sign[None, :, None, None]
    perm = torch.as_tensor(flip_pair_permutation(J, flip_pairs),
                           device=output_flipped.device)
    return out.reshape(B, J, 3, H, W)[:, perm].reshape(B, C, H, W)
