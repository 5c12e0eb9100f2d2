"""Polarized Self-Attention in NCHW (port of ``udp_pose_tpu/models/psa.py``,
parity: deep_hrnet/lib/models/PSA.py).

``PSA_s`` (sequential, PSA.py:146-269) is the variant that pose_hrnet_psa
and pose_resnet_psa insert into their BasicBlocks; ``PSA_p`` (parallel,
:29-144) is kept as the JAX package keeps it.  Attribute names are the
reference's (``conv_q_right``, ``conv_v_right``, ``conv_up.{0,1,3}``,
``conv_q_left``, ``conv_v_left``).  The two softmax-pooled contractions
sum in float32 whatever the compute dtype, as the JAX einsums do with
``preferred_element_type=jnp.float32`` (and outside autocast, which
would run them in the compute dtype).
"""

from __future__ import annotations

import torch
from torch import nn


def _channel_context(x, conv_v, conv_q):
    """The channel branch's pooled context (PSA.py:191-219): the
    ``conv_v`` features averaged over the pixels under the softmax of
    ``conv_q``, summed in float32 → (B, inter, 1, 1) in ``x``'s dtype."""
    B, _, H, W = x.shape
    v = conv_v(x).reshape(B, -1, H * W)
    attn = torch.softmax(conv_q(x).reshape(B, 1, H * W), dim=2)
    with torch.autocast(x.device.type, enabled=False):
        ctx = torch.einsum("bcp,bop->bc", v.float(), attn.float())
    return ctx[:, :, None, None].to(x.dtype)


def _spatial_gate(x, conv_q, conv_v):
    """The spatial branch's pre-sigmoid map (PSA.py:221-251): the pixel
    mean of the ``conv_q`` features against the channel softmax of
    ``conv_v`` at each pixel, summed in float32 → (B, 1, H, W)."""
    B, _, H, W = x.shape
    avg = conv_q(x).mean(dim=(2, 3))
    theta = torch.softmax(conv_v(x).reshape(B, -1, H * W), dim=1)
    with torch.autocast(x.device.type, enabled=False):
        sp = torch.einsum("bc,bcp->bp", avg.float(), theta.float())
    return sp.reshape(B, 1, H, W).to(x.dtype)


class PSA_s(nn.Module):
    """Sequential polarized self-attention: channel gate, then spatial
    gate."""

    def __init__(self, planes: int, ratio: int = 4):
        super().__init__()
        inter = planes // 2
        self.conv_q_right = nn.Conv2d(planes, 1, 1, bias=False)
        self.conv_v_right = nn.Conv2d(planes, inter, 1, bias=False)
        # torch LayerNorm([C, 1, 1]), eps 1e-5 (PSA.py:164)
        self.conv_up = nn.Sequential(
            nn.Conv2d(inter, inter // ratio, 1),
            nn.LayerNorm([inter // ratio, 1, 1], eps=1e-5),
            nn.ReLU(inplace=True),
            nn.Conv2d(inter // ratio, planes, 1))
        self.conv_q_left = nn.Conv2d(planes, inter, 1, bias=False)
        self.conv_v_left = nn.Conv2d(planes, inter, 1, bias=False)

    def forward(self, x):
        ctx = self.conv_up(_channel_context(x, self.conv_v_right,
                                            self.conv_q_right))
        x = x * torch.sigmoid(ctx)
        return x * torch.sigmoid(_spatial_gate(x, self.conv_q_left,
                                               self.conv_v_left))


class PSA_p(nn.Module):
    """Parallel polarized self-attention: channel and spatial gates
    applied to the same input and summed."""

    def __init__(self, planes: int):
        super().__init__()
        inter = planes // 2
        self.conv_q_right = nn.Conv2d(planes, 1, 1, bias=False)
        self.conv_v_right = nn.Conv2d(planes, inter, 1, bias=False)
        self.conv_up = nn.Conv2d(inter, planes, 1, bias=False)
        self.conv_q_left = nn.Conv2d(planes, inter, 1, bias=False)
        self.conv_v_left = nn.Conv2d(planes, inter, 1, bias=False)

    def forward(self, x):
        ctx = self.conv_up(_channel_context(x, self.conv_v_right,
                                            self.conv_q_right))
        sp = _spatial_gate(x, self.conv_q_left, self.conv_v_left)
        return x * torch.sigmoid(ctx) + x * torch.sigmoid(sp)
