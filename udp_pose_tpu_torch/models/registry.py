"""Model registry (port of ``udp_pose_tpu/models/registry.py``).

Pose models by ``cfg.MODEL.NAME``: ``pose_hrnet``, ``pose_hrnet_psa``,
``pose_resnet``, ``pose_resnet_psa``, ``rsn`` and the nine mobile names
of :mod:`.pose_mobile` (any other name raises ``KeyError`` naming what
is registered), and the YOLOv5 detectors by name (``yolov5n``,
``yolov5s``, ``yolov5m``, ``yolov5l``).
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch
from torch import nn

from ..utils.platform import resolve_device
from . import pose_mobile
from .hrnet import pose_hrnet_from_cfg
from .resnet import pose_resnet_from_cfg
from .rsn import rsn_from_cfg
from .yolov5 import VARIANTS, YOLOv5

MODELS: Dict[str, Callable] = {}
DETECTORS: Dict[str, Callable] = {
    f"yolov5{v}": (lambda v=v: YOLOv5(v)) for v in VARIANTS}


def register_model(name: str):
    def deco(fn):
        MODELS[name] = fn
        return fn
    return deco


def init_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random init in the manner of flax's defaults, which the JAX
    package's smoke mode uses: conv, transposed-conv and linear kernels
    normal with variance 1/fan_in, fan_in = kh·kw·in as flax counts it for
    the convs (flax truncates its lecun_normal; this does not), their
    biases 0, BatchNorm, LayerNorm and GroupNorm scale 1 / bias 0, running
    mean 0 / running var 1.  Drawn on the CPU from one
    ``torch.Generator``, so a seed gives the same weights on every
    device."""
    gen = torch.Generator().manual_seed(int(seed))
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            # Conv2d (O, I, kh, kw); ConvTranspose2d (I, O, kh, kw);
            # Linear (O, I)
            fan_in = (m.weight[:, 0].numel()
                      if isinstance(m, nn.ConvTranspose2d)
                      else m.weight[0].numel())
            with torch.no_grad():
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                               / math.sqrt(fan_in))
                if m.bias is not None:
                    m.bias.zero_()
        elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm, nn.GroupNorm)):
            m.reset_parameters()
    return model


def build_model(cfg, device="cuda", seed: int = 0,
                train: bool = False) -> nn.Module:
    """Instantiate the configured architecture on ``device`` with seeded
    random weights (load real ones with ``load_state_dict``).  For
    serving (the default): in eval mode, cast to the config's compute
    dtype (``TPU.DTYPE``).  With ``train=True``: in train mode with fp32
    master weights; the trainer runs the compute dtype under autocast
    (:mod:`..core.train`)."""
    dev = resolve_device(device)
    name = cfg.MODEL.NAME
    if name not in MODELS:
        raise KeyError(
            f"unknown model {name!r}; available: {sorted(MODELS)}")
    return _place(init_weights(MODELS[name](cfg), seed), dev, train)


def build_detector(name="yolov5n", device="cuda", seed: int = 0) -> nn.Module:
    """The detector ``name`` (``yolov5n`` … ``yolov5l``, or the bare
    variant letter) on ``device``, in eval mode, with seeded random
    weights."""
    dev = resolve_device(device)
    key = name if name.startswith("yolov5") else f"yolov5{name}"
    if key not in DETECTORS:
        raise KeyError(
            f"unknown detector {name!r}; available: {sorted(DETECTORS)}")
    return _place(init_weights(DETECTORS[key](), seed), dev, False)


def _place(model, dev, train):
    if train:
        model = model.to(device=dev).train()
    else:
        model = model.to(device=dev, dtype=model.dtype).eval()
    if dev.type == "cuda":
        # the crops arrive NHWC, so the NCHW view of them is already
        # channels-last: keep the convs in that layout (cuDNN's fast path)
        model = model.to(memory_format=torch.channels_last)
    return model


@register_model("pose_resnet")
def _pose_resnet(cfg):
    return pose_resnet_from_cfg(cfg, psa=False)


@register_model("pose_resnet_psa")
def _pose_resnet_psa(cfg):
    return pose_resnet_from_cfg(cfg, psa=True)


@register_model("pose_hrnet")
def _pose_hrnet(cfg):
    return pose_hrnet_from_cfg(cfg, psa=False)


@register_model("pose_hrnet_psa")
def _pose_hrnet_psa(cfg):
    return pose_hrnet_from_cfg(cfg, psa=True)


@register_model("rsn")
def _rsn(cfg):
    return rsn_from_cfg(cfg)


for _name, _head in (("", "deconv"), ("_pixel_shuffle", "pixel_shuffle")):
    register_model(f"pose_shufflenetv2_plus{_name}")(
        lambda cfg, h=_head: pose_mobile.shufflenetv2_plus(cfg, h))
    register_model(f"pose_shufflenetv2_10x{_name}")(
        lambda cfg, h=_head: pose_mobile.shufflenetv2_10x(cfg, h))
    register_model(f"pose_mobilenetv3_small{_name}")(
        lambda cfg, h=_head: pose_mobile.mobilenetv3_small(cfg, h))
register_model("shufflenetv2_test")(pose_mobile.shufflenetv2_test)
register_model("pose_mobilevit_pixel_shuffle")(pose_mobile.mobilevit)
register_model("pose_mobilevitv2_pixel_shuffle")(pose_mobile.mobilevitv2)
del _name, _head
