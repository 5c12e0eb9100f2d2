"""int8 post-training quantisation (w8a8) serving and quantisation-aware
training.

Port of ``udp_pose_tpu/models/quantize.py``, whose scheme (:11-17 there)
it keeps: weights symmetric per output channel, activations symmetric
per tensor with an amax calibrated on representative batches, int32
accumulation, the dequant ``acc · (s_a · s_w) + bias`` as an epilogue;
BatchNorm, residual adds and the decode stay in float.

Sites are named by the JAX package's flax module paths
(``stage2_0/branch0_0/cb1/conv``, ``detect0``; the map is
:func:`..utils.convert.conv_sites`), so a calibration table written by
either package serves the other, and ``DEFAULT_SKIP`` matches the same
convs.

Where the JAX package intercepts ``nn.Conv`` calls, the port copies the
model's module tree, sharing every parameter and buffer with the
original, and puts an :class:`Int8Conv2d` (serving) or a
:class:`FakeQuantConv2d` (QAT) in place of each eligible conv; every
other module of the copy is the original's code on the original's
tensors.  The int8 conv itself is :func:`..ops.int8_conv.int8_conv2d`:
on the card one launch of the hand-written implicit-GEMM kernel that
quantises on load, multiplies on the s8 tensor cores and applies the
dequant epilogue in registers.  A depthwise conv (groups = Cin = Cout,
the mobile nets' and RSN's PRM) serves as an
:class:`Int8DepthwiseConv2d` through :func:`..ops.int8_dwconv.int8_dwconv`,
the hand-written depthwise kernel; QAT fake-quantises grouped convs in
plain torch, as the JAX package does.
"""

from __future__ import annotations

import copy
import fnmatch
import itertools
import json
import threading
from typing import Dict, Iterable, Mapping, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..ops.int8_conv import (gemm_pad, int8_conv2d, k_tile_pad,
                              pack_wgmma_weight, wgmma_geometry,
                              wgmma_n_tile)
from ..ops.int8_dwconv import int8_dwconv, pack_weights
from ..utils.convert import conv_sites

# the output heads stay in float (quantize.py:36-44 there): the pose
# nets' final layer, the YOLOv5 detect heads, the attention and RSN heads
DEFAULT_SKIP = ("final_layer", "*final*", "*attn*", "*deattn*", "detect*",
                "*res_conv2*")


def _matches(path: str, patterns: Iterable[str]) -> bool:
    return any(fnmatch.fnmatch(path, pat) or path.endswith(pat)
               for pat in patterns)


# --------------------------------------------------------------------------
# Calibration
# --------------------------------------------------------------------------

def collect_conv_amax(model, x, skip: Sequence[str] = (),
                      sites: Mapping[str, str] = None) -> Dict[str, float]:
    """One forward pass of ``model`` on ``x`` recording each conv site's
    input amax: ``{flax path: max |x| in float32}`` for every site that no
    ``skip`` pattern matches.  Forward pre-hooks keep each amax on the
    device; the batch's values reach the host in one copy."""
    sites = conv_sites(model) if sites is None else sites
    mods = dict(model.named_modules())
    paths, vals, handles = [], [], []
    for name, path in sites.items():
        if _matches(path, skip):
            continue

        def hook(mod, args, path=path):
            paths.append(path)
            vals.append(args[0].detach().float().abs().amax())

        handles.append(mods[name].register_forward_pre_hook(hook))
    try:
        with torch.inference_mode():
            model(x)
    finally:
        for h in handles:
            h.remove()
    got: Dict[str, float] = {}
    if vals:
        for path, v in zip(paths, torch.stack(vals).cpu().tolist()):
            got[path] = max(got.get(path, 0.0), v)
    return got


def calibrate(model, batches: Iterable, *,
              skip: Sequence[str] = DEFAULT_SKIP) -> Dict[str, float]:
    """Run ``batches`` (the model's inputs, NCHW) through ``model`` and
    return the running per-site input amax: the activation calibration
    table of :class:`QuantizedModel`."""
    cal = Calibrator(1)
    sites = conv_sites(model)
    for x in batches:
        cal.update(collect_conv_amax(model, x, skip, sites))
    return cal.table()


def save_act_scales(path: str, amax: Mapping[str, float]) -> None:
    with open(path, "w") as f:
        json.dump(dict(amax), f, indent=1, sort_keys=True)


def load_act_scales(path: str) -> Dict[str, float]:
    with open(path) as f:
        return {str(k): float(v) for k, v in json.load(f).items()}


def load_act_scales_maybe(act_scales):
    """str path → loaded table; dict/None pass through unchanged."""
    if isinstance(act_scales, str):
        return load_act_scales(act_scales)
    return act_scales


class Calibrator:
    """Running per-site input-amax accumulator with a freeze threshold:
    folds collected batches with max(), counts them, and freezes into a
    table after ``calib_batches``."""

    def __init__(self, calib_batches):
        self.batches = max(1, int(calib_batches))
        self.amax: Dict[str, float] = {}
        self.seen = 0

    def update(self, got: Mapping[str, float]) -> bool:
        """Fold one collected batch; True once the table should freeze."""
        for k, v in got.items():
            self.amax[k] = max(self.amax.get(k, 0.0), float(v))
        self.seen += 1
        return self.seen >= self.batches

    def table(self) -> Dict[str, float]:
        return dict(self.amax)


class SelfCalibrating:
    """A float model that serves int8 once it has a calibration table:
    the one state machine behind every self-calibrating engine
    (``UdpPosePipeline``, ``build_yolo_detector``, ``FusedDetectPose``'s
    detector).

    The JAX package's gating: an explicit ``quantize`` wins (""/None is
    float), else a ``table`` (dict or json path) asks for int8, else
    ``default``.  Without a table, :meth:`record` folds each batch's
    per-site input amax (every site, heads included) until
    ``calib_batches`` batches freeze it; :meth:`active` then builds the
    :class:`QuantizedModel` once."""

    def __init__(self, model, quantize=None, table=None, calib_batches=2,
                 default=None):
        self.model = model
        self.table = load_act_scales_maybe(table)
        if quantize is None:
            quantize = "int8" if self.table is not None else default
        if quantize not in (None, "", "int8"):
            raise ValueError(f"unknown quantize mode {quantize!r}")
        self.quantize = quantize or None
        self.calib = Calibrator(calib_batches)
        self.qmodel = None
        self._sites = conv_sites(model)
        self._lock = threading.Lock()

    @property
    def calibrating(self):
        """int8 was asked for and the table is still being recorded."""
        return self.quantize == "int8" and self.table is None

    def record(self, x):
        """Fold the amax of ``x`` (the model's input) into the table."""
        got = collect_conv_amax(self.model, x, sites=self._sites)
        if self.calib.update(got):
            self.table = self.calib.table()

    def active(self):
        """The model to serve with now."""
        if self.quantize is None or self.table is None:
            return self.model
        with self._lock:
            if self.qmodel is None:
                self.qmodel = QuantizedModel(self.model, self.table)
        return self.qmodel

    def save(self, path):
        """Persist the table (json) for later runs."""
        from ..engine.errors import EngineStateError
        if self.table is None:
            raise EngineStateError("the int8 model is not calibrated yet")
        save_act_scales(path, self.table)


# --------------------------------------------------------------------------
# Quantised apply
# --------------------------------------------------------------------------

def _scale_of(amax):
    """``max(amax / 127, 1e-12)`` in float32 with a true division.  (CUDA
    divides by a Python number as a multiply by its reciprocal, one ulp
    off for some values; a divisor tensor on the device is divided by.)"""
    return torch.clamp(amax / torch.full((), 127.0, device=amax.device),
                       min=1e-12)


def quantize_kernel(weight):
    """Symmetric per-output-channel int8 weight quantisation: a torch conv
    weight (O, I/g, kh, kw) → (int8 weight of that shape, (O,) float32
    scale), bit for bit the JAX package's on the HWIO kernel, on either
    device."""
    k = weight.detach().float()
    s_w = _scale_of(k.abs().amax(dim=(1, 2, 3)))
    w_i8 = torch.clamp(torch.round(k / s_w[:, None, None, None]), -127, 127)
    return w_i8.to(torch.int8), s_w


def act_scale(amax) -> float:
    """The activation scale of a calibrated amax, a Python double as the
    JAX package computes it."""
    return max(float(amax), 1e-12) / 127.0


def is_depthwise(conv) -> bool:
    """groups = Cin = Cout > 1: the grouped convs the zoo has."""
    return (conv.groups > 1 and conv.groups == conv.in_channels
            == conv.out_channels)


def _check_plain(conv):
    if conv.groups != 1 and not is_depthwise(conv):
        raise NotImplementedError("grouped int8 convs other than depthwise "
                                  "(groups = Cin = Cout) are not ported yet")
    if (conv.dilation != (1, 1) or conv.padding_mode != "zeros"
            or isinstance(conv.padding, str)):
        raise NotImplementedError("int8 convs with dilation, non-zero "
                                  "padding modes or string padding are "
                                  "not ported yet")


class _Int8Site(nn.Module):
    """What both int8 conv modules keep of ``conv``, prepared once: its
    geometry, the activation's ``s_a`` and ``1/s_a`` as a float32 value,
    the epilogue scale ``f32(s_a) · s_w`` and the float32 bias (buffers),
    and the card's launch arguments per input layout (``launch_plans``).
    :meth:`_prepare` returns the int8 weight for the subclass to lay out.
    The forward takes no host sync."""

    def _prepare(self, conv: nn.Conv2d, amax: float):
        _check_plain(conv)
        self.kernel_size, self.stride = conv.kernel_size, conv.stride
        self.padding = conv.padding
        self.in_channels, self.out_channels = (conv.in_channels,
                                               conv.out_channels)
        self.s_a = act_scale(amax)
        # x_f * (1.0 / s_a): the float32 rounding of the double 1/s_a
        self.inv_s_a = float(np.float32(1.0 / self.s_a))
        w_i8, s_w = quantize_kernel(conv.weight)
        self.register_buffer(
            "scale", s_w * torch.tensor(np.float32(self.s_a)),
            persistent=False)
        self.register_buffer(
            "bias", None if conv.bias is None else conv.bias.detach().float(),
            persistent=False)
        self.launch_plans = {}
        return w_i8


class Int8Conv2d(_Int8Site):
    """The w8a8 replacement of one ``nn.Conv2d`` (``_quantized_conv``):
    the int8 weight in the GEMM layout (N_pad, K_pad) with K in (kh, kw,
    cin) order and zero columns up to the fused kernel's K tile
    (``w_gemm``: the plain version's and the older kernel's), and, for a
    conv of the Hopper engine's geometry, packed once into the order that
    engine reads it (``w_packed``, see
    :func:`..ops.int8_conv.pack_wgmma_weight`; None otherwise), run by
    :func:`..ops.int8_conv.int8_conv2d`."""

    def __init__(self, conv: nn.Conv2d, amax: float):
        super().__init__()
        w_i8 = self._prepare(conv, amax)
        O = self.out_channels
        K = w_i8[0].numel()
        self.k_pad = k_tile_pad(K)
        w = torch.zeros((gemm_pad(O), self.k_pad), dtype=torch.int8,
                        device=w_i8.device)
        w[:O, :K] = w_i8.permute(0, 2, 3, 1).reshape(O, K)
        self.register_buffer("w_gemm", w, persistent=False)
        self.register_buffer("w_packed", pack_wgmma_weight(
            w, self.in_channels, self.kernel_size, wgmma_n_tile(O))
            if wgmma_geometry(self.kernel_size, self.stride, self.padding)
            else None, persistent=False)

    def forward(self, x):
        return int8_conv2d(x, self)


class Int8DepthwiseConv2d(_Int8Site):
    """The w8a8 replacement of one depthwise ``nn.Conv2d`` (groups = C),
    run by :func:`..ops.int8_dwconv.int8_dwconv`: the int8 weight as
    (kh·kw, C), tap-major with the channels contiguous (``w_taps``: the
    plain version's, the previous design's and the calibration tables'), and
    packed once into the kernel's words (``w_packed``, see
    :func:`..ops.int8_dwconv.pack_weights`)."""

    def __init__(self, conv: nn.Conv2d, amax: float):
        super().__init__()
        w_i8 = self._prepare(conv, amax)
        self.register_buffer("w_taps", w_i8.reshape(
            self.in_channels, -1).t().contiguous(), persistent=False)
        self.register_buffer("w_packed", pack_weights(
            self.w_taps, self.kernel_size[0]), persistent=False)

    def forward(self, x):
        return int8_dwconv(x, self)


def int8_conv_for(conv: nn.Conv2d, amax: float) -> nn.Module:
    """The int8 serving module of ``conv``: :class:`Int8DepthwiseConv2d`
    for a depthwise conv, :class:`Int8Conv2d` otherwise."""
    if is_depthwise(conv):
        return Int8DepthwiseConv2d(conv, amax)
    return Int8Conv2d(conv, amax)


def _ste(real, quantized):
    """Straight-through estimator: forward the quantised value, pass the
    gradient through as the identity (``real + stop_gradient(q - real)``,
    the JAX package's expression order)."""
    return real + (quantized - real).detach()


def _out_dtype(x):
    dev = x.device.type
    if torch.is_autocast_enabled(dev):
        return torch.get_autocast_dtype(dev)
    return x.dtype


class FakeQuantConv2d(nn.Module):
    """The fake-quantised (QAT) replacement of one ``nn.Conv2d``
    (``_fake_quant_conv``): inputs snap to the per-tensor int8 grid,
    weights to the per-output-channel grid, the conv runs in float32 so
    that gradients flow through the STE.  ``amax`` None takes each
    batch's own amax (training); a float freezes the deployment grid.
    The conv's parameters are the original's.  ``amax_group``, set by
    :func:`..parallel.data_parallel`: the batch's amax is the maximum
    over that process group's ranks (a global batch's, as the JAX
    package's sharded step takes it); None keeps this process's."""

    def __init__(self, conv: nn.Conv2d, amax=None):
        super().__init__()
        self.conv = conv
        self.amax = amax
        self.amax_group = None

    def forward(self, x):
        conv = self.conv
        k = conv.weight.float()
        s_w = _scale_of(k.detach().abs().amax(dim=(1, 2, 3)))[
            :, None, None, None]
        k_q = _ste(k, torch.clamp(torch.round(k / s_w), -127, 127) * s_w)
        x_f = x.float()
        if self.amax is None:
            amax = x_f.detach().abs().amax()
            if self.amax_group is not None:
                dist.all_reduce(amax, dist.ReduceOp.MAX,
                                group=self.amax_group)
            s_a = _scale_of(amax)
        else:
            s_a = torch.tensor(np.float32(act_scale(self.amax)),
                               device=x.device)
        x_q = _ste(x_f, torch.clamp(torch.round(x_f / s_a), -127, 127) * s_a)
        with torch.autocast(x.device.type, enabled=False):
            y = F.conv2d(x_q, k_q, None, conv.stride, conv.padding,
                         conv.dilation, conv.groups)
            if conv.bias is not None:
                y = y + conv.bias.float()[:, None, None]
        return y.to(_out_dtype(x))


def _shared_copy(model):
    """A copy of ``model``'s module tree whose parameters and buffers are
    the original's tensors."""
    memo = {id(t): t for t in itertools.chain(model.parameters(),
                                              model.buffers())}
    return copy.deepcopy(model, memo)


def _replace(root, name, module):
    parent, _, attr = name.rpartition(".")
    setattr(root.get_submodule(parent) if parent else root, attr, module)


class _SiteWrapper(nn.Module):
    """A shared copy of ``model`` with ``make(conv, path)`` in place of
    each conv site that ``wanted(path, conv)`` accepts; ``engaged`` holds
    their flax paths."""

    def __init__(self, model, wanted, make):
        super().__init__()
        self.dtype = getattr(model, "dtype", torch.float32)
        self.engaged = set()
        self.net = _shared_copy(model)
        for name, path in conv_sites(model).items():
            conv = self.net.get_submodule(name)
            if wanted(path, conv):
                _replace(self.net, name, make(conv, path))
                self.engaged.add(path)

    def forward(self, *args, **kwargs):
        return self.net(*args, **kwargs)


class QuantizedModel(_SiteWrapper):
    """``model`` with every calibrated conv in int8: a site present in
    ``act_scales``, matched by no ``skip`` pattern and with at least
    ``min_in_channels`` input channels runs as an :class:`Int8Conv2d`
    (an :class:`Int8DepthwiseConv2d` where it is depthwise);
    everything else is the original module on the original tensors."""

    def __init__(self, model, act_scales: Mapping[str, float],
                 skip: Sequence[str] = DEFAULT_SKIP,
                 min_in_channels: int = 0):
        self.act_scales = dict(act_scales)
        self.skip = tuple(skip)
        # 0 quantises every calibrated site (the JAX package's default)
        self.min_in_channels = int(min_in_channels)
        super().__init__(
            model,
            lambda path, conv: (path in self.act_scales
                                and not _matches(path, self.skip)
                                and conv.in_channels >= self.min_in_channels),
            lambda conv, path: int8_conv_for(conv, self.act_scales[path]))


class FakeQuantModel(_SiteWrapper):
    """QAT adapter: every eligible conv runs fake-quantised (STE) as a
    :class:`FakeQuantConv2d` over the original parameters, so an optimizer
    over ``model.parameters()`` trains through the int8 grid.

    ``act_scales``: None → each batch's dynamic activation amax (the
    standard QAT recipe); a calibration table → the frozen deployment
    grid, and only its sites are fake-quantised."""

    def __init__(self, model, act_scales: Mapping[str, float] = None,
                 skip: Sequence[str] = DEFAULT_SKIP,
                 min_in_channels: int = 0):
        self.act_scales = None if act_scales is None else dict(act_scales)
        self.skip = tuple(skip)
        self.min_in_channels = int(min_in_channels)
        super().__init__(
            model,
            lambda path, conv: (not _matches(path, self.skip)
                                and (self.act_scales is None
                                     or path in self.act_scales)
                                and conv.in_channels >= self.min_in_channels),
            lambda conv, path: FakeQuantConv2d(
                conv, None if self.act_scales is None
                else self.act_scales[path]))


def quantize_for_eval(cfg, model, dataset):
    """``TPU.QUANTIZE int8`` for the eval CLI: amax-calibrate on the first
    ``TPU.QUANTIZE_CALIB_BATCHES`` val batches, normalised
    (:func:`..core.infer.serving_normalizer`) and cast to the compute
    dtype exactly as serving feeds the stem, then serve w8a8.
    Returns the :class:`QuantizedModel`, or ``model`` unless the cfg asks
    for int8."""
    if cfg.TPU.QUANTIZE != "int8":
        return model
    from ..core.infer import (cast_to_compute_dtype, normalize_images,
                              serving_normalizer)
    from ..data.base import epoch_loader

    device = next(model.parameters()).device
    mean, std = serving_normalizer(cfg)
    n_calib = max(1, cfg.TPU.QUANTIZE_CALIB_BATCHES)
    batches = (
        cast_to_compute_dtype(model, normalize_images(
            torch.as_tensor(b["image"], device=device), mean, std)
        ).permute(0, 3, 1, 2)
        for b in itertools.islice(
            epoch_loader(dataset, cfg.TEST.BATCH_SIZE_PER_GPU,
                         shuffle=False, drop_last=False), n_calib))
    return QuantizedModel(model, calibrate(model, batches))
