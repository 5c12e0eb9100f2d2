"""Weights into the port: JAX-package variables, reference ``.pth`` and
ultralytics YOLOv5 state dicts.

The port's own copy of the reverse half of
``udp_pose_tpu/utils/torch_convert.py`` (``Converter(reverse=True)``, the
HRNet mapping ``_map_pose_hrnet`` and the YOLOv5 mapping ``_map_yolov5``):
it walks the JAX package's flax
variables — nested dicts of numpy arrays under ``params`` and
``batch_stats`` — and emits the reference torch state_dict, whose keys
are the port's module names.  Layout rules: flax conv kernel
(kh, kw, I, O) → torch (O, I, kh, kw); BatchNorm scale/bias → weight/bias,
batch_stats mean/var → running_mean/running_var.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch


def load_torch_state_dict(path) -> Dict[str, np.ndarray]:
    """A reference ``.pth`` (bare weights or a checkpoint dict) →
    {name: numpy array}, DataParallel ``module.`` prefixes stripped."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(blob, dict) and "state_dict" in blob:
        blob = blob["state_dict"]
    if isinstance(blob, dict) and "best_state_dict" in blob:
        blob = blob["best_state_dict"]
    out = {}
    for k, v in blob.items():
        if k.startswith("module."):
            k = k[len("module."):]
        out[k] = v.detach().cpu().numpy()
    return out


def conv_kernel_inv(k):
    """flax (kh, kw, I, O) → torch Conv2d (O, I, kh, kw)."""
    return np.ascontiguousarray(np.transpose(k, (3, 2, 0, 1)))


def _get(tree, path):
    node = tree
    for p in path:
        node = node[p]
    return np.asarray(node)


def _has(tree, path):
    node = tree
    for p in path:
        if not hasattr(node, "keys") or p not in node:
            return False
        node = node[p]
    return True


class Converter:
    """flax path → torch key emitter: walks a family mapping, reading the
    flax variables and writing a reference-format torch state_dict."""

    def __init__(self, variables):
        self.params = variables["params"]
        self.stats = variables.get("batch_stats", {})
        self.sd: Dict[str, np.ndarray] = {}

    def probe(self, tkey: str, *fpath) -> bool:
        """Does the flax tree hold the module at ``fpath``?"""
        return _has(self.params, fpath)

    def conv(self, tkey: str, *path):
        self.sd[tkey + ".weight"] = conv_kernel_inv(
            _get(self.params, (*path, "kernel")))
        if _has(self.params, (*path, "bias")):
            self.sd[tkey + ".bias"] = _get(self.params, (*path, "bias"))

    def bn(self, tkey: str, *path):
        self.sd[f"{tkey}.weight"] = _get(self.params, (*path, "scale"))
        self.sd[f"{tkey}.bias"] = _get(self.params, (*path, "bias"))
        self.sd[f"{tkey}.running_mean"] = _get(self.stats, (*path, "mean"))
        self.sd[f"{tkey}.running_var"] = _get(self.stats, (*path, "var"))
        self.sd[f"{tkey}.num_batches_tracked"] = np.array(0, np.int64)


def _convert_basic_block(cv, tprefix, fpath):
    cv.conv(f"{tprefix}.conv1", *fpath, "cb1", "conv")
    cv.bn(f"{tprefix}.bn1", *fpath, "cb1", "bn")
    cv.conv(f"{tprefix}.conv2", *fpath, "cb2", "conv")
    cv.bn(f"{tprefix}.bn2", *fpath, "cb2", "bn")
    if cv.probe(f"{tprefix}.downsample.0.weight", *fpath, "down"):
        cv.conv(f"{tprefix}.downsample.0", *fpath, "down", "conv")
        cv.bn(f"{tprefix}.downsample.1", *fpath, "down", "bn")


def _convert_bottleneck(cv, tprefix, fpath):
    for i in (1, 2, 3):
        cv.conv(f"{tprefix}.conv{i}", *fpath, f"cb{i}", "conv")
        cv.bn(f"{tprefix}.bn{i}", *fpath, f"cb{i}", "bn")
    if cv.probe(f"{tprefix}.downsample.0.weight", *fpath, "down"):
        cv.conv(f"{tprefix}.downsample.0", *fpath, "down", "conv")
        cv.bn(f"{tprefix}.downsample.1", *fpath, "down", "bn")


def _map_pose_hrnet(cv: Converter, stages_cfg):
    """The reference pose_hrnet key layout (deep_hrnet/lib/models/
    pose_hrnet.py) against the JAX package's module names."""
    cv.conv("conv1", "stem1", "conv")
    cv.bn("bn1", "stem1", "bn")
    cv.conv("conv2", "stem2", "conv")
    cv.bn("bn2", "stem2", "bn")
    for bi in range(4):
        _convert_bottleneck(cv, f"layer1.{bi}", (f"layer1_{bi}",))

    for si, (num_modules, nb, block, num_blocks, _) in enumerate(stages_cfg):
        t = si + 1  # transition index
        for i in range(nb):
            if cv.probe(f"transition{t}.{i}.0.weight", f"transition{t}_{i}"):
                # single Sequential(Conv, BN, ReLU): channel-change branch
                cv.conv(f"transition{t}.{i}.0", f"transition{t}_{i}", "conv")
                cv.bn(f"transition{t}.{i}.1", f"transition{t}_{i}", "bn")
            else:
                j = 0
                while cv.probe(f"transition{t}.{i}.{j}.0.weight",
                               f"transition{t}_{i}_{j}"):
                    cv.conv(f"transition{t}.{i}.{j}.0",
                            f"transition{t}_{i}_{j}", "conv")
                    cv.bn(f"transition{t}.{i}.{j}.1",
                          f"transition{t}_{i}_{j}", "bn")
                    j += 1
        convert_block = (_convert_basic_block if block == "BASIC"
                         else _convert_bottleneck)
        for mi in range(num_modules):
            tmod = f"stage{si + 2}.{mi}"
            fmod = f"stage{si + 2}_{mi}"
            for br in range(nb):
                for bi in range(num_blocks[br]):
                    convert_block(cv, f"{tmod}.branches.{br}.{bi}",
                                  (fmod, f"branch{br}_{bi}"))
            for i in range(nb):
                for j in range(nb):
                    base = f"{tmod}.fuse_layers.{i}.{j}"
                    if j > i and cv.probe(f"{base}.0.weight",
                                          fmod, f"fuse{i}_{j}"):
                        cv.conv(f"{base}.0", fmod, f"fuse{i}_{j}")
                        cv.bn(f"{base}.1", fmod, f"fuse{i}_{j}_bn")
                    elif j == i and cv.probe(f"{base}.0.weight",
                                             fmod, f"fuse{i}_{j}"):
                        # last-module widening 1x1 (no BN)
                        cv.conv(f"{base}.0", fmod, f"fuse{i}_{j}")
                    elif j < i:
                        k = 0
                        while cv.probe(f"{base}.{k}.0.weight",
                                       fmod, f"fuse{i}_{j}_{k}"):
                            cv.conv(f"{base}.{k}.0", fmod, f"fuse{i}_{j}_{k}")
                            cv.bn(f"{base}.{k}.1", fmod,
                                  f"fuse{i}_{j}_{k}_bn")
                            k += 1
    cv.conv("final_layer", "final_layer")


def variables_to_state_dict(variables, cfg) -> Dict[str, np.ndarray]:
    """JAX-package variables of ``cfg``'s model → the port's state_dict
    (numpy values; ``model.load_state_dict(strict=True)`` accepts it)."""
    from ..models.hrnet import stages_from_cfg
    if cfg.MODEL.NAME != "pose_hrnet":
        raise KeyError(f"no weight mapping for model {cfg.MODEL.NAME!r}; "
                       "ported: ['pose_hrnet']")
    cv = Converter(variables)
    _map_pose_hrnet(cv, stages_from_cfg(cfg))
    return cv.sd


# ultralytics yolov5 v6.0 module indices → the JAX package's layer names
_YOLO_LAYERS = [
    ("0", "b0", "conv"), ("1", "b1", "conv"), ("2", "b2", "c3"),
    ("3", "b3", "conv"), ("4", "b4", "c3"), ("5", "b5", "conv"),
    ("6", "b6", "c3"), ("7", "b7", "conv"), ("8", "b8", "c3"),
    ("9", "b9", "sppf"), ("10", "h10", "conv"), ("13", "h13", "c3"),
    ("14", "h14", "conv"), ("17", "h17", "c3"), ("18", "h18", "conv"),
    ("20", "h20", "c3"), ("21", "h21", "conv"), ("23", "h23", "c3"),
]


def _map_yolov5(cv: Converter, prefix="model."):
    def conv_unit(tp, *path):
        cv.conv(f"{tp}.conv", *path, "conv")
        cv.bn(f"{tp}.bn", *path, "bn")

    for idx, name, kind in _YOLO_LAYERS:
        tp = prefix + idx
        if kind == "conv":
            conv_unit(tp, name)
        elif kind == "sppf":
            conv_unit(f"{tp}.cv1", name, "cv1")
            conv_unit(f"{tp}.cv2", name, "cv2")
        else:
            for cvname in ("cv1", "cv2", "cv3"):
                conv_unit(f"{tp}.{cvname}", name, cvname)
            j = 0
            while cv.probe(f"{tp}.m.{j}.cv1.conv.weight", name, f"m{j}"):
                conv_unit(f"{tp}.m.{j}.cv1", name, f"m{j}", "cv1")
                conv_unit(f"{tp}.m.{j}.cv2", name, f"m{j}", "cv2")
                j += 1
    for li in range(3):
        cv.conv(f"{prefix}24.m.{li}", f"detect{li}")


def yolov5_variables_to_state_dict(variables) -> Dict[str, np.ndarray]:
    """The JAX package's flax YOLOv5 variables (numpy) → the port's
    YOLOv5 state dict, which is the ultralytics v6.0 layout
    (``model.{i}...``)."""
    cv = Converter(variables)
    _map_yolov5(cv)
    return cv.sd


def ultralytics_state_dict(sd) -> Dict[str, np.ndarray]:
    """An ultralytics YOLOv5 state dict (``torch.save(model.state_dict())``
    of a ``yolov5*.pt`` model, whose keys carry one ``model.`` prefix, or
    two from an ``attempt_load`` wrapper) → the port's keys: exactly one
    ``model.`` prefix, the ``anchor*`` buffers dropped."""
    out = {}
    for k, v in sd.items():
        while k.startswith("model."):
            k = k[len("model."):]
        if "anchor" in k:
            continue
        out["model." + k] = v if torch.is_tensor(v) else np.asarray(v)
    return out


def load_yolov5_weights(weights) -> Dict[str, object]:
    """YOLOv5 weights in any of the forms the engines take → the port's
    state dict: the JAX package's variables (a dict with ``params``), a
    state dict (the port's or ultralytics'), or a ``.pt`` / ``.pth`` path
    to a saved ultralytics state dict."""
    if isinstance(weights, (str, os.PathLike)):
        if not str(weights).endswith((".pt", ".pth")):
            raise ValueError(f"detector weights {weights!r}: a .pt or .pth "
                             "file holding a state dict")
        weights = torch.load(weights, map_location="cpu", weights_only=True)
    if "params" in weights:
        return yolov5_variables_to_state_dict(weights)
    return ultralytics_state_dict(weights)


def state_dict_to_torch(sd) -> Dict[str, torch.Tensor]:
    """{name: numpy array | tensor} → {name: tensor} for load_state_dict."""
    return {k: v if torch.is_tensor(v) else torch.from_numpy(np.array(v))
            for k, v in sd.items()}
