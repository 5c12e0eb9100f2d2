"""Checkpoints and weight files of the trainer (port of
``udp_pose_tpu/utils/checkpoint.py``; parity: deep_hrnet/lib/utils/
utils.py:79-110 and the AUTO_RESUME flow of tools/train.py:169-223, RSN's
iteration checkpoints, engine.py:162-169).

Files, in the reference's roles: ``checkpoint.pth`` (rolling: the model's
state dict in the reference keys, the optimizer's and the scheduler's
state dicts, ``step``, ``epoch``, ``perf`` and ``step_in_epoch``),
``iter-<N>.pth`` with the ``iter-last.pth`` link (RSN's iteration mode),
and the weight files ``model_best.pth`` and ``final_state.pth`` (the
state dict alone).  In a data-parallel run rank 0 alone writes them,
and every rank waits at a barrier before it reads one.  A QAT run's
files hold the inner model's keys: the functions take that model beside
the train state, whose ``model`` may be the fake-quant wrapper over it.  A checkpoint loads with
``map_location`` the run's device; the optimizer's step counts go back
to the host, where a fresh Adam keeps them.

Weights from elsewhere: :func:`load_pretrained` (``MODEL.PRETRAINED``)
grafts a partial or backbone-only ``.pth`` onto the fresh model as the
reference's ``init_weights`` does, and a ``.msgpack`` of the JAX
package's variables through :func:`load_weights_tolerant`.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from ..parallel.multihost import barrier, is_writer

logger = logging.getLogger(__name__)

CHECKPOINT = "checkpoint.pth"
ITER_LAST = "iter-last.pth"


def model_state(model):
    """``model``'s state dict as contiguous CPU tensors in the reference
    key names."""
    return {k: v.detach().cpu().contiguous()
            for k, v in model.state_dict().items()}


def save_weights(path, model):
    """The weight file (``model_best.pth``, ``final_state.pth``): the
    state dict of ``model`` alone (written by rank 0)."""
    if is_writer():
        torch.save(model_state(model), path)


def train_payload(model, state, weights=None):
    """What a checkpoint holds of a run: the state dict of ``model`` (or
    ``weights``, a copy of it), the optimizer's and the scheduler's state
    dicts and the step."""
    return {"state_dict": model_state(model) if weights is None else weights,
            "optimizer": state.optimizer.state_dict(),
            "scheduler": state.scheduler.state_dict(),
            "step": int(state.step)}


def restore_train_state(payload, model, state):
    """Load a :func:`train_payload` into ``model`` (``strict=True``) and
    ``state``.  Adam keeps its step counts on the host unless it is
    capturable or fused: those a ``map_location`` moved go back."""
    model.load_state_dict(payload["state_dict"], strict=True)
    opt = payload["optimizer"]
    on_device = any(g.get("capturable") or g.get("fused")
                    for g in opt["param_groups"])
    if not on_device:
        for s in opt["state"].values():
            if torch.is_tensor(s.get("step")):
                s["step"] = s["step"].cpu()
    state.optimizer.load_state_dict(opt)
    state.scheduler.load_state_dict(payload["scheduler"])
    state.step = int(payload["step"])


def _load(path, device):
    # the trainer's own file (optimizer and scheduler objects pickled
    # beside the tensors), not outside input
    return torch.load(path, map_location=device, weights_only=False)


def save_checkpoint(output_dir, model, state, epoch, perf, is_best=False,
                    step_in_epoch=0):
    """Write ``checkpoint.pth`` (and with ``is_best`` ``model_best.pth``).
    ``step_in_epoch`` > 0 marks a mid-epoch (preemption) save: the state
    has taken that many batches of epoch ``epoch + 1``, and a resume
    replays that prefix (see :mod:`.preemption`).  Rank 0 writes."""
    if not is_writer():
        return
    os.makedirs(output_dir, exist_ok=True)
    torch.save({**train_payload(model, state), "epoch": int(epoch),
                "perf": float(perf), "step_in_epoch": int(step_in_epoch)},
               os.path.join(output_dir, CHECKPOINT))
    if is_best:
        save_weights(os.path.join(output_dir, "model_best.pth"), model)


def load_checkpoint(output_dir, model, state, device):
    """Restore ``model`` and ``state`` from ``checkpoint.pth``; returns
    (begin_epoch = epoch + 1, best_perf, step_in_epoch), or (0, 0.0, 0)
    when there is no file."""
    barrier()
    path = os.path.join(output_dir, CHECKPOINT)
    if not os.path.exists(path):
        return 0, 0.0, 0
    payload = _load(path, device)
    restore_train_state(payload, model, state)
    return (int(payload["epoch"]) + 1, float(payload["perf"]),
            int(payload.get("step_in_epoch", 0)))


def save_iter_checkpoint(output_dir, model, state, iteration):
    """RSN's iteration checkpoint (engine.py:162-169), named as the JAX
    package names its ``.msgpack`` (``utils/checkpoint.py:50-70``):
    ``iter-<iteration>.pth`` holding :func:`train_payload` and the
    iteration, and ``iter-last.pth`` a link to it.  Returns the path;
    rank 0 writes."""
    name = f"iter-{int(iteration)}.pth"
    path = os.path.join(output_dir, name)
    if not is_writer():
        return path
    os.makedirs(output_dir, exist_ok=True)
    torch.save({**train_payload(model, state), "iteration": int(iteration)},
               path)
    link = os.path.join(output_dir, ITER_LAST)
    if os.path.lexists(link):
        os.unlink(link)
    os.symlink(name, link)
    return path


def load_iter_checkpoint(output_dir, model, state, device):
    """Restore ``model`` and ``state`` from ``iter-last.pth``; returns the
    iteration to go on from (the saved one + 1), or 0 when there is no
    file."""
    barrier()
    path = os.path.join(output_dir, ITER_LAST)
    if not os.path.exists(path):
        return 0
    payload = _load(path, device)
    restore_train_state(payload, model, state)
    return int(payload["iteration"]) + 1


def align_suffix_keys(model_flat: dict, loaded_flat: dict) -> dict:
    """Longest-suffix key alignment (RSN/cvpack/torch_modeling/engine/
    checkpoint.py:50-89): each model key takes the loaded key that is its
    longest suffix, so a ``module.`` nesting or a re-rooted backbone
    lines up.  Flat dicts; returns the loaded dict re-keyed."""
    out = dict(loaded_flat)
    loaded_keys = sorted(loaded_flat)
    for mk in sorted(model_flat):
        best, best_len = None, 0
        for lk in loaded_keys:
            if mk.endswith(lk) and len(lk) > best_len:
                best, best_len = lk, len(lk)
        if best is not None and best != mk:
            out[mk] = out.pop(best)
    return out


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _unflatten(flat):
    out = {}
    for k, v in flat.items():
        node = out
        parts = k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def load_weights_tolerant(path, model, cfg):
    """Load the JAX package's ``.msgpack`` variables at ``path`` into
    ``model`` as its tolerant ``load_weights_tolerant`` (the reference's
    ``load_model``, checkpoint.py:6-47): on the flat ``params/.../kernel``
    paths, each of the fresh model's leaves (its state dict through
    :func:`..utils.convert.state_dict_to_variables`) takes the file's
    leaf of the longest suffix (:func:`align_suffix_keys`) where the
    shapes match; every other leaf keeps the fresh value.  Returns the
    number of leaves loaded."""
    from .convert import (state_dict_to_torch, state_dict_to_variables,
                          variables_to_state_dict)
    from .msgpack import read_file
    fresh = _flatten(state_dict_to_variables(model.state_dict(), cfg))
    aligned = align_suffix_keys(fresh, _flatten(read_file(path)))
    kept = {k: aligned[k] for k, v in fresh.items()
            if k in aligned and np.shape(aligned[k]) == np.shape(v)}
    logger.info("tolerant load of %s: %d leaves loaded, %d kept fresh",
                path, len(kept), len(fresh) - len(kept))
    sd = variables_to_state_dict(_unflatten({**fresh, **kept}), cfg)
    sd = {k: v for k, v in sd.items()
          if not k.endswith("num_batches_tracked")}
    model.load_state_dict(state_dict_to_torch(sd), strict=False)
    return len(kept)


def _mobile_backbone_keys(sd, name):
    """A bare ImageNet backbone's keys under the pose wrapper's
    ``backbone.``; MobileNetV3's torchvision features, ``features.<i>``
    raw or ``0.<i>`` when wrapped in a Sequential, become the wrapper's
    ``backbone.0.<i>`` and the classifier drops."""
    if "mobilenetv3" not in name:
        return {f"backbone.{k}": v for k, v in sd.items()}
    prefix = ("features." if any(k.startswith("features.") for k in sd)
              else "0.")
    return {f"backbone.0.{k[len(prefix):]}": v for k, v in sd.items()
            if k.startswith(prefix)}


def load_pretrained(model, pretrained, cfg):
    """``MODEL.PRETRAINED`` (the reference train CLI's
    ``model.init_weights(PRETRAINED)``, ``udp_pose_tpu/utils/
    torch_convert.py:909-1020``): graft a partial or backbone-only
    checkpoint onto ``model``'s fresh weights, ``strict=False``.

    * HRNet and SimpleBaseline: only the keys whose first name is in
      ``EXTRA.PRETRAINED_LAYERS`` (``'*'``: all); for HRNet none of
      ``stage4.2.fuse_layers`` (pose_hrnet.py:473-505).
    * The mobile nets: a bare ImageNet backbone goes under ``backbone.``
      (:func:`_mobile_backbone_keys`), a full pose checkpoint (keys under
      ``backbone.``) loads whole.
    * RSN: the whole file; its keys are the port's.

    Keys the model does not have, and BatchNorm's ``num_batches_tracked``
    (which the JAX package has not), are ignored; a leaf whose shape
    differs from the model's is skipped and logged.  ``pretrained``: a
    ``.pth`` path, an ``.onnx`` artifact of the exporter (its
    initializers, as a ``.pth``'s keys) or a state dict; a ``.msgpack`` of
    the JAX package's variables goes through :func:`load_weights_tolerant`.
    A missing file raises.  Returns the number of leaves grafted."""
    from .convert import (load_torch_state_dict, onnx_initializers,
                          state_dict_to_torch)
    if isinstance(pretrained, (str, os.PathLike)):
        if not os.path.isfile(pretrained):
            raise ValueError(f"{pretrained} does not exist "
                             "(pose_hrnet.py:503-505 semantics)")
        if str(pretrained).endswith(".msgpack"):
            return load_weights_tolerant(pretrained, model, cfg)
        sd = (onnx_initializers(pretrained)
              if str(pretrained).endswith(".onnx")
              else load_torch_state_dict(pretrained))
    else:
        sd = dict(pretrained)
    name = cfg.MODEL.NAME
    if name.startswith(("pose_hrnet", "pose_resnet")):
        layers = list(cfg.MODEL.EXTRA.get("PRETRAINED_LAYERS", ["*"]))
        if layers and layers[0] != "*":
            sd = {k: v for k, v in sd.items() if k.split(".")[0] in layers}
        if name.startswith("pose_hrnet"):
            # pose_hrnet.py:497: the pose net's widened last fuse
            sd = {k: v for k, v in sd.items()
                  if "stage4.2.fuse_layers" not in k}
    elif name.startswith(("pose_shufflenetv2", "pose_mobilenetv3",
                          "pose_mobilevit")):
        if not any(k.startswith("backbone.") for k in sd):
            sd = _mobile_backbone_keys(sd, name)
    elif name != "rsn":
        raise KeyError(f"no pretrained mapping for model {name!r}")
    fresh = model.state_dict()
    kept, skipped = {}, []
    for k, v in sd.items():
        if k not in fresh or k.endswith("num_batches_tracked"):
            continue
        if tuple(np.shape(v)) != tuple(fresh[k].shape):
            skipped.append(k)
            continue
        kept[k] = v
    if skipped:
        logger.warning("pretrained: skipped %d shape-mismatched leaves "
                       "(e.g. %s)", len(skipped), skipped[:3])
    model.load_state_dict(state_dict_to_torch(kept), strict=False)
    return len(kept)
