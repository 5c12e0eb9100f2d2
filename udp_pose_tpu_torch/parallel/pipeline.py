"""GPipe pipeline parallelism for the multi-stage RSN (``TPU.PP``; port of
``udp_pose_tpu/parallel/pipeline.py``).

The JAX package places stage ``s`` of a multi-stage RSN on rank ``s`` of
its mesh's ``model`` axis, streams microbatches through a ``lax.scan``
schedule inside ``shard_map`` and shifts the inter-stage payload (the
64-channel ``cross`` feature and the two 4-level skip pyramids) one rank
forward a tick with ``lax.ppermute``; its backward is ``jax.grad``
through the scan.  Here one process drives its ``S`` model-axis devices,
as the single controller of ``shard_map`` does:

* the model is the plain :class:`..models.rsn.RSN`, its stem (``top``)
  and stage 0 on ``model_devices[0]`` and stage ``s`` on
  ``model_devices[s]`` (:func:`place_stages`), so every state dict,
  checkpoint and weight file keeps the standard RSN keys.  Stage 0 runs
  without skips and the last stage makes none, which is what the JAX
  package's uniform stages compute with zero skips in and the skips out
  discarded (``udp_pose_tpu/models/rsn.py:389-416``);
* a Python GPipe schedule runs ticks ``t = 0 … n_micro + S − 2``; stage
  ``s`` runs microbatch ``t − s`` where it exists (the bubble computes
  nothing, the JAX masking at ``:217-225``), and its payload goes to the
  next stage's device with ``Tensor.to``;
* the backward is autograd through those copies.  On several cards the
  asynchronous launches and autograd's thread a device overlap the
  stages; ``model_devices`` may repeat a device (one card, or the CPU),
  which runs the same schedule with no overlap.

Semantics of the JAX step, held: the stem runs once on the whole batch
before the microbatch split, its BatchNorm over the global batch
(:class:`.batchnorm.GlobalBatchNorm2d` over the data axis); each stage's
BatchNorm takes the statistics of one microbatch of one data rank, its
running stats updated microbatch after microbatch and averaged over the
data axis at the end of the step; the loss is ``rsn_multi_stage_loss``
over the global batch, the gradients averaged over the data axis.  At a
data axis D > 1 the microbatch split comes before the data split
(``in_specs P(None, "data")``): rank ``d``'s share of microbatch ``m`` is
the global rows ``m·mb + d·mb/D … m·mb + (d+1)·mb/D``, which the loader
hands it in that order (:func:`pipeline_rows`,
``data.base.epoch_batch_indices(n_micro=)``).

The weight bridge: :func:`merge_rsn_variables` unstacks the JAX
package's pipelined ``(stem, stacked stages)`` variables (numpy) into the
standard RSN tree, so a pipelined ``.msgpack`` loads into the port.
``torch.distributed.pipelining`` is not used: its schedules, losses and
microbatch rules are not the JAX package's.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

# leaves of the JAX uniform stage that the standard tree's last stage has
# not: its upsample units make no skips and no cross feature
_LAST_STAGE_ONLY = ("skip1", "skip2", "cross_conv")


# ---------------------------------------------------------------------------
# configuration and devices
# ---------------------------------------------------------------------------

def uses_pipeline(cfg) -> bool:
    """Whether ``cfg`` trains pipelined: ``TPU.PP`` on an RSN over a
    ``TPU.MESH.MODEL`` > 1 (``tools/train.py:181``; any other model
    trains the plain step there)."""
    return (bool(cfg.TPU.PP) and cfg.MODEL.NAME == "rsn"
            and cfg.TPU.MESH.MODEL > 1)


def stage_count(cfg) -> int:
    """``STAGE_NUM``, which the model axis must equal
    (``udp_pose_tpu/parallel/pipeline.py:142-147``)."""
    stage_num = int(cfg.MODEL.EXTRA.get("STAGE_NUM", 1))
    if cfg.TPU.MESH.MODEL != stage_num:
        raise ValueError(
            f"pipeline parallelism needs TPU.MESH.MODEL == STAGE_NUM "
            f"({cfg.TPU.MESH.MODEL} != {stage_num})")
    return stage_num


def model_devices_for(device, n: int):
    """The ``n`` devices one process drives on the model axis from its
    first, ``device``: ``cuda:i … cuda:i+n-1`` (the JAX ``make_mesh``
    row-major reshape, rank ``r`` on ``local_rank·n + s``), or the CPU
    ``n`` times.  Raises when the host has too few cards."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return [dev] * n
    first = torch.cuda.current_device() if dev.index is None else dev.index
    cards = torch.cuda.device_count()
    if first + n > cards:
        raise RuntimeError(
            f"the model axis needs cards cuda:{first}..cuda:{first + n - 1} "
            f"but this host has {cards} card(s); give run() model_devices= "
            "to put several stages on one card")
    return [torch.device("cuda", first + s) for s in range(n)]


def _resolved(devices):
    out = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        out.append(d)
    return out


def place_stages(model, model_devices):
    """Move ``model`` (an :class:`..models.rsn.RSN`) onto the model axis
    in place: ``top`` and stage 0 on ``model_devices[0]``, stage ``s`` on
    ``model_devices[s]``.  Parameters keep their identity (``Module.
    to``), so an optimizer built over them stays valid.  Returns
    ``model``."""
    devs = _resolved(model_devices)
    if len(devs) != model.stage_num:
        raise ValueError(
            f"pipeline parallelism needs one device a stage: "
            f"{len(devs)} model devices for STAGE_NUM {model.stage_num}")
    model.top.to(devs[0])
    for s in range(model.stage_num):
        getattr(model, f"stage{s}").to(devs[s])
    return model


def stage_modules(model):
    """[(module, stage index)]: the stem with stage 0's index, then each
    stage: the parts whose tensors live on each model device."""
    return [(model.top, 0)] + [(getattr(model, f"stage{s}"), s)
                               for s in range(model.stage_num)]


# ---------------------------------------------------------------------------
# the data axis
# ---------------------------------------------------------------------------

def pipeline_rows(batch: int, n_micro: int, index: int, count: int):
    """The rows of a global batch of ``batch`` that data rank ``index`` of
    ``count`` trains, in its order: for each microbatch ``m`` of
    ``mb = batch / n_micro`` rows, rows ``m·mb + index·mb/count`` to
    ``m·mb + (index+1)·mb/count`` (the JAX ``P(None, "data")`` split of
    the ``(n_micro, mb)`` reshape)."""
    if batch % (n_micro * count):
        raise ValueError(f"batch {batch} not divisible by "
                         f"n_micro*n_data={n_micro * count}")
    mb, q = batch // n_micro, batch // (n_micro * count)
    return np.concatenate([np.arange(m * mb + index * q,
                                     m * mb + (index + 1) * q)
                           for m in range(n_micro)])


class PipelineGroups:
    """The data-axis collectives of a pipelined run: one process group a
    model index ``s`` over every rank, each bound to the rank's device
    ``s`` (NCCL: one card a rank in each communicator).  Built by every
    rank in the same order."""

    def __init__(self, model_devices):
        devs = _resolved(model_devices)
        self.devices = devs
        self.size = dist.get_world_size()
        nccl = dist.get_backend() == "nccl"
        self.groups = []
        for d in devs:
            kw = {"device_id": d} if nccl else {}
            self.groups.append(dist.new_group(
                ranks=list(range(self.size)), **kw))

    def mean_(self, tensors, s):
        """Average ``tensors`` (all on device ``s``) over the data axis, in
        place: one all-reduce of their flat copy."""
        tensors = list(tensors)
        if not tensors:
            return
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, group=self.groups[s])
        flat /= self.size
        offset = 0
        for t in tensors:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view_as(t))
            offset += n

    def step_means(self, state, loss):
        """After a step's backward: every gradient and the stages' running
        stats averaged over the data axis; returns the loss averaged
        too (the global batch's)."""
        model = state.model
        for module, s in stage_modules(model):
            self.mean_([p.grad for p in module.parameters()
                        if p.grad is not None], s)
        for s in range(model.stage_num):
            self.mean_([b for n, b in getattr(model, f"stage{s}")
                        .named_buffers()
                        if n.endswith(("running_mean", "running_var"))], s)
        loss = loss.clone()
        self.mean_([loss], 0)
        return loss


def data_parallel_stages(model, groups: PipelineGroups):
    """Prepare a placed ``model`` for a data axis > 1: the stem's
    BatchNorms take the global batch's statistics over model index 0's
    group (the stages' keep their own), and every rank starts from rank
    0's tensors."""
    from .batchnorm import convert_batchnorm
    convert_batchnorm(model.top, groups.groups[0])
    for module, s in stage_modules(model):
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, 0, group=groups.groups[s])


# ---------------------------------------------------------------------------
# the pipeline itself
# ---------------------------------------------------------------------------

def make_pipeline_forward(cfg, model_devices, n_micro: int):
    """Build ``forward(model, x, train) -> outputs``: ``model`` an RSN
    placed by :func:`place_stages` over ``model_devices``, ``x`` the
    (B, 3, H, W) normalised images on ``model_devices[0]`` (this data
    rank's rows), ``outputs`` per stage the list of its four (B, J, h, w)
    heatmaps (coarse unit first) on that stage's device, rows in ``x``'s
    order: every microbatch through the stages on the GPipe schedule.
    In train mode the BatchNorms update as the module says; ``train``
    puts the model in that mode."""
    S = stage_count(cfg)
    devs = _resolved(model_devices)
    if len(devs) != S:
        raise ValueError(f"pipeline parallelism needs one device a stage: "
                         f"{len(devs)} model devices for STAGE_NUM {S}")
    w, h = cfg.MODEL.HEATMAP_SIZE
    hm = (int(h), int(w))
    n_micro = int(n_micro)

    def forward(model, x, train: bool):
        model.train(train)
        with record_function("pipeline/stem"):
            x0 = model.top(x)
        if tuple(x0.shape[-2:]) != hm:
            raise ValueError(
                f"pipeline assumes heatmap == input/4 (stem out "
                f"{tuple(x0.shape[-2:])} != output_shape {hm})")
        if x0.shape[0] % n_micro:
            raise ValueError(f"batch {x0.shape[0]} a rank not divisible by "
                             f"n_micro={n_micro}")
        micro = x0.split(x0.shape[0] // n_micro)
        outs = [[None] * n_micro for _ in range(S)]
        inbox = [None] * S
        for t in range(n_micro + S - 1):
            # last stage first: stage s+1 takes what stage s sent at the
            # tick before, then stage s sends this tick's
            for s in reversed(range(S)):
                m = t - s
                if not 0 <= m < n_micro:
                    continue
                args = (micro[m], None, None) if s == 0 else inbox[s]
                with record_function(f"pipeline/stage{s}"):
                    res, skip1, skip2, cross = getattr(
                        model, f"stage{s}")(*args)
                outs[s][m] = res
                if s + 1 < S:
                    nxt = devs[s + 1]
                    inbox[s + 1] = (cross.to(nxt),
                                    [k.to(nxt) for k in skip1],
                                    [k.to(nxt) for k in skip2])
        return [[torch.cat([outs[s][m][j] for m in range(n_micro)])
                 for j in range(4)] for s in range(S)]

    return forward


def make_pipelined_rsn_train_step(cfg, model_devices, n_micro: int,
                                  ohkm: bool = True, topk: int = 8,
                                  coarse_to_fine: bool = True, groups=None):
    """:func:`..core.rsn.make_rsn_train_step` with the pipelined forward:
    the same ``step(state, batch) -> metrics`` (``batch`` on
    ``model_devices[0]``, ``state.model`` placed by :func:`place_stages`),
    the same loss, every stage's outputs brought to ``model_devices[0]``
    for it.  With ``groups`` (:class:`PipelineGroups`, a data axis > 1)
    the gradients and the stages' running stats are averaged over the
    data axis after the backward, and the loss is the global batch's."""
    from ..core.rsn import make_rsn_train_step
    forward = make_pipeline_forward(cfg, model_devices, n_micro)
    return make_rsn_train_step(
        stage_count(cfg), ohkm=ohkm, topk=topk,
        coarse_to_fine=coarse_to_fine,
        forward=lambda model, x: forward(model, x, True),
        after_backward=None if groups is None else groups.step_means)


# ---------------------------------------------------------------------------
# variable layout: (stem, stacked stages) -> standard RSN tree, numpy
# ---------------------------------------------------------------------------

def _drop_last_stage_only(tree):
    """The uniform stage's ``up`` tree less the leaves a last stage has
    not (its units' ``skip1``, ``skip2`` and ``cross_conv``)."""
    if not isinstance(tree, Mapping):
        return tree
    return {k: _drop_last_stage_only(v) for k, v in tree.items()
            if k not in _LAST_STAGE_ONLY}


def _index(tree, i):
    if isinstance(tree, Mapping):
        return {k: _index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def merge_rsn_variables(stem, stacked):
    """(stem, stacked) → the standard RSN variables, as the JAX
    ``merge_rsn_variables``: stage ``i`` unstacked into ``stage{i}_down``
    / ``stage{i}_up``, the padded last stage's ``skip1``, ``skip2`` and
    ``cross_conv`` dropped."""
    out = {}
    for col, st in stacked.items():
        n = np.shape(next(_leaves(st)))[0]
        new = dict(stem.get(col, {}))
        for i in range(n):
            for part in ("down", "up"):
                if part not in st:
                    continue
                sub = _index(st[part], i)
                if part == "up" and i == n - 1:
                    sub = _drop_last_stage_only(sub)
                new[f"stage{i}_{part}"] = sub
        out[col] = new
    return out


def _leaves(tree):
    if isinstance(tree, Mapping):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def standard_rsn_variables(variables):
    """The JAX package's variables as the standard tree: a pipelined
    ``{"stem", "stages"}`` layout (``create_pipelined_rsn_state``) merged
    back; any other tree as it is."""
    params = variables.get("params", {})
    if not (isinstance(params, Mapping) and "stages" in params
            and "stem" in params):
        return variables
    cols = [c for c in variables if isinstance(variables[c], Mapping)
            and "stages" in variables[c]]
    stem = {c: variables[c]["stem"] for c in cols}
    stacked = {c: variables[c]["stages"] for c in cols}
    return merge_rsn_variables(stem, stacked)


__all__ = ["uses_pipeline", "stage_count", "model_devices_for",
           "place_stages", "stage_modules", "pipeline_rows",
           "PipelineGroups", "data_parallel_stages",
           "make_pipeline_forward", "make_pipelined_rsn_train_step",
           "merge_rsn_variables", "standard_rsn_variables"]
