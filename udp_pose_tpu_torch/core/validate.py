"""Validate loop: batched flip-test inference + decode + dataset.evaluate.

Port of the single-process path of ``udp_pose_tpu/core/validate.py``
(parity: deep_hrnet/lib/core/function.py:114-274).  Each batch runs the
serving graph of :func:`.infer.make_infer_fn_from_cfg` (for RSN
:func:`.rsn.make_rsn_infer_fn_from_cfg`): forward, flip, un-flip,
average and the decode, whose UDP offset decode is one launch of the
fused CUDA kernel on the card.  The host gathers the small decoded
arrays and runs the OKS-NMS + AP evaluation.  The last batch is not
padded: the port compiles nothing per shape.
"""

from __future__ import annotations

import itertools
import logging
import time

import numpy as np
import torch

from ..data.base import epoch_loader
from .accuracy import pck_accuracy
from .infer import make_infer_fn_from_cfg

logger = logging.getLogger(__name__)


def validate(cfg, dataset, model, output_dir="", batch_size=None,
             infer_fn=None):
    """Returns (name_values, perf_indicator).

    ``model``: the serving model, as ``models.build_model`` gives it (eval
    mode, compute dtype); so for the same weights the preds are those
    ``engine.UdpPosePipeline`` returns for the same crops.  ``infer_fn``
    replaces the graph built from ``model`` and ``cfg``.  With
    ``DEBUG.DEBUG`` and an ``output_dir``, every ``PRINT_FREQ``-th batch
    that has targets writes the debug images of ``val_<batch>``
    (:func:`..utils.vis.save_debug_images`; the reference's
    function.py:219).
    """
    pairs = tuple(map(tuple, dataset.flip_pairs))
    if infer_fn is None and cfg.MODEL.NAME == "rsn":
        # RSN's flip test and decode (udp_pose_tpu/core/validate.py:43-53)
        from .rsn import make_rsn_infer_fn_from_cfg
        infer_fn = make_rsn_infer_fn_from_cfg(model, cfg, pairs)
    elif infer_fn is None:
        infer_fn = make_infer_fn_from_cfg(model, cfg, flip_pairs=pairs)
    batch_size = batch_size or cfg.TEST.BATCH_SIZE_PER_GPU

    n = len(dataset)
    J = cfg.MODEL.NUM_JOINTS
    all_preds = np.zeros((n, J, 3), np.float32)
    all_boxes = np.zeros((n, 6))
    image_paths = []
    idx = 0
    accs, t0 = [], time.perf_counter()
    # the rate after the first batch (cuDNN's autotune and first calls
    # left out), and how much of it building samples on the host takes
    warm_t0, warm_idx, build_s = None, 0, 0.0
    batches = iter(epoch_loader(dataset, batch_size, shuffle=False,
                                drop_last=False))

    for n_batch in itertools.count():
        t_build = time.perf_counter()
        batch = next(batches, None)
        if batch is None:
            break
        if warm_t0 is not None:
            build_s += time.perf_counter() - t_build
        bs = batch["image"].shape[0]
        preds, maxvals, hm = infer_fn(batch["image"], batch["center"],
                                      batch["scale"])
        if "target" in batch:          # RSN's val samples have none
            if cfg.MODEL.TARGET_TYPE == "offset":
                hm, tgt = hm[:, ::3], batch["target"][:, ::3]
            else:
                tgt = batch["target"]
            hm_np = hm.cpu().numpy()
            _, avg_acc, cnt, pred = pck_accuracy(hm_np, tgt)
            accs.append((avg_acc, cnt))
            if (cfg.DEBUG.DEBUG and n_batch % cfg.PRINT_FREQ == 0
                    and output_dir):
                # pred joints at the heatmap argmax x 4, in crop space
                from ..utils.vis import save_debug_images
                save_debug_images(
                    cfg, batch["image"], batch.get("joints"),
                    batch.get("joints_vis"), tgt, hm_np,
                    f"{output_dir}/val_{n_batch}", pred_joints=pred * 4)

        all_preds[idx:idx + bs, :, 0:2] = preds.cpu().numpy()
        all_preds[idx:idx + bs, :, 2:3] = maxvals.cpu().numpy()
        all_boxes[idx:idx + bs, 0:2] = batch["center"]
        all_boxes[idx:idx + bs, 2:4] = batch["scale"]
        all_boxes[idx:idx + bs, 4] = np.prod(batch["scale"] * 200, axis=1)
        all_boxes[idx:idx + bs, 5] = batch["score"]
        image_paths.extend(batch["image_path"])
        idx += bs
        if warm_t0 is None:
            warm_t0, warm_idx = time.perf_counter(), idx

    t_end = time.perf_counter()
    crops_per_sec = idx / max(t_end - t0, 1e-9)
    if idx > warm_idx:
        warm_s = t_end - warm_t0
        warm_rate, build_share = (idx - warm_idx) / warm_s, build_s / warm_s
    else:                               # one batch: no rate after it
        warm_rate = build_share = float("nan")
    mean_acc = (sum(a * c for a, c in accs) / max(sum(c for _, c in accs), 1))
    logger.info("validate: %d crops, %.1f crops/s; after the first batch "
                "%.1f crops/s, %.3f of it building samples; PCK@0.5 %.3f",
                idx, crops_per_sec, warm_rate, build_share, mean_acc)
    return dataset.evaluate(cfg, all_preds, output_dir, all_boxes,
                            image_paths)


def serving_copy(model, eval_model):
    """Load ``model``'s weights and running stats (a train model's float32
    masters) into ``eval_model`` (a serving model from ``models.
    build_model``), as ``UdpPosePipeline`` loads a ``.pth``; returns
    ``eval_model``."""
    with torch.no_grad():
        eval_model.load_state_dict(model.state_dict(), strict=True)
    return eval_model.eval()
