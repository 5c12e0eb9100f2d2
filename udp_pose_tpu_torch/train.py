"""Training entry point of the PyTorch port (port of ``tools/train.py``
for every ported model and dataset, in epoch mode and in RSN's iteration
mode):

    python -m udp_pose_tpu_torch.train --cfg <experiment.yaml> \
        [--device cpu] [KEY VALUE ...]

Each epoch runs the train steps (train-time PCK at ``PRINT_FREQ``, but
for RSN), the flip-test validation of :mod:`.core.validate`, then writes
``model_best.pth`` when the AP improved; ``final_state.pth`` follows the
last epoch.  An RSN with ``TRAIN.MAX_ITER`` > 0 trains for iterations
instead (:func:`run`), writing ``iter-<N>.pth`` and ``iter-last.pth``
every checkpoint period, and validates once at the end.  The weights
are torch state dicts in the reference key names, which
``UdpPosePipeline(cfg, weights=...)`` and ``serve --weights`` load with
``strict=True``.  Runs on the card unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import logging
import os
import time
from typing import NamedTuple

import torch

logger = logging.getLogger(__name__)

# config keys whose JAX-package features the port does not have yet:
# (test, what is missing)
_NOT_PORTED = (
    (lambda c: c.DATASET.DEVICE_AUG, "DATASET.DEVICE_AUG (on-device "
     "augmentation)"),
    (lambda c: c.TPU.PP, "TPU.PP (pipeline parallelism)"),
    (lambda c: c.TPU.TP, "TPU.TP (tensor parallelism)"),
    (lambda c: c.TPU.REMAT, "TPU.REMAT (activation rematerialisation)"),
    (lambda c: c.TPU.CKPT_BACKEND != "msgpack", "TPU.CKPT_BACKEND orbax"),
    (lambda c: c.AUTO_RESUME, "AUTO_RESUME (resume from checkpoints)"),
    (lambda c: c.TRAIN.RESUME, "TRAIN.RESUME"),
    (lambda c: c.MODEL.INIT_WEIGHTS and c.MODEL.PRETRAINED,
     "MODEL.PRETRAINED (pretrained-weight grafting)"),
    (lambda c: c.DEBUG.DEBUG, "DEBUG.DEBUG (debug images)"),
)


def refuse_unported(cfg):
    """Raise for a config that asks for a feature not ported yet."""
    for asks, what in _NOT_PORTED:
        if asks(cfg):
            raise NotImplementedError(f"{what} is not ported yet")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train a keypoint network "
                                            "(PyTorch port)")
    p.add_argument("--cfg", required=True, type=str)
    p.add_argument("--modelDir", type=str, default="")
    p.add_argument("--logDir", type=str, default="")
    p.add_argument("--dataDir", type=str, default="")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    p.add_argument("opts", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def set_cudnn(cfg):
    """The reference's cuDNN switches (tools/train.py:87-89)."""
    torch.backends.cudnn.benchmark = cfg.CUDNN.BENCHMARK
    torch.backends.cudnn.deterministic = cfg.CUDNN.DETERMINISTIC
    torch.backends.cudnn.enabled = cfg.CUDNN.ENABLED


def save_state_dict(model, path):
    """``model``'s state dict as contiguous CPU tensors in the reference
    key names."""
    torch.save({k: v.detach().cpu().contiguous()
                for k, v in model.state_dict().items()}, path)


def main(argv=None):
    args = parse_args(argv)
    from .config import default_config, update_config
    from .utils.platform import resolve_device
    device = resolve_device(args.device)
    cfg = default_config()
    update_config(cfg, args)
    refuse_unported(cfg)

    from .data import build_dataset
    from .models import build_model
    from .utils.logging import create_logger
    _, final_output_dir, _ = create_logger(cfg, args.cfg, "train")
    logger.info(f"device: {device}"
                + (f" ({torch.cuda.get_device_name(device)})"
                   if device.type == "cuda" else ""))
    set_cudnn(cfg)
    model = build_model(cfg, device=device, train=True)
    train_ds = build_dataset(cfg, is_train=True)
    val_ds = build_dataset(cfg, is_train=False)
    return run(cfg, model, train_ds, val_ds, final_output_dir, device)


class RSNSchedule(NamedTuple):
    """How long an RSN trains and at what LR."""
    max_iters: int
    ckpt_period: int          # 0: no iteration checkpoints (epoch mode)
    base_lr: float
    warmup_iters: int


def rsn_schedule(cfg, steps_per_epoch: int) -> RSNSchedule:
    """RSN's schedule on one card (``tools/train.py:157-183`` with one
    device).  Iteration mode (``TRAIN.MAX_ITER`` > 0) scales the
    ``ITER_BASELINE_DEVICES``-device recipe to one device: the iteration
    count and checkpoint period by ``ITER_BASELINE_DEVICES`` (×8), the
    LR by 1 (RSN train.py:36-38, solver.py:11), the warmup
    ``WARMUP_ITERS``.  Epoch mode: ``steps_per_epoch · END_EPOCH`` steps
    at ``LR``, a warmup of min(1000, steps_per_epoch)."""
    t = cfg.TRAIN
    if t.MAX_ITER > 0:
        scale = t.ITER_BASELINE_DEVICES
        return RSNSchedule(max(int(t.MAX_ITER * scale), 2),
                           max(int(t.CHECKPOINT_PERIOD * scale), 1),
                           t.LR, t.WARMUP_ITERS)
    return RSNSchedule(max(steps_per_epoch * t.END_EPOCH, 2), 0, t.LR,
                       min(1000, steps_per_epoch))


def save_iter_checkpoint(out_dir, model, state, iteration):
    """RSN's iteration checkpoint (engine.py:162-169), named as the JAX
    package names its ``.msgpack`` (``utils/checkpoint.py:50-70``):
    ``iter-<iteration>.pth`` holding the model's state dict in the
    reference keys (``state_dict``), the optimizer's and the scheduler's,
    the iteration and the step, and ``iter-last.pth`` a link to it.
    Returns the path."""
    name = f"iter-{int(iteration)}.pth"
    path = os.path.join(out_dir, name)
    torch.save({"iteration": int(iteration), "step": int(state.step),
                "state_dict": {k: v.detach().cpu().contiguous()
                               for k, v in model.state_dict().items()},
                "optimizer": state.optimizer.state_dict(),
                "scheduler": state.scheduler.state_dict()}, path)
    link = os.path.join(out_dir, "iter-last.pth")
    if os.path.lexists(link):
        os.unlink(link)
    os.symlink(name, link)
    return path


def infinite_batches(dataset, batch_size, shuffle, epoch_batches,
                     group_ids=None):
    """RSN's endless batch stream (the IterationBasedBatchSampler, cvpack
    iteration_based_batch_sampler.py:5-31): epoch ``p`` = 0, 1, ... in
    turn, each its epoch-seeded plan through ``epoch_batches(p)``; yields
    (epoch, step in epoch, batch).  Raises when an epoch's plan holds no
    batch."""
    from .data.base import epoch_batch_indices
    p = 0
    while True:
        if not epoch_batch_indices(dataset, batch_size, shuffle=shuffle,
                                   seed=p, group_ids=group_ids):
            raise RuntimeError(
                f"epoch {p} produced no batches (dataset size "
                f"{len(dataset)} < batch {batch_size}?)")
        batches = epoch_batches(p)
        try:
            for j, batch in enumerate(batches):
                yield p, j, batch
        finally:
            close = getattr(batches, "close", None)
            if close is not None:
                close()
        p += 1


def run(cfg, model, train_ds, val_ds, out_dir, device="cuda"):
    """Train ``model`` (from ``build_model(cfg, train=True)``) on
    ``train_ds`` and validate it on ``val_ds``: for epochs
    ``TRAIN.BEGIN_EPOCH`` to ``TRAIN.END_EPOCH``, validating after each,
    or, for an RSN with ``TRAIN.MAX_ITER`` > 0, for the iterations of
    :func:`rsn_schedule` over endless epoch-seeded batches
    (:func:`infinite_batches`), with :func:`save_iter_checkpoint` every
    checkpoint period and after the last iteration, then one validation.
    With ``WORKERS`` > 0 the batches come from that many worker
    processes (:mod:`.data.worker_loader`, augmentation seeded per
    record) through the pinned one-ahead upload of :mod:`.data.prefetch`;
    else, or with ``ASPECT_RATIO_GROUPING``, they are built in this
    process.  Returns a record of the run: per step its epoch, step in
    the epoch, iteration, loss, LR, the seconds spent waiting for the
    batch (``load_s``) and the whole iteration (``iter_s``, host clock;
    no per-step synchronise); per validation its seconds, crop count and
    AP; the last ``name_values``, the best AP and the iteration
    checkpoints written."""
    from .core.accuracy import pck_accuracy
    from .core.loss import make_loss_fn
    from .core.rsn import (RSN_BATCH_KEYS, create_rsn_train_state,
                           make_rsn_train_step, upload_rsn_batch)
    from .core.train import create_train_state, make_train_step, upload_batch
    from .core.validate import serving_copy, validate
    from .data.base import aspect_ratio_group_ids, epoch_loader
    from .data.prefetch import device_prefetch
    from .data.worker_loader import worker_loader
    from .models import build_model
    from .utils.logging import AverageMeter, print_name_value
    from .utils.platform import resolve_device

    refuse_unported(cfg)
    device = resolve_device(device)
    batch_size = cfg.TRAIN.BATCH_SIZE_PER_GPU
    steps_per_epoch = max(len(train_ds) // batch_size, 1)
    is_rsn = cfg.MODEL.NAME == "rsn"
    sched = None
    if is_rsn:
        sched = rsn_schedule(cfg, steps_per_epoch)
        state = create_rsn_train_state(cfg, model, sched.base_lr,
                                       sched.max_iters, sched.warmup_iters)
        step_fn = make_rsn_train_step(
            cfg.MODEL.EXTRA.get("STAGE_NUM", 1), ohkm=cfg.LOSS.USE_OHKM,
            topk=cfg.LOSS.TOPK)
        upload, keys = upload_rsn_batch, ("image",) + RSN_BATCH_KEYS
    else:
        state = create_train_state(cfg, model, steps_per_epoch)
        step_fn = make_train_step(make_loss_fn(cfg), with_output=True)
        upload, keys = upload_batch, ("image", "target", "target_weight")
    iter_mode = is_rsn and cfg.TRAIN.MAX_ITER > 0
    eval_model = build_model(cfg, device=device)
    # QAT validates through the fake-quant grid too; the wrapper shares
    # eval_model's tensors, which serving_copy refreshes each validation
    eval_net = eval_model
    if cfg.TPU.QAT == "int8":
        from .models.quantize import FakeQuantModel
        eval_net = FakeQuantModel(eval_model)
        logger.info("=> QAT int8: training through the fake-quant grid")
    group_ids = (aspect_ratio_group_ids(train_ds)
                 if cfg.DATASET.ASPECT_RATIO_GROUPING else None)
    # WORKERS > 0: worker processes and the pinned prefetch, as the JAX
    # package's grain loader; grouped batches keep the in-process loader
    # (tools/train.py:285-299)
    workers = cfg.WORKERS > 0 and group_ids is None
    if cfg.WORKERS > 0 and not workers:
        logger.warning("ASPECT_RATIO_GROUPING needs the in-process loader; "
                       "ignoring WORKERS > 0 for grouping")

    def epoch_batches(epoch):
        if workers:
            return device_prefetch(
                worker_loader(train_ds, batch_size, seed=epoch,
                              shuffle=cfg.TRAIN.SHUFFLE,
                              num_workers=cfg.WORKERS), device, keys=keys)
        train_ds.seed(epoch)
        return epoch_loader(train_ds, batch_size, shuffle=cfg.TRAIN.SHUFFLE,
                            seed=epoch, group_ids=group_ids)

    record = {"steps": [], "validations": [], "best_perf": 0.0,
              "name_values": None, "checkpoints": []}

    def validated(epoch):
        t0 = time.perf_counter()
        serving_copy(model, eval_model)
        name_values, perf = validate(cfg, val_ds, eval_net, out_dir)
        record["validations"].append({
            "epoch": epoch, "seconds": time.perf_counter() - t0,
            "crops": len(val_ds), "perf": perf})
        print_name_value(logger, name_values, cfg.MODEL.NAME)
        record["name_values"] = name_values
        return perf

    def stepped(epoch, i, iteration, batch, t_iter):
        """One train step and its record entry, whose ``iter_s`` the
        caller sets at the end of the iteration; returns the metrics."""
        t_loaded = time.perf_counter()
        lr = state.optimizer.param_groups[0]["lr"]
        metrics = step_fn(state, upload(batch, device))
        record["steps"].append({
            "epoch": epoch, "step": i, "iteration": iteration,
            "loss": metrics["loss"], "lr": lr, "load_s": t_loaded - t_iter})
        return metrics

    def iteration_ended(t_iter):
        t_end = time.perf_counter()
        record["steps"][-1]["iter_s"] = t_end - t_iter
        return t_end

    if iter_mode:
        # iteration-based RSN training (tools/train.py:320-420)
        logger.info(f"iteration mode: {sched.max_iters} iters (x"
                    f"{cfg.TRAIN.ITER_BASELINE_DEVICES:g} of "
                    f"{cfg.TRAIN.MAX_ITER}), lr {sched.base_lr}, ckpt every "
                    f"{sched.ckpt_period}")
        stream = infinite_batches(train_ds, batch_size, cfg.TRAIN.SHUFFLE,
                                  epoch_batches, group_ids)
        loss_sum = None
        t_iter = time.perf_counter()
        try:
            for it in range(sched.max_iters):
                epoch, i, batch = next(stream)
                step_loss = stepped(epoch, i, it, batch, t_iter)["loss"]
                # summed on the device: no per-step wait for the card
                loss_sum = (step_loss if loss_sum is None
                            else loss_sum + step_loss)
                if it % cfg.PRINT_FREQ == 0:
                    secs = max(time.perf_counter() - t_iter, 1e-9)
                    logger.info(
                        f"Iter [{it}/{sched.max_iters}] Speed "
                        f"{len(batch['image']) / secs:.1f}/s Loss "
                        f"{float(step_loss):.4f} (avg "
                        f"{float(loss_sum) / (it + 1):.4f}) lr "
                        f"{record['steps'][-1]['lr']:.6g} ETA "
                        f"{(sched.max_iters - it) * secs / 3600:.2f}h")
                if (it + 1) % sched.ckpt_period == 0:
                    record["checkpoints"].append(
                        save_iter_checkpoint(out_dir, model, state, it))
                t_iter = iteration_ended(t_iter)
        finally:
            stream.close()
        record["checkpoints"].append(
            save_iter_checkpoint(out_dir, model, state, sched.max_iters - 1))
        record["best_perf"] = validated(record["steps"][-1]["epoch"])
    else:
        best_perf = 0.0
        for epoch in range(cfg.TRAIN.BEGIN_EPOCH, cfg.TRAIN.END_EPOCH):
            loss_sum, loss_cnt = None, 0
            acc_meter = AverageMeter()
            t_iter = time.perf_counter()
            for i, batch in enumerate(epoch_batches(epoch)):
                metrics = stepped(epoch, i, len(record["steps"]), batch,
                                  t_iter)
                step_loss = metrics["loss"]
                loss_sum = (step_loss if loss_sum is None
                            else loss_sum + step_loss)
                loss_cnt += 1
                if i % cfg.PRINT_FREQ == 0:
                    if not is_rsn:
                        # train-time PCK@0.5 on the heatmap argmax
                        hm = metrics["output"]
                        tgt = torch.as_tensor(batch["target"]).cpu().numpy()
                        if cfg.MODEL.TARGET_TYPE == "offset":
                            hm, tgt = hm[:, ::3], tgt[:, ::3]
                        _, avg_acc, cnt, _ = pck_accuracy(hm.cpu().numpy(),
                                                          tgt)
                        acc_meter.update(avg_acc, cnt)
                    speed = len(batch["image"]) / max(
                        time.perf_counter() - t_iter, 1e-9)
                    logger.info(
                        f"Epoch [{epoch}][{i}/{steps_per_epoch}] "
                        f"Speed {speed:.1f}/s Loss "
                        f"{float(step_loss) * 1e5:.1f}e-5 (avg "
                        f"{float(loss_sum) / loss_cnt * 1e5:.1f}e-5) "
                        f"Acc {acc_meter.val:.3f} ({acc_meter.avg:.3f})")
                t_iter = iteration_ended(t_iter)
            perf = validated(epoch)
            if perf > best_perf:
                best_perf = perf
                save_state_dict(model, os.path.join(out_dir,
                                                    "model_best.pth"))
        record["best_perf"] = best_perf
    save_state_dict(model, os.path.join(out_dir, "final_state.pth"))
    logger.info(f"=> saved final state to {out_dir}")
    record["steps"] = [dict(s, loss=float(s["loss"]))
                       for s in record["steps"]]
    return record


if __name__ == "__main__":
    main()
