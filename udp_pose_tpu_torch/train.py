"""Training entry point of the PyTorch port (port of ``tools/train.py``,
its epoch mode, for every ported model and dataset):

    python -m udp_pose_tpu_torch.train --cfg <experiment.yaml> \
        [--device cpu] [KEY VALUE ...]

Each epoch runs the train steps (train-time PCK at ``PRINT_FREQ``), the
flip-test validation of :mod:`.core.validate`, then writes
``model_best.pth`` when the AP improved; ``final_state.pth`` follows the
last epoch.  Both are torch state dicts in the reference key names, which
``UdpPosePipeline(cfg, weights=...)`` and ``serve --weights`` load with
``strict=True``.  Runs on the card unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import logging
import os
import time

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
    (lambda c: c.TRAIN.MAX_ITER > 0, "TRAIN.MAX_ITER (iteration mode)"),
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


def run(cfg, model, train_ds, val_ds, out_dir, device="cuda"):
    """Train ``model`` (from ``build_model(cfg, train=True)``) for epochs
    ``TRAIN.BEGIN_EPOCH`` to ``TRAIN.END_EPOCH`` on ``train_ds``,
    validating on ``val_ds`` after each.  With ``WORKERS`` > 0 the
    batches come from that many worker processes
    (:mod:`.data.worker_loader`, augmentation seeded per record) through
    the pinned one-ahead upload of :mod:`.data.prefetch`; else, or with
    ``ASPECT_RATIO_GROUPING``, they are built in this process.  Returns a
    record of the run: per step the seconds spent waiting for the batch
    (``load_s``) and the whole iteration (``iter_s``, host clock; no
    per-step synchronise); per validation its seconds, crop count and AP;
    the last ``name_values`` and the best AP."""
    from .core.accuracy import pck_accuracy
    from .core.loss import make_loss_fn
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
    state = create_train_state(cfg, model, steps_per_epoch)
    step_fn = make_train_step(make_loss_fn(cfg), with_output=True)
    eval_model = build_model(cfg, device=device)
    # QAT validates through the fake-quant grid too; the wrapper shares
    # eval_model's tensors, which serving_copy refreshes each epoch
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
    record = {"steps": [], "validations": [], "best_perf": 0.0,
              "name_values": None}
    best_perf = 0.0

    for epoch in range(cfg.TRAIN.BEGIN_EPOCH, cfg.TRAIN.END_EPOCH):
        if workers:
            batches = device_prefetch(
                worker_loader(train_ds, batch_size, seed=epoch,
                              shuffle=cfg.TRAIN.SHUFFLE,
                              num_workers=cfg.WORKERS),
                device, keys=("image", "target", "target_weight"))
        else:
            train_ds.seed(epoch)
            batches = epoch_loader(train_ds, batch_size,
                                   shuffle=cfg.TRAIN.SHUFFLE, seed=epoch,
                                   group_ids=group_ids)
        loss_sum, loss_cnt = None, 0
        acc_meter = AverageMeter()
        t_iter = time.perf_counter()
        for i, batch in enumerate(batches):
            t_loaded = time.perf_counter()
            metrics = step_fn(state, upload_batch(batch, device))
            step_loss = metrics["loss"]
            # summed on the device: no per-step wait for the card
            loss_sum = step_loss if loss_sum is None else loss_sum + step_loss
            loss_cnt += 1
            if i % cfg.PRINT_FREQ == 0:
                loss = float(step_loss)
                hm = metrics["output"]
                tgt = torch.as_tensor(batch["target"]).cpu().numpy()
                if cfg.MODEL.TARGET_TYPE == "offset":
                    hm, tgt = hm[:, ::3], tgt[:, ::3]
                _, avg_acc, cnt, _ = pck_accuracy(hm.cpu().numpy(), tgt)
                acc_meter.update(avg_acc, cnt)
                speed = len(batch["image"]) / max(
                    time.perf_counter() - t_iter, 1e-9)
                logger.info(
                    f"Epoch [{epoch}][{i}/{steps_per_epoch}] "
                    f"Speed {speed:.1f}/s Loss {loss * 1e5:.1f}e-5 "
                    f"(avg {float(loss_sum) / loss_cnt * 1e5:.1f}e-5) "
                    f"Acc {acc_meter.val:.3f} ({acc_meter.avg:.3f})")
            t_end = time.perf_counter()
            record["steps"].append({
                "epoch": epoch, "step": i, "loss": step_loss,
                "load_s": t_loaded - t_iter, "iter_s": t_end - t_iter})
            t_iter = t_end

        t0 = time.perf_counter()
        serving_copy(model, eval_model)
        name_values, perf = validate(cfg, val_ds, eval_net, out_dir)
        record["validations"].append({
            "epoch": epoch, "seconds": time.perf_counter() - t0,
            "crops": len(val_ds), "perf": perf})
        print_name_value(logger, name_values, cfg.MODEL.NAME)
        record["name_values"] = name_values
        if perf > best_perf:
            best_perf = perf
            save_state_dict(model, os.path.join(out_dir, "model_best.pth"))
    save_state_dict(model, os.path.join(out_dir, "final_state.pth"))
    logger.info(f"=> saved final state to {out_dir}")
    record["best_perf"] = best_perf
    record["steps"] = [dict(s, loss=float(s["loss"]))
                       for s in record["steps"]]
    return record


if __name__ == "__main__":
    main()
