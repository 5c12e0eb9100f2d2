"""Run logging: the port's own copy of ``udp_pose_tpu/utils/logging.py``
(parity: deep_hrnet/lib/utils/utils.py:22-57 create_logger,
lib/core/function.py:278-313 markdown table + AverageMeter)."""

from __future__ import annotations

import logging
import os
import time
from pathlib import Path


def create_logger(cfg, cfg_name, phase="train", write=True):
    """Per-run log file under OUTPUT_DIR/<dataset>/<model>/<cfg_name>/.
    ``write`` False (a data-parallel run's ranks but 0): no file, no
    directory, and the root logger shows warnings only; returns the same
    paths."""
    root = Path(cfg.OUTPUT_DIR or "output")
    dataset = cfg.DATASET.DATASET
    model = cfg.MODEL.NAME
    cfg_stem = Path(cfg_name).stem if cfg_name else "default"
    final_dir = root / dataset / model / cfg_stem
    ts = time.strftime("%Y-%m-%d-%H-%M")
    tb_dir = Path(cfg.LOG_DIR or "log") / dataset / model / \
        f"{cfg_stem}_{ts}"
    if not write:
        logger = logging.getLogger()
        logger.setLevel(logging.WARNING)
        return logger, str(final_dir), str(tb_dir)
    final_dir.mkdir(parents=True, exist_ok=True)

    log_file = final_dir / f"{cfg_stem}_{ts}_{phase}.log"
    fmt = "%(asctime)-15s %(message)s"
    logging.basicConfig(filename=str(log_file), format=fmt)
    logger = logging.getLogger()
    logger.setLevel(logging.INFO)
    console = logging.StreamHandler()
    logger.addHandler(console)

    tb_dir.mkdir(parents=True, exist_ok=True)
    return logger, str(final_dir), str(tb_dir)


def print_name_value(logger, name_value, full_arch_name):
    """Markdown AP table (parity: function.py:278-295)."""
    names = list(name_value.keys())
    values = list(name_value.values())
    num = len(names)
    if len(full_arch_name) > 15:
        full_arch_name = full_arch_name[:8] + "..."
    logger.info("| Arch " + " ".join([f"| {n}" for n in names]) + " |")
    logger.info("|---" * (num + 1) + "|")
    logger.info(
        f"| {full_arch_name} "
        + " ".join([f"| {v:.3f}" for v in values]) + " |")


class AverageMeter:
    """Parity: function.py:298-313."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count if self.count else 0.0
