"""Attribute-tree config with yacs-compatible semantics (see package doc).

The port's own copy of ``udp_pose_tpu/config/node.py``: same tree, same
merge rules.  ``yaml`` is imported only where a file is read or written,
so a config built from ``default_config()`` plus ``merge_from_dict``
needs no PyYAML.
"""

from __future__ import annotations

import ast
import copy
import os
from typing import Any, Iterable


class Node(dict):
    """A dict with attribute access, freezing, and typed merging."""

    __frozen__ = "__is_frozen__"

    def __init__(self, d=None, new_allowed=False):
        super().__init__()
        object.__setattr__(self, "_new_allowed", new_allowed)
        object.__setattr__(self, "_frozen", False)
        if d:
            for k, v in d.items():
                self[k] = Node(v, new_allowed=new_allowed) if isinstance(v, dict) else v

    # -- pickling (the training input's worker processes) -------------------
    def __reduce__(self):
        return (_rebuild_node, (dict(self),
                                object.__getattribute__(self, "_new_allowed"),
                                object.__getattribute__(self, "_frozen")))

    # -- attribute protocol -------------------------------------------------
    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name, value):
        self[name] = value

    def __setitem__(self, key, value):
        if object.__getattribute__(self, "_frozen"):
            raise AttributeError(f"config is frozen; cannot set {key!r}")
        super().__setitem__(key, value)

    # -- freeze -------------------------------------------------------------
    def freeze(self, frozen=True):
        object.__setattr__(self, "_frozen", frozen)
        for v in self.values():
            if isinstance(v, Node):
                v.freeze(frozen)
        return self

    def defrost(self):
        return self.freeze(False)

    def clone(self):
        out = Node(new_allowed=object.__getattribute__(self, "_new_allowed"))
        for k, v in self.items():
            out[k] = v.clone() if isinstance(v, Node) else copy.deepcopy(v)
        return out

    # -- merging ------------------------------------------------------------
    def merge_from_dict(self, other: dict, path=""):
        for k, v in other.items():
            full = f"{path}.{k}" if path else k
            if k not in self:
                if object.__getattribute__(self, "_new_allowed"):
                    self[k] = Node(v, new_allowed=True) if isinstance(v, dict) else v
                    continue
                raise KeyError(f"unknown config key: {full}")
            cur = self[k]
            if isinstance(cur, Node):
                if not isinstance(v, dict):
                    raise TypeError(f"cannot overwrite section {full} with scalar")
                cur.merge_from_dict(v, full)
            else:
                self[k] = _coerce(v, cur, full)
        return self

    def merge_from_list(self, opts: Iterable[Any]):
        """yacs-style ``[KEY.SUB, value, KEY.SUB, value, ...]`` CLI merge."""
        opts = list(opts)
        if len(opts) % 2 != 0:
            raise ValueError("opts must be KEY VALUE pairs")
        for key, val in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                node = node[p]
            leaf = parts[-1]
            if leaf not in node and not object.__getattribute__(node, "_new_allowed"):
                raise KeyError(f"unknown config key: {key}")
            cur = node.get(leaf)
            if isinstance(val, str):
                try:
                    val = ast.literal_eval(val)
                except (ValueError, SyntaxError):
                    pass
            node[leaf] = _coerce(val, cur, key)
        return self

    def to_dict(self):
        return {k: (v.to_dict() if isinstance(v, Node) else v)
                for k, v in self.items()}


def _rebuild_node(items, new_allowed, frozen):
    node = Node(new_allowed=new_allowed)
    for k, v in items.items():
        dict.__setitem__(node, k, v)
    if frozen:
        object.__setattr__(node, "_frozen", True)
    return node


def _coerce(value, current, path):
    """Light type reconciliation mirroring yacs' behaviour."""
    if current is None or value is None:
        return value
    if isinstance(current, bool):
        if isinstance(value, bool):
            return value
        if isinstance(value, str):
            return value.lower() in ("true", "1", "yes")
        return bool(value)
    if isinstance(current, (int, float)) and isinstance(value, (int, float)):
        return type(current)(value) if not isinstance(value, bool) else value
    if isinstance(current, (list, tuple)) and isinstance(value, (list, tuple)):
        return list(value)
    if type(current) is type(value):
        return value
    if isinstance(value, str):
        return value
    raise TypeError(f"type mismatch for {path}: "
                    f"{type(current).__name__} vs {type(value).__name__}")


def default_config() -> Node:
    """The default tree (parity: deep_hrnet/lib/config/default.py:17-130)."""
    c = Node()
    c.OUTPUT_DIR = ""
    c.LOG_DIR = ""
    c.DATA_DIR = ""
    c.GPUS = (0,)            # kept for yaml compatibility; unused on TPU
    c.WORKERS = 4
    c.PRINT_FREQ = 20
    c.AUTO_RESUME = False
    c.CONTINUE_FROM_BEST = False
    c.MODEL_BEST = ""
    c.PIN_MEMORY = True
    c.RANK = 0

    c.CUDNN = Node()         # accepted and ignored (TPU)
    c.CUDNN.BENCHMARK = True
    c.CUDNN.DETERMINISTIC = False
    c.CUDNN.ENABLED = True

    c.MODEL = Node()
    c.MODEL.NAME = "pose_hrnet"
    c.MODEL.INIT_WEIGHTS = True
    c.MODEL.PRETRAINED = ""
    c.MODEL.NUM_JOINTS = 17
    c.MODEL.TAG_PER_JOINT = True
    c.MODEL.TARGET_TYPE = "gaussian"
    c.MODEL.IMAGE_SIZE = [256, 256]    # [w, h]
    c.MODEL.HEATMAP_SIZE = [64, 64]
    c.MODEL.SIGMA = 2
    c.MODEL.EXTRA = Node(new_allowed=True)
    c.MODEL.CONFIG = None

    c.LOSS = Node()
    c.LOSS.USE_OHKM = False
    c.LOSS.TOPK = 8
    c.LOSS.USE_TARGET_WEIGHT = True
    c.LOSS.REDUCTION = "mean"
    c.LOSS.USE_DIFFERENT_JOINTS_WEIGHT = False
    c.LOSS.KPD = 4.0

    c.DATASET = Node()
    c.DATASET.ROOT = ""
    c.DATASET.DATASET = "mpii"
    c.DATASET.TRAIN_SET = "train"
    c.DATASET.TEST_SET = "valid"
    c.DATASET.DATA_FORMAT = "jpg"
    c.DATASET.HYBRID_JOINTS_TYPE = ""
    c.DATASET.SELECT_DATA = False
    c.DATASET.CUTOUT = None
    c.DATASET.HIDE_AND_SEEK = None
    c.DATASET.FLIP = True
    c.DATASET.SCALE_FACTOR = 0.25
    c.DATASET.ROT_FACTOR = 30
    c.DATASET.PROB_HALF_BODY = 0.0
    c.DATASET.NUM_JOINTS_HALF_BODY = 8
    c.DATASET.COLOR_RGB = False
    # one-group-per-batch aspect-ratio batching (RSN DATALOADER.
    # ASPECT_RATIO_GROUPING, off by default in the reference too)
    c.DATASET.ASPECT_RATIO_GROUPING = False
    c.DATASET.USE_API = False
    # On-device augmentation (data/device_pipeline.py): host workers only
    # decode onto a fixed canvas; warp/aug/AID/targets run inside the jit
    # graph.  CANVAS is (W, H) — images larger than it are clipped, so it
    # must cover the dataset's max dims (COCO: 640x640).
    c.DATASET.DEVICE_AUG = False
    c.DATASET.DEVICE_AUG_CANVAS = [640, 640]

    c.TRAIN = Node()
    c.TRAIN.LR_FACTOR = 0.1
    c.TRAIN.LR_STEP = [90, 110]
    c.TRAIN.LR = 0.001
    c.TRAIN.OPTIMIZER = "adam"
    c.TRAIN.MOMENTUM = 0.9
    c.TRAIN.WD = 0.0001
    c.TRAIN.NESTEROV = False
    c.TRAIN.GAMMA1 = 0.99
    c.TRAIN.GAMMA2 = 0.0
    c.TRAIN.BEGIN_EPOCH = 0
    c.TRAIN.END_EPOCH = 140
    c.TRAIN.RESUME = False
    c.TRAIN.CHECKPOINT = ""
    c.TRAIN.BATCH_SIZE_PER_GPU = 32    # per-device batch on TPU
    c.TRAIN.SHUFFLE = True
    # iteration-based training (RSN recipe, RSN/exps/*/config.py:60-68 +
    # train.py:36-38 8-GPU-baseline scaling); MAX_ITER 0 = epoch mode
    c.TRAIN.MAX_ITER = 0
    c.TRAIN.CHECKPOINT_PERIOD = 2400
    c.TRAIN.WARMUP_ITERS = 2400
    c.TRAIN.ITER_BASELINE_DEVICES = 8

    c.TEST = Node()
    c.TEST.BATCH_SIZE_PER_GPU = 32
    c.TEST.FLIP_TEST = False
    # flip-test schedule inside the jit graph: 'fold' (one 2B-concat
    # forward) or 'two_pass' (two B-sized forwards — faster once the
    # serving batch alone fills the chip; round-4 study, core/infer.py)
    c.TEST.FLIP_MODE = "fold"
    c.TEST.POST_PROCESS = False
    c.TEST.SHIFT_HEATMAP = False
    c.TEST.USE_GT_BBOX = False
    c.TEST.IMAGE_THRE = 0.1
    c.TEST.NMS_THRE = 0.6
    c.TEST.SOFT_NMS = False
    c.TEST.OKS_THRE = 0.5
    c.TEST.IN_VIS_THRE = 0.0
    c.TEST.COCO_BBOX_FILE = ""
    c.TEST.BBOX_THRE = 1.0
    c.TEST.MODEL_FILE = ""

    c.DEBUG = Node()
    c.DEBUG.DEBUG = False
    c.DEBUG.SAVE_BATCH_IMAGES_GT = False
    c.DEBUG.SAVE_BATCH_IMAGES_PRED = False
    c.DEBUG.SAVE_HEATMAPS_GT = False
    c.DEBUG.SAVE_HEATMAPS_PRED = False

    # TPU-specific extensions (absent from reference yamls → defaults apply)
    c.TPU = Node()
    c.TPU.MESH = Node()
    c.TPU.MESH.DATA = -1       # -1: all devices on the data axis
    c.TPU.MESH.MODEL = 1
    c.TPU.TP = False           # shard channel dims over the 'model' axis
    c.TPU.TP_MIN_FEATURES = 64  # smallest channel dim worth sharding
    c.TPU.PP = False           # GPipe pipeline over 'model' (RSN stages)
    c.TPU.PP_MICROBATCHES = 2  # microbatches in flight per step
    c.TPU.DTYPE = "bfloat16"   # compute dtype for model forward
    c.TPU.REMAT = False        # jax.checkpoint on heavy blocks
    c.TPU.QUANTIZE = ""        # "" | "int8": PTQ serving mode (models/quantize.py)
    c.TPU.QUANTIZE_CALIB_BATCHES = 2  # batches used for amax calibration
    c.TPU.QAT = ""             # "" | "int8": quantization-aware training
    c.TPU.CKPT_BACKEND = "msgpack"  # "msgpack" | "orbax" (async, per-shard
    #                           parallel IO — utils/orbax_ckpt.py)
    c.TPU.CKPT_MAX_TO_KEEP = 2  # orbax retention (rolling checkpoints)
    c.TPU.COMPILATION_CACHE = ""  # dir for the persistent XLA executable
    #                           cache (cold-start; utils/platform.py)
    return c


def load_config(yaml_file: str, opts: Iterable[Any] = ()) -> Node:
    """Load defaults, merge a yaml experiment file, then CLI ``opts``."""
    cfg = default_config()
    if yaml_file:
        import yaml
        with open(yaml_file) as f:
            loaded = yaml.safe_load(f) or {}
        cfg.merge_from_dict(loaded)
    if opts:
        cfg.merge_from_list(opts)
    return cfg


def update_config(cfg: Node, args) -> Node:
    """CLI entry merge (parity: default.py:133-160)."""
    cfg.defrost()
    if getattr(args, "cfg", None):
        import yaml
        with open(args.cfg) as f:
            cfg.merge_from_dict(yaml.safe_load(f) or {})
    cfg.merge_from_list(getattr(args, "opts", []) or [])
    if getattr(args, "modelDir", None):
        cfg.OUTPUT_DIR = args.modelDir
    if getattr(args, "logDir", None):
        cfg.LOG_DIR = args.logDir
    if getattr(args, "dataDir", None):
        cfg.DATA_DIR = args.dataDir
    cfg.DATASET.ROOT = os.path.join(cfg.DATA_DIR, cfg.DATASET.ROOT)
    if cfg.MODEL.PRETRAINED:
        cfg.MODEL.PRETRAINED = os.path.join(cfg.DATA_DIR, cfg.MODEL.PRETRAINED)
    if cfg.TEST.MODEL_FILE:
        cfg.TEST.MODEL_FILE = os.path.join(cfg.DATA_DIR, cfg.TEST.MODEL_FILE)
    cfg.freeze()
    return cfg
