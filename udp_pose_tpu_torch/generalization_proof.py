"""Generalization proof of the PyTorch port (port of
``tools/generalization_proof.py``): train with augmentation on a
synthetic train split, evaluate on unseen val images, which checks the
augmentation geometry end to end.

Synthetic images carry 17 distinctly coloured joint dots, so a
geometrically consistent pipeline generalizes; a warp or joint-mapping
inconsistency under scale and rotation augmentation craters the val AP
instead.  ``--quantize int8`` also evaluates the trained weights through
the int8 PTQ serving path and bounds the AP delta; ``--qat`` also
trains a fake-quant twin on the same pool and evaluates its int8
deployment.

    python -m udp_pose_tpu_torch.generalization_proof [--root DIR] \
        [--steps 5000] [--pool-epochs 24] [--gen-data] \
        [--quantize int8 [--qat] [--int8-ap-tol 0.02]] [--tiny] \
        [--device cpu]

``--gen-data`` (or a missing ``--root``) writes the synthetic set.  The
gates (AP.5 > 0.9, |AP - AP_int8| <= ``--int8-ap-tol``, QAT within the
tolerance + 0.02) hold at full scale; ``--tiny`` (64x64, thin head) only
runs the machinery.  Training and evaluation run in float32 with TF32
off (:func:`.export.onnx_eval.fp32_exact`): with cuDNN's TF32
convolutions, PyTorch's default, the QAT twin's AP drifts past its
gate.  The results jsons go to a temporary directory, whose path is
printed.  Runs on the card
unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np


def generate(root):
    """Write the synthetic set under ``root``: ``train2017`` (64 images)
    and ``val2017`` (16 unseen images) of 320x320 noise with one person
    of 17 coloured joint dots each, from ``default_rng(42)``, and their
    COCO keypoint annotations."""
    import cv2
    rng = np.random.default_rng(42)
    colors = [(int(c[0]), int(c[1]), int(c[2]))
              for c in rng.integers(40, 255, (17, 3))]
    os.makedirs(f"{root}/annotations", exist_ok=True)
    for split, ids in (("train2017", range(1, 65)),
                       ("val2017", range(1001, 1017))):
        os.makedirs(f"{root}/images/{split}", exist_ok=True)
        images, annotations = [], []
        for aid, img_id in enumerate(ids, 1):
            W = H = 320
            img = rng.integers(0, 60, (H, W, 3), np.uint8)
            cx, cy = rng.uniform(110, 210, 2)
            w, h = rng.uniform(80, 120), rng.uniform(120, 170)
            kps = []
            for j in range(17):
                x = float(np.clip(cx + rng.uniform(-w / 2.5, w / 2.5), 5,
                                  W - 5))
                y = float(np.clip(cy + rng.uniform(-h / 2.5, h / 2.5), 5,
                                  H - 5))
                cv2.circle(img, (int(x), int(y)), 5, colors[j], -1)
                kps += [x, y, 2]
            cv2.imwrite(f"{root}/images/{split}/%012d.jpg" % img_id, img)
            images.append({"id": img_id, "width": W, "height": H,
                           "file_name": "%012d.jpg" % img_id})
            annotations.append({
                "id": aid, "image_id": img_id, "category_id": 1,
                "keypoints": kps, "num_keypoints": 17,
                "bbox": [cx - w / 2, cy - h / 2, w, h],
                "area": float(w * h), "iscrowd": 0})
        with open(f"{root}/annotations/person_keypoints_{split}.json",
                  "w") as f:
            json.dump({"images": images, "annotations": annotations,
                       "categories": [{"id": 1, "name": "person"}]}, f)


def proof_config(root, tiny=False):
    """The proof's config: ``pose_resnet`` 18 at 192x256 (``tiny``: 64x64
    with 32-channel deconvs), gaussian targets, scale 0.25, rotation 30,
    no flip (the coloured dots are not left/right symmetric), GT boxes,
    no flip test, fp32."""
    from .config import default_config
    cfg = default_config()
    cfg.DATASET.DATASET = "coco"
    cfg.DATASET.ROOT = root
    cfg.DATASET.TRAIN_SET = "train2017"
    cfg.DATASET.TEST_SET = "val2017"
    cfg.DATASET.FLIP = False
    cfg.DATASET.SCALE_FACTOR = 0.25
    cfg.DATASET.ROT_FACTOR = 30
    cfg.MODEL.NAME = "pose_resnet"
    cfg.MODEL.TARGET_TYPE = "gaussian"
    filters = 32 if tiny else 256
    cfg.MODEL.IMAGE_SIZE = [64, 64] if tiny else [192, 256]
    cfg.MODEL.HEATMAP_SIZE = [16, 16] if tiny else [48, 64]
    cfg.MODEL.EXTRA.merge_from_dict({
        "NUM_LAYERS": 18, "NUM_DECONV_LAYERS": 3,
        "NUM_DECONV_FILTERS": [filters] * 3,
        "NUM_DECONV_KERNELS": [4, 4, 4],
        "DECONV_WITH_BIAS": False, "FINAL_CONV_KERNEL": 1})
    cfg.TEST.USE_GT_BBOX = True
    cfg.TEST.FLIP_TEST = False
    cfg.TEST.POST_PROCESS = True
    cfg.TEST.BATCH_SIZE_PER_GPU = 16
    cfg.TPU.DTYPE = "float32"
    return cfg


def train_steps(cfg, model, batches, steps):
    """``steps`` Adam steps of ``model`` (from ``build_model(cfg,
    train=True)``, or a fake-quant twin of one) over ``batches`` in
    turn, from the train state of ``cfg``; returns {"steps", "seconds",
    "ms_per_step", "loss"} (the seconds up to the last loss on the
    host)."""
    from .core.loss import make_loss_fn
    from .core.train import create_train_state, make_train_step
    state = create_train_state(cfg, model, 10 ** 6)
    step = make_train_step(make_loss_fn(cfg))
    t0 = time.perf_counter()
    m = {}
    for i in range(steps):
        m = step(state, batches[i % len(batches)])
    loss = float(m["loss"]) if m else float("nan")
    secs = time.perf_counter() - t0
    return {"steps": steps, "seconds": secs,
            "ms_per_step": 1e3 * secs / max(steps, 1), "loss": loss}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train with augmentation on a "
                                            "synthetic set, evaluate on "
                                            "unseen images")
    p.add_argument("--root", default=os.path.join(tempfile.gettempdir(),
                                                  "gencoco"))
    p.add_argument("--steps", type=int, default=5000)
    p.add_argument("--pool-epochs", type=int, default=24)
    p.add_argument("--gen-data", action="store_true")
    p.add_argument("--quantize", default="", choices=["", "int8"],
                   help="also evaluate the trained model through the int8 "
                        "PTQ serving path and bound the AP delta (the "
                        "headline protocol's AP cost on a model that is "
                        "not overfit)")
    p.add_argument("--qat", action="store_true",
                   help="with --quantize: also train a QAT twin "
                        "(FakeQuantModel) on the same pool and evaluate "
                        "its int8 deployment")
    p.add_argument("--int8-ap-tol", type=float, default=0.02,
                   help="max allowed |AP_fp - AP_int8| on unseen val")
    p.add_argument("--tiny", action="store_true",
                   help="CPU-scale harness (64x64 thin net, short "
                        "schedule): runs the machinery; the gates hold "
                        "at the default scale")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def main(argv=None):
    """Run the proof; returns a record of it (the pool, each training,
    each evaluation, the deltas).  A failed gate raises
    ``SystemExit``."""
    from .export.onnx_eval import fp32_exact
    from .utils.platform import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    if args.gen_data or not os.path.isdir(args.root):
        generate(args.root)
    with fp32_exact(device):
        return _prove(args, device)


def _prove(args, device):
    from .core.train import upload_batch
    from .core.validate import serving_copy, validate
    from .data import build_dataset
    from .data.base import epoch_loader
    from .models import build_model

    cfg = proof_config(args.root, args.tiny)
    out_dir = tempfile.mkdtemp(prefix="generalization_proof_")
    print(f"results under {out_dir}")
    train_ds = build_dataset(cfg, is_train=True)
    pool = []
    t0 = time.perf_counter()
    for ep in range(args.pool_epochs):
        train_ds.seed(ep)
        for batch in epoch_loader(train_ds, 32, shuffle=True, seed=ep):
            pool.append(upload_batch(batch, device))
    pool_s = time.perf_counter() - t0
    print(f"pool of {len(pool)} augmented batches in {pool_s:.0f}s")
    record = {"pool_batches": len(pool), "pool_seconds": pool_s,
              "out_dir": out_dir}

    def train_one(model, tag):
        got = record[tag] = train_steps(cfg, model, pool, args.steps)
        print(f"[{tag}] {args.steps} steps in {got['seconds']:.0f}s, "
              f"loss {got['loss']:.6f}")

    model = build_model(cfg, device=device, train=True)
    train_one(model, "fp32")
    val = build_dataset(cfg, is_train=False)
    eval_model = serving_copy(model, build_model(cfg, device=device))
    nv, ap = validate(cfg, val, eval_model, os.path.join(out_dir, "fp32"))
    print({k: round(float(v), 3) for k, v in nv.items()})
    record.update(name_values=nv, ap=ap)
    if args.tiny:
        # --tiny drills the machinery: a schedule long enough to learn
        # takes too long on a CPU, so the quality gates hold only at the
        # default scale; here the fp32, int8 and QAT paths run and their
        # deltas compute
        print(f"GENERALIZATION PROOF (tiny machinery drill): AP={ap:.3f}")
    else:
        if not nv["Ap .5"] > 0.9:
            raise SystemExit(f"GENERALIZATION PROOF FAILED: AP.5 "
                             f"{nv['Ap .5']} <= 0.9 ({nv})")
        print(f"GENERALIZATION PROOF PASSED: AP={ap:.3f} "
              f"AP.5={nv['Ap .5']:.3f}")

    if args.quantize == "int8":
        # the headline protocol's AP cost on a model that is not
        # overfit: the same trained weights through the int8 PTQ serving
        # path, calibrated on val batches as ``test ... TPU.QUANTIZE
        # int8`` calibrates
        from .models.quantize import FakeQuantModel, quantize_for_eval
        qcfg = cfg.clone()
        qcfg.defrost()
        qcfg.TPU.QUANTIZE = "int8"
        qmodel = quantize_for_eval(qcfg, eval_model, val)
        nv_q, ap_q = validate(cfg, val, qmodel, os.path.join(out_dir, "int8"))
        d_ap = abs(ap - ap_q)
        d_ap5 = abs(nv["Ap .5"] - nv_q["Ap .5"])
        print(f"INT8 PTQ on unseen val: AP={ap_q:.3f} (delta {d_ap:.4f}) "
              f"AP.5={nv_q['Ap .5']:.3f} (delta {d_ap5:.4f})")
        record.update(name_values_int8=nv_q, ap_int8=ap_q, d_ap_int8=d_ap,
                      d_ap5_int8=d_ap5)
        if not args.tiny and d_ap > args.int8_ap_tol:
            raise SystemExit(f"GENERALIZATION PROOF FAILED: |AP - AP_int8|"
                             f" {d_ap} > {args.int8_ap_tol} (AP {ap}, "
                             f"int8 {ap_q})")

        if args.qat:
            base = build_model(cfg, device=device, train=True)
            train_one(FakeQuantModel(base), "qat")
            dmodel = quantize_for_eval(
                qcfg, serving_copy(base, build_model(cfg, device=device)), val)
            nv_d, ap_d = validate(cfg, val, dmodel,
                                  os.path.join(out_dir, "qat"))
            print(f"QAT->INT8 deployment on unseen val: AP={ap_d:.3f} "
                  f"(delta vs fp32 baseline {abs(ap - ap_d):.4f})")
            record.update(name_values_qat=nv_d, ap_qat=ap_d,
                          d_ap_qat=abs(ap - ap_d))
            if not args.tiny and abs(ap - ap_d) > args.int8_ap_tol + 0.02:
                raise SystemExit(f"GENERALIZATION PROOF FAILED: |AP - "
                                 f"AP_qat| {abs(ap - ap_d)} > "
                                 f"{args.int8_ap_tol + 0.02} (AP {ap}, QAT "
                                 f"int8 {ap_d})")
    return record


if __name__ == "__main__":
    main()
