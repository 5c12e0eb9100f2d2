"""End-to-end learning proof of the PyTorch port (port of
``tools/overfit_proof.py``): overfit a tiny set, require AP → 1.0.

Exercises the whole stack: dataset → UDP crop → target encoding →
training → DARK decode → source-space transform → rescoring → OKS-NMS →
COCO AP.  A plateau at loss ≈ 0.002 (the zero-prediction baseline for
σ=2 Gaussians on 64×48 maps) means the model predicts zeros; convergence
to ~1e-5 with AP 1.0 proves the loop.

    python -m udp_pose_tpu_torch.overfit_proof [--root DIR] \
        [--steps 5000] [--image-set val2017] [--device cpu]

It writes no data set: point ``--root`` at a COCO-layout set, such as
the ``val2017`` split that :func:`.generalization_proof.generate`
writes.  The whole image set is one batch; ``pose_resnet`` 18 at
192×256, gaussian targets, no augmentation, float32 with TF32 off
(:func:`.export.onnx_eval.fp32_exact`).  The results json goes to a
temporary directory, whose path is printed.
Fails (``SystemExit``) unless the AP exceeds 0.95.  Runs on the card
unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import tempfile


def proof_config(root, image_set):
    """The proof's config: ``pose_resnet`` 18 at 192x256 with 256-channel
    deconvs, gaussian targets, no flip, scale or rotation, ``image_set``
    for both training and validation, GT boxes, no flip test, fp32."""
    from .config import default_config
    cfg = default_config()
    cfg.DATASET.DATASET = "coco"
    cfg.DATASET.ROOT = root
    cfg.DATASET.TRAIN_SET = image_set
    cfg.DATASET.TEST_SET = image_set
    cfg.DATASET.FLIP = False
    cfg.DATASET.SCALE_FACTOR = 0.0
    cfg.DATASET.ROT_FACTOR = 0.0
    cfg.MODEL.NAME = "pose_resnet"
    cfg.MODEL.TARGET_TYPE = "gaussian"
    cfg.MODEL.IMAGE_SIZE = [192, 256]
    cfg.MODEL.HEATMAP_SIZE = [48, 64]
    cfg.MODEL.EXTRA.merge_from_dict({
        "NUM_LAYERS": 18, "NUM_DECONV_LAYERS": 3,
        "NUM_DECONV_FILTERS": [256, 256, 256],
        "NUM_DECONV_KERNELS": [4, 4, 4],
        "DECONV_WITH_BIAS": False, "FINAL_CONV_KERNEL": 1})
    cfg.TEST.USE_GT_BBOX = True
    cfg.TEST.FLIP_TEST = False
    cfg.TEST.POST_PROCESS = True
    cfg.TEST.BATCH_SIZE_PER_GPU = 8
    cfg.TPU.DTYPE = "float32"
    return cfg


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Overfit a tiny set and "
                                            "require AP > 0.95")
    p.add_argument("--root", default=os.path.join(tempfile.gettempdir(),
                                                  "syncoco"))
    p.add_argument("--steps", type=int, default=5000)
    p.add_argument("--image-set", default="val2017")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def main(argv=None):
    """Run the proof; returns a record of it ({"images", "steps",
    "seconds", "ms_per_step", "loss", "name_values", "ap", "out_dir"}).
    Raises ``SystemExit`` unless the AP exceeds 0.95."""
    from .export.onnx_eval import fp32_exact
    from .utils.platform import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    with fp32_exact(device):
        return _prove(args, device)


def _prove(args, device):
    from .core.train import upload_batch
    from .core.validate import serving_copy, validate
    from .data import build_dataset
    from .data.base import collate
    from .generalization_proof import train_steps
    from .models import build_model

    cfg = proof_config(args.root, args.image_set)
    model = build_model(cfg, device=device, train=True)
    train_ds = build_dataset(cfg, is_train=True)
    train_ds.seed(0)
    batch = upload_batch(collate([train_ds[i]
                                  for i in range(len(train_ds))]), device)
    record = train_steps(cfg, model, [batch], args.steps)
    print(f"{args.steps} steps in {record['seconds']:.0f}s, "
          f"final loss {record['loss']:.6f}")

    val_ds = build_dataset(cfg, is_train=False)
    out_dir = tempfile.mkdtemp(prefix="overfit_proof_")
    print(f"results under {out_dir}")
    nv, ap = validate(cfg, val_ds,
                      serving_copy(model, build_model(cfg, device=device)),
                      out_dir)
    print({k: round(float(v), 3) for k, v in nv.items()})
    record.update(images=len(train_ds), name_values=nv, ap=ap,
                  out_dir=out_dir)
    if not ap > 0.95:
        raise SystemExit(f"E2E learning proof FAILED: AP {ap}")
    print(f"E2E LEARNING PROOF PASSED: AP={ap:.3f}")
    return record


if __name__ == "__main__":
    main()
