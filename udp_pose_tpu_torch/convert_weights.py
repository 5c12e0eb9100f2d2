"""Reference ``.pth`` checkpoints to msgpack weights, in the PyTorch port
(port of ``tools/convert_weights.py``):

    python -m udp_pose_tpu_torch.convert_weights \
        --cfg configs/coco/hrnet_w32_256x192_udp_offset.yaml \
        --pth pose_hrnet_w32_256x192.pth --out w32_udp.msgpack \
        [--device cpu] [KEY VALUE ...]
    python -m udp_pose_tpu_torch.convert_weights --pth yolov5n.pt \
        --arch yolov5n --out yolov5n.msgpack

The architecture comes from the config (or ``--arch`` for a detector's
ultralytics state dict).  The state dict is loaded with ``strict=True``
into the port's model on ``--device`` (the shape check the JAX tool
makes against a fresh flax init), then written as the JAX package's
``save_weights`` writes flax variables, byte for byte: a file that
``test ... TEST.MODEL_FILE``, ``UdpPosePipeline(cfg, weights=...)`` or
the JAX package load.  Runs on the card unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Convert a reference .pth to "
                                            "msgpack weights")
    p.add_argument("--cfg", default="")
    p.add_argument("--pth", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--arch", default="",
                   help="override: yolov5n/yolov5s for detector checkpoints")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    p.add_argument("opts", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def check_against_model(sd, model):
    """Load the entries of ``sd`` (numpy) that ``model`` has into it with
    ``strict=True``: a missing key or a wrong shape raises, as the JAX
    ``check_against_model`` does against a fresh flax init.  The keys no
    mapping reads were reported already; a ``num_batches_tracked`` that
    ``sd`` lacks keeps the model's, as flax has none."""
    from .utils.convert import state_dict_to_torch
    want = model.state_dict()
    have = {k: v for k, v in want.items()
            if k.endswith("num_batches_tracked")}
    have.update(state_dict_to_torch({k: v for k, v in sd.items()
                                     if k in want}))
    model.load_state_dict(have, strict=True)


def main(argv=None):
    args = parse_args(argv)
    from .utils import convert as cv
    from .utils.msgpack import serialize
    from .utils.platform import resolve_device
    device = resolve_device(args.device)

    sd = cv.load_torch_state_dict(args.pth)
    if args.arch.startswith("yolov5"):
        from .models import build_detector
        variables, unused = cv.convert_yolov5_state_dict(sd)
        model = build_detector(args.arch, device=device)
        sd = cv.ultralytics_state_dict(sd)
    else:
        from .config import load_config
        from .models import build_model
        cfg = load_config(args.cfg, args.opts)
        try:
            variables, unused = cv.convert_state_dict(sd, cfg)
        except KeyError as e:
            raise SystemExit(str(e))
        model = build_model(cfg, device=device)

    if unused:
        print(f"warning: {len(unused)} unused torch keys, e.g. {unused[:5]}")
    with torch.no_grad():
        check_against_model(sd, model)
    blob = serialize(variables)
    with open(args.out, "wb") as f:
        f.write(blob)
    print(f"wrote {args.out} ({len(blob)} bytes)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
