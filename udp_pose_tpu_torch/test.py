"""Evaluation entry point of the PyTorch port (port of ``tools/test.py``):

    python -m udp_pose_tpu_torch.test --cfg <experiment.yaml> \
        [--device cpu] TEST.MODEL_FILE x.pth [KEY VALUE ...]

Loads ``TEST.MODEL_FILE`` (a ``.pth``, or a ``.msgpack`` of the JAX
package's variables; without one, ``final_state.pth`` of the run
directory, else its ``final_state.msgpack``, else the seeded random
init), runs the
flip-test validation of :mod:`.core.validate` and prints the AP table;
``TPU.QUANTIZE int8`` evaluates w8a8 serving calibrated on the first
``TPU.QUANTIZE_CALIB_BATCHES`` val batches, ``TPU.QAT int8`` the
fake-quant grid.
Runs on the card unless given ``--device cpu``.  Under ``torchrun``
(``torchrun --nproc_per_node N -m udp_pose_tpu_torch.test ...``) every
rank loads the weights and decodes its shard of the val set on its own
card; the decoded arrays are gathered and every rank prints the same AP
(rank 0 alone logs and writes the results file).
"""

from __future__ import annotations

import logging
import os

logger = logging.getLogger(__name__)


def run(cfg, weight_file, val_ds, out_dir="", device="cuda"):
    """Validate ``cfg``'s serving model with the weights of ``weight_file``
    (None or a missing file: the seeded random init) on ``val_ds``;
    returns (name_values, perf).  In a process group each rank evaluates
    its shard (:func:`.core.validate.validate`)."""
    from .core.validate import validate
    from .models import build_model
    from .parallel import process_shard_info
    from .utils.convert import read_weights, state_dict_to_torch
    from .utils.logging import print_name_value

    model = build_model(cfg, device=device)
    if weight_file and os.path.exists(weight_file):
        logger.info(f"=> loading model from {weight_file}")
        model.load_state_dict(
            state_dict_to_torch(read_weights(weight_file, cfg)), strict=True)
    else:
        logger.warning(f"=> no weights at {weight_file!r}; evaluating the "
                       "seeded random init (smoke mode)")
    if cfg.TPU.QAT == "int8" and cfg.TPU.QUANTIZE != "int8":
        # a QAT checkpoint evaluated the way it trained; TPU.QUANTIZE int8
        # wins when both are set (the deployment eval)
        from .models.quantize import FakeQuantModel
        model = FakeQuantModel(model)
        logger.info("=> QAT int8: evaluating through the fake-quant grid")
    elif cfg.TPU.QAT:
        raise ValueError(f"unknown TPU.QAT mode {cfg.TPU.QAT!r}")
    if cfg.TPU.QUANTIZE == "int8":
        # w8a8 serving, calibrated on the first val batches
        from .models.quantize import quantize_for_eval
        model = quantize_for_eval(cfg, model, val_ds)
        logger.info(f"=> int8 PTQ: calibrated {len(model.act_scales)} conv "
                    "sites")
    elif cfg.TPU.QUANTIZE:
        raise ValueError(f"unknown TPU.QUANTIZE mode {cfg.TPU.QUANTIZE!r}")
    shard_index, num_shards = process_shard_info()
    name_values, perf = validate(cfg, val_ds, model,
                                 out_dir if shard_index == 0 else "",
                                 shard_index=shard_index,
                                 num_shards=num_shards)
    print_name_value(logger, name_values, cfg.MODEL.NAME)
    logger.info(f"=> perf: {perf:.4f}")
    return name_values, perf


def main(argv=None):
    from .config import default_config, update_config
    from .parallel import is_writer, process_group
    from .train import parse_args, refuse_unported
    from .utils.platform import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = default_config()
    update_config(cfg, args)
    refuse_unported(cfg)
    with process_group(args.device) as dp_device:
        return _main(cfg, args, device if dp_device is None else dp_device,
                     is_writer())


def _main(cfg, args, device, writer):
    from .data import build_dataset
    from .utils.logging import create_logger
    _, final_output_dir, _ = create_logger(cfg, args.cfg, "valid",
                                           write=writer)
    weight_file = cfg.TEST.MODEL_FILE
    if not weight_file:
        # the port's own run, else one of the JAX trainer's
        weight_file = os.path.join(final_output_dir, "final_state.pth")
        jax_file = os.path.join(final_output_dir, "final_state.msgpack")
        if not os.path.exists(weight_file) and os.path.exists(jax_file):
            weight_file = jax_file
    return run(cfg, weight_file, build_dataset(cfg, is_train=False),
               final_output_dir, device)


if __name__ == "__main__":
    main()
