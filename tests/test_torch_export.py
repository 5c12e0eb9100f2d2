"""The port's ONNX exporter, evaluator, ``.onnx`` weights and export CLI
against the JAX package, on the CPU.

Every emitter writes, from one seeded numpy state dict, the bytes the JAX
package's emitter writes from it; the families that
``tests/fixtures/onnx_golden.json`` pins also hash to its sha256 from
the JAX golden test's variables.  The port's evaluator runs each
artifact bit for bit as the JAX evaluator does, and holds it against
the port model's own forward.  A ``.onnx`` serves what its ``.pth``
serves, and grafts as ``MODEL.PRETRAINED``.  ``python -m
udp_pose_tpu_torch.export`` writes both formats and refuses the jax2tf
ones.
"""

import hashlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_onnx_golden import FIXTURE, _families
from test_torch_hrnet import reduced_cfg
from test_torch_mobile import mobile_cfg
from test_torch_rsn import rsn_cfg
from test_torch_yolov5 import few_threads  # noqa: F401 (autouse)
from test_torch_zoo import seeded_state_dict, zoo_cfg
from udp_pose_tpu.config import default_config as jax_default_config
from udp_pose_tpu.export import onnx_eval as jax_eval
from udp_pose_tpu.export import onnx_families as jax_families
from udp_pose_tpu.export.onnx_mobile import build_pose_mobile
from udp_pose_tpu.export.onnx_rsn import build_rsn
from udp_pose_tpu.export.onnx_yolo import build_yolov5
from udp_pose_tpu.models import build_model as jax_build_model
from udp_pose_tpu_torch.config import default_config
from udp_pose_tpu_torch.export import (check_model, export_onnx_from_cfg,
                                       load_model, run_model)
from udp_pose_tpu_torch.export.onnx_yolo import export_yolov5
from udp_pose_tpu_torch.models import build_detector, build_model
from udp_pose_tpu_torch.utils.convert import (state_dict_to_torch,
                                              variables_to_state_dict)

YOLO_HW = (64, 64)


def _rsn_cfg(fn):
    """Two stages with SE and the conv stem, at 64×64: the graph's fixed
    ×2 upsamples need every stride-32 map whole."""
    cfg = rsn_cfg(fn, STAGE_NUM=2, USE_SE=True)
    cfg.MODEL.IMAGE_SIZE = [64, 64]
    cfg.MODEL.HEATMAP_SIZE = [16, 16]
    return cfg


def _cfgs(fn):
    """{emitter: a small config of it} from either package's defaults:
    the families of ``onnx_families``, RSN, one config of each of the five
    mobile emitters; YOLOv5n has none."""
    return {
        "pose_resnet": zoo_cfg(fn, "pose_resnet", target_type="offset"),
        "pose_hrnet": reduced_cfg(fn, "offset"),
        "pose_hrnet_psa": zoo_cfg(fn, "pose_hrnet_psa"),
        "rsn": _rsn_cfg(fn),
        "shufflenetv2": mobile_cfg(fn, "pose_shufflenetv2_10x"),
        "shufflenetv2_plus": mobile_cfg(fn, "pose_shufflenetv2_plus"),
        "mobilenetv3_small": mobile_cfg(
            fn, "pose_mobilenetv3_small_pixel_shuffle"),
        "mobilevit": mobile_cfg(fn, "pose_mobilevit_pixel_shuffle"),
        "mobilevitv2": mobile_cfg(fn, "pose_mobilevitv2_pixel_shuffle"),
    }


EMITTERS = list(_cfgs(default_config)) + ["yolov5n"]


def jax_emitter_bytes(sd, jcfg, batch):
    """The JAX package's emitter for ``jcfg``'s model, called on ``sd``
    (``export_onnx_from_cfg`` there, after its flax → torch step)."""
    name, extra = jcfg.MODEL.NAME, jcfg.MODEL.EXTRA
    common = dict(final_conv_kernel=extra.get("FINAL_CONV_KERNEL", 1),
                  batch=batch)
    if name.startswith("pose_resnet"):
        return jax_families.build_pose_resnet(
            sd, extra.NUM_LAYERS, jcfg.MODEL.NUM_JOINTS,
            jcfg.MODEL.TARGET_TYPE, jcfg.MODEL.IMAGE_SIZE, **common)
    if name.startswith("pose_hrnet"):
        from udp_pose_tpu.models.hrnet import stage_cfg
        stages = tuple(stage_cfg(extra[k]["NUM_MODULES"],
                                 extra[k]["NUM_BRANCHES"], extra[k]["BLOCK"],
                                 extra[k]["NUM_BLOCKS"],
                                 extra[k]["NUM_CHANNELS"])
                       for k in ("STAGE2", "STAGE3", "STAGE4"))
        return jax_families.build_pose_hrnet(
            sd, stages, jcfg.MODEL.NUM_JOINTS, jcfg.MODEL.TARGET_TYPE,
            jcfg.MODEL.IMAGE_SIZE, **common)
    if name == "rsn":
        return build_rsn(sd, jcfg, batch=batch)
    return build_pose_mobile(sd, jcfg, batch=batch)


@pytest.fixture(scope="module")
def exported():
    """{emitter: (the port's bytes, the JAX emitter's bytes, port model,
    port cfg or None)} from one seeded numpy state dict each."""
    out = {}
    jcfgs = _cfgs(jax_default_config)
    for i, (key, cfg) in enumerate(_cfgs(default_config).items()):
        model = build_model(cfg, device="cpu")
        sd = seeded_state_dict(model, seed=i)
        model.load_state_dict(state_dict_to_torch(sd), strict=True)
        out[key] = (export_onnx_from_cfg(sd, cfg, batch=2),
                    jax_emitter_bytes(sd, jcfgs[key], batch=2), model, cfg)
    model = build_detector("yolov5n", device="cpu")
    sd = seeded_state_dict(model, seed=99)
    model.load_state_dict(state_dict_to_torch(sd), strict=True)
    bare = {k[len("model."):]: v for k, v in sd.items()}
    out["yolov5n"] = (export_yolov5(sd, "n", image_hw=YOLO_HW, batch=1),
                      build_yolov5(bare, "n", image_hw=YOLO_HW, batch=1),
                      model, None)
    return out


def _input(blob, seed):
    shape = load_model(blob).graph.inputs[0][1]
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("emitter", EMITTERS)
def test_bytes_equal_jax_and_graph_equals_forward(exported, emitter):
    """The same numpy state dict through the port's exporter and the JAX
    package's emitter: the same bytes.  The port's evaluator on the CPU
    holds the artifact against the port model's forward (float32, atol
    1e-4 × the output's max)."""
    blob, gold, model, _ = exported[emitter]
    assert blob == gold, emitter
    x = _input(blob, seed=3)
    with torch.inference_mode():
        y = model(torch.from_numpy(x)).float().numpy()
    check_model(blob, x, y, rtol=0, atol=1e-4 * float(np.abs(y).max()),
                device="cpu")


@pytest.mark.parametrize("emitter", ["pose_hrnet", "rsn", "mobilevit",
                                     "mobilevitv2", "shufflenetv2_plus",
                                     "yolov5n"])
def test_run_model_equals_jax_bit_for_bit(exported, emitter):
    """The port's evaluator on the CPU and the JAX package's, on the same
    artifact and input: equal to the bit (the same torch ops; the port
    reads the shape constants from the host copy)."""
    blob = exported[emitter][0]
    x = _input(blob, seed=5)
    name = load_model(blob).graph.inputs[0][0]
    got = run_model(blob, {name: x}, device="cpu")
    want = jax_eval.run_model(blob, {name: x})
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def _golden_state_dict(jcfg, seed=11):
    """The state dict of ``test_onnx_golden._export``'s variables (its
    ``_small_variables``: every leaf redrawn from ``seed`` in the order of
    the flax tree), made from ``jax.eval_shape`` with no init compute."""
    model = jax_build_model(jcfg)
    w, h = jcfg.MODEL.IMAGE_SIZE
    shapes = jax.eval_shape(lambda r: model.init(
        r, jnp.zeros((1, h, w, 3), jnp.float32), train=False),
        jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = "/".join(str(p.key) for p in path)
        if name.endswith(("var", "scale")):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if name.endswith("mean"):
            return (rng.standard_normal(s.shape) * 0.1).astype(np.float32)
        if name.endswith("kernel") and len(s.shape) >= 2:
            std = 0.7 / np.sqrt(int(np.prod(s.shape[:-1])))
            return (rng.standard_normal(s.shape) * std).astype(np.float32)
        return (rng.standard_normal(s.shape) * 0.05).astype(np.float32)

    cfg = default_config()
    cfg.merge_from_dict(jcfg.to_dict())
    v = jax.tree_util.tree_map_with_path(leaf, shapes)
    return variables_to_state_dict(v, cfg), cfg


@pytest.mark.parametrize("family", sorted(_families()))
def test_golden_sha256(family):
    """The families the golden fixture pins: the port's bytes from the
    golden test's variables (bridged by the port's own converter) hash
    to the fixture's sha256."""
    with open(FIXTURE) as f:
        golden = json.load(f)[family]
    sd, cfg = _golden_state_dict(_families()[family])
    blob = export_onnx_from_cfg(sd, cfg, batch=1)
    assert len(blob) == golden["n_bytes"]
    assert hashlib.sha256(blob).hexdigest() == golden["sha256"]
    m = load_model(blob)
    assert len(m.graph.nodes) == golden["n_nodes"]
    assert sorted({n.op_type for n in m.graph.nodes}) == golden["ops"]


def test_onnx_weights_serve_as_the_pth(exported, tmp_path):
    """A ``.onnx`` artifact as weights: ``read_weights`` gives the model's
    state dict (the graph's own constants left out), ``UdpPosePipeline``
    serves what the ``.pth`` of the same weights serves, bit for bit, and
    ``MODEL.PRETRAINED`` grafts every leaf of it."""
    from udp_pose_tpu_torch.engine.pose_engine import UdpPosePipeline
    from udp_pose_tpu_torch.utils.checkpoint import (load_pretrained,
                                                     save_weights)
    from udp_pose_tpu_torch.utils.convert import read_weights
    blob, _, model, cfg = exported["pose_hrnet"]
    onnx_path, pth_path = tmp_path / "w.onnx", tmp_path / "w.pth"
    onnx_path.write_bytes(blob)
    save_weights(str(pth_path), model)
    sd = read_weights(str(onnx_path), cfg)
    want = model.state_dict()
    assert sd.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(sd[k], v.numpy(), err_msg=k)
    cfg.TEST.FLIP_TEST = True
    rng = np.random.default_rng(8)
    crops = rng.integers(0, 256, (3, 64, 64, 3), dtype=np.uint8)
    center = rng.uniform(40, 80, (3, 2)).astype(np.float32)
    scale = np.full((3, 2), 0.32, np.float32)
    out = [UdpPosePipeline(cfg, weights=str(p), device="cpu", seed=7)
           .infer_crops(crops, center, scale) for p in (onnx_path, pth_path)]
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)
    fresh = build_model(cfg, device="cpu", seed=5)
    n = load_pretrained(fresh, str(onnx_path), cfg)
    assert n == len([k for k in want if not k.endswith("num_batches_tracked")
                     and "stage4.2.fuse_layers" not in k])
    for k, v in fresh.state_dict().items():
        if "stage4.2.fuse_layers" not in k and "num_batches" not in k:
            np.testing.assert_array_equal(v.numpy(), want[k].numpy())


def _yaml(cfg, path):
    import yaml
    path.write_text(yaml.safe_dump(cfg.to_dict()))
    return str(path)


def test_export_cli(exported, tmp_path):
    """``python -m udp_pose_tpu_torch.export``: ``--format onnx`` writes
    the exporter's bytes of the ``--weights`` and holds them against the
    port's forward; ``pth`` writes the reference state dict; ``--yolo``
    the detector; the jax2tf formats and ``--quantize`` exit with a
    message; without a card it raises unless ``--device cpu``."""
    from udp_pose_tpu_torch.export.__main__ import main
    from udp_pose_tpu_torch.utils.checkpoint import save_weights
    blob, _, model, cfg = exported["pose_hrnet"]
    cfg_path = _yaml(cfg, tmp_path / "reduced.yaml")
    weights = tmp_path / "w.pth"
    save_weights(str(weights), model)
    out = tmp_path / "m.onnx"
    main(["--cfg", cfg_path, "--weights", str(weights), "--batch", "2",
          "--out", str(out), "--device", "cpu"])
    assert out.read_bytes() == blob
    pth = tmp_path / "m.pth"
    main(["--cfg", cfg_path, "--weights", str(out), "--format", "pth",
          "--out", str(pth), "--device", "cpu", "--skip-check"])
    sd = torch.load(pth, weights_only=True)
    for k, v in model.state_dict().items():
        assert torch.equal(sd[k], v), k
    yolo = tmp_path / "y.onnx"
    main(["--yolo", "yolov5n", "--det-size", "64", "--out", str(yolo),
          "--device", "cpu"])
    assert load_model(yolo.read_bytes()).graph.inputs[0][1] == [1, 3, 64, 64]
    for fmt in ("stablehlo", "tflite", "savedmodel"):
        with pytest.raises(SystemExit, match="jax2tf"):
            main(["--cfg", cfg_path, "--format", fmt, "--device", "cpu"])
    with pytest.raises(SystemExit, match="jax2tf"):
        main(["--cfg", cfg_path, "--quantize", "int8", "--device", "cpu"])
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--cfg", cfg_path])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_model(blob, {"images": _input(blob, 0)})
    assert os.path.getsize(out) == len(blob)
