"""``MODEL.PRETRAINED``, ``TPU.REMAT``, ``DEBUG.DEBUG`` and the model
summary of the port against the JAX package, on the CPU.

Grafting a partial ``.pth`` equals the JAX ``load_pretrained`` followed
by ``flax_to_torch_from_cfg`` on the same file and fresh weights (HRNet
with a ``PRETRAINED_LAYERS`` filter, the ``stage4.2.fuse_layers`` skip and
a leaf of the wrong shape; SimpleBaseline; bare ImageNet backbones of
MobileNetV3 under both torchvision prefixes and of ShuffleNetV2+), and a
``.msgpack`` through the tolerant loader equals the JAX
``load_weights_tolerant``; the rematerialised RSN step is bit-equal to
the plain one in float64; the debug images are the JAX package's, byte
for byte; the parameter count is the JAX count, the FLOPs within 10% of
XLA's cost analysis.  Every file is made here from the port's own
seeded models.
"""

import copy
import types

import numpy as np
import pytest
import torch

from test_torch_hrnet import REDUCED_EXTRA, reduced_cfg
from test_torch_rsn import rsn_cfg
from test_torch_rsn_train import rsn_batch
from test_torch_yolov5 import few_threads  # noqa: F401
from udp_pose_tpu.config import default_config as jax_default_config
from udp_pose_tpu.config import load_config as jax_load_config
from udp_pose_tpu.models import build_model as jax_build_model
from udp_pose_tpu.utils import checkpoint as jax_checkpoint
from udp_pose_tpu.utils import summary as jax_summary
from udp_pose_tpu.utils import torch_convert as jax_convert
from udp_pose_tpu.utils import vis as jax_vis
from udp_pose_tpu_torch.config import default_config, load_config
from udp_pose_tpu_torch.core.rsn import (create_rsn_train_state,
                                         make_rsn_train_step)
from udp_pose_tpu_torch.models import build_model
from udp_pose_tpu_torch.utils import checkpoint as ckpt
from udp_pose_tpu_torch.utils import summary, vis
from udp_pose_tpu_torch.utils.convert import state_dict_to_variables

REPO_CONFIGS = "configs/coco"


def _numpy_sd(model):
    return {k: v.detach().numpy().copy() for k, v in
            model.state_dict().items()}


def _jax_graft(fresh_sd, pretrained, jcfg):
    """The JAX trainer's graft (``tools/train.py:127-156``) on the fresh
    weights ``fresh_sd``, back in the port's keys: (state dict, leaves)."""
    fresh, unused = jax_convert.torch_to_flax_from_cfg(fresh_sd, jcfg)
    assert not unused
    merged, n = jax_convert.load_pretrained(
        {"params": fresh["params"], "batch_stats": fresh["batch_stats"]},
        pretrained, jcfg)
    return jax_convert.flax_to_torch_from_cfg(merged, jcfg), n


def _assert_graft(model, want):
    got = model.state_dict()
    keys = [k for k in want if not k.endswith("num_batches_tracked")]
    assert keys and set(keys) <= set(got)
    for k in keys:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


def _hrnet_cfgs():
    """The reduced HRNet with three stage-4 modules, so that
    ``stage4.2.fuse_layers`` exists."""
    extra = copy.deepcopy(REDUCED_EXTRA)
    extra["STAGE4"]["NUM_MODULES"] = 3
    out = []
    for fn in (default_config, jax_default_config):
        cfg = reduced_cfg(fn)
        cfg.MODEL.EXTRA.merge_from_dict(extra)
        cfg.MODEL.EXTRA.PRETRAINED_LAYERS = ["conv1", "bn1", "layer1",
                                             "stage4", "final_layer"]
        out.append(cfg)
    return out


def test_hrnet_graft_equals_jax(tmp_path):
    """The filtered layers, without the last fuse, graft; the final layer
    of another head's shape is skipped; every other key keeps the fresh
    init; the leaf count is the JAX count."""
    cfg, jcfg = _hrnet_cfgs()
    model = build_model(cfg, device="cpu", train=True)
    fresh = _numpy_sd(model)
    source = _numpy_sd(build_model(cfg, device="cpu", seed=5))
    source["final_layer.weight"] = np.zeros((34,) + source[
        "final_layer.weight"].shape[1:], np.float32)
    source["incre_modules.0.weight"] = np.ones(3, np.float32)
    path = tmp_path / "backbone.pth"
    torch.save({k: torch.from_numpy(v) for k, v in source.items()}, path)

    n = ckpt.load_pretrained(model, str(path), cfg)
    want, n_jax = _jax_graft(fresh, str(path), jcfg)
    _assert_graft(model, want)
    assert n == n_jax

    got = _numpy_sd(model)
    grafted = [k for k in fresh if k.split(".")[0] in ("conv1", "bn1",
                                                        "layer1", "stage4")
               and "stage4.2.fuse_layers" not in k
               and not k.endswith("num_batches_tracked")]
    assert any("stage4.2.fuse_layers" in k for k in fresh)
    for k in fresh:
        np.testing.assert_array_equal(
            got[k], source[k] if k in grafted else fresh[k], err_msg=k)


def test_pose_resnet_graft_equals_jax(tmp_path):
    """SimpleBaseline (ResNet-18, 32-wide deconvolutions) from an
    ImageNet-style file with a classifier: the named layers graft, the
    deconvolution head stays fresh."""
    over = {"MODEL": {"IMAGE_SIZE": [64, 64], "HEATMAP_SIZE": [16, 16],
                      "EXTRA": {"NUM_LAYERS": 18,
                                "NUM_DECONV_FILTERS": [32, 32, 32],
                                "PRETRAINED_LAYERS": ["conv1", "bn1",
                                                      "layer1", "layer2"]}},
            "TPU": {"DTYPE": "float32"}}
    yaml_path = f"{REPO_CONFIGS}/resnet50_256x192_gaussian.yaml"
    cfg, jcfg = load_config(yaml_path), jax_load_config(yaml_path)
    cfg.merge_from_dict(over)
    jcfg.merge_from_dict(over)
    model = build_model(cfg, device="cpu", train=True)
    fresh = _numpy_sd(model)
    source = {k: v for k, v in _numpy_sd(
        build_model(cfg, device="cpu", seed=7, train=True)).items()
        if not k.startswith(("deconv_layers", "final_layer"))}
    source["fc.weight"] = np.ones((1000, 512), np.float32)
    path = tmp_path / "imagenet.pth"
    torch.save({k: torch.from_numpy(v) for k, v in source.items()}, path)
    n = ckpt.load_pretrained(model, str(path), cfg)
    want, n_jax = _jax_graft(fresh, str(path), jcfg)
    _assert_graft(model, want)
    assert n == n_jax > 0


@pytest.mark.parametrize("yaml_name,prefix", [
    ("mobilenetv3_small_256x192", "features."),
    ("mobilenetv3_small_256x192", "0."),
    ("shufflenetv2_plus_small_256x192", "")])
def test_mobile_backbone_graft_equals_jax(tmp_path, yaml_name, prefix):
    """A bare ImageNet backbone (torchvision's MobileNetV3 ``features.``
    or, wrapped in a Sequential, ``0.``; ShuffleNetV2+'s own keys) with
    its classifier: grafted under the pose wrapper's ``backbone.``, the
    classifier dropped, the head fresh, as the JAX maps graft it."""
    yaml_path = f"{REPO_CONFIGS}/{yaml_name}.yaml"
    cfg, jcfg = load_config(yaml_path), jax_load_config(yaml_path)
    model = build_model(cfg, device="cpu", train=True)
    fresh = _numpy_sd(model)
    seeded = _numpy_sd(build_model(cfg, device="cpu", seed=11, train=True))
    root = "backbone.0." if "mobilenetv3" in yaml_name else "backbone."
    source = {prefix + k[len(root):]: v for k, v in seeded.items()
              if k.startswith(root)}
    source["classifier.0.weight" if prefix != "0." else "1.0.weight"] = \
        np.ones((8, 4), np.float32)
    path = tmp_path / "imagenet.pth"
    torch.save({k: torch.from_numpy(v) for k, v in source.items()}, path)
    n = ckpt.load_pretrained(model, str(path), cfg)
    want, _ = _jax_graft(fresh, str(path), jcfg)
    _assert_graft(model, want)
    got = model.state_dict()
    assert n > 50
    for k in fresh:
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(
                got[k].numpy(), seeded[k] if k.startswith(root)
                else fresh[k], err_msg=k)


def test_msgpack_graft_equals_jax_tolerant_loader(tmp_path):
    """A ``.msgpack`` of part of another model's variables, re-rooted
    (no ``params``/``batch_stats`` level) and with a final layer of the
    wrong shape: the port's graft equals the JAX ``load_weights_tolerant``
    merged onto the same fresh variables."""
    cfg, jcfg = reduced_cfg(default_config), reduced_cfg(jax_default_config)
    model = build_model(cfg, device="cpu", train=True)
    fresh_sd = _numpy_sd(model)
    other = state_dict_to_variables(
        build_model(cfg, device="cpu", seed=6).state_dict(), cfg)
    params = {k: v for k, v in other["params"].items()
              if k.startswith(("stem", "layer1", "final_layer"))}
    params["final_layer"] = dict(params["final_layer"], kernel=np.zeros(
        (1, 1, 16, 34), np.float32))
    partial = {**params, **{k: v for k, v in other["batch_stats"].items()
                            if k.startswith("stem")}}
    path = tmp_path / "partial.msgpack"
    jax_checkpoint.save_weights(path, types.SimpleNamespace(
        params=partial, batch_stats={}))

    n = ckpt.load_pretrained(model, str(path), cfg)
    jmodel = jax_build_model(jcfg)
    loaded, _ = jax_checkpoint.load_weights_tolerant(str(path), jmodel,
                                                     (1, 64, 64, 3))
    fresh, _ = jax_convert.torch_to_flax_from_cfg(fresh_sd, jcfg)
    merged = jax_convert._deep_merge(
        {"params": fresh["params"], "batch_stats": fresh["batch_stats"]},
        loaded)
    _assert_graft(model, jax_convert.flax_to_torch_from_cfg(merged, jcfg))
    assert n == jax_convert.count_leaves(loaded) > 10


def test_remat_rsn_step_bit_equal_in_float64():
    """One float64 train step of a reduced two-stage RSN with and without
    ``TPU.REMAT``: the loss, every gradient, every updated weight and
    every running stat, bit for bit."""
    results = []
    for remat in (False, True):
        cfg = rsn_cfg(default_config, STAGE_NUM=2)
        cfg.TPU.REMAT = remat
        model = build_model(cfg, device="cpu", train=True).double()
        state = create_rsn_train_state(cfg, model, 1e-3, 10, 2)
        batch = {k: torch.from_numpy(v).double()
                 for k, v in rsn_batch(cfg).items()}
        loss = make_rsn_train_step(2)(state, batch)["loss"]
        grads = {k: p.grad.clone() for k, p in model.named_parameters()}
        results.append((loss, grads, model.state_dict()))
    (l0, g0, s0), (l1, g1, s1) = results
    assert torch.equal(l0, l1)
    assert g0.keys() == g1.keys() and len(g0) > 50
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k


def test_debug_images_equal_jax(tmp_path):
    """``save_debug_images`` with every ``DEBUG.SAVE_*`` switch writes the
    JAX package's four files, byte for byte."""
    rng = np.random.default_rng(3)
    images = rng.integers(0, 255, (3, 64, 48, 3), np.uint8)
    joints = np.concatenate([rng.uniform(0, 48, (3, 17, 2)),
                             np.zeros((3, 17, 1))], -1).astype(np.float32)
    vis_ = rng.choice([0.0, 1.0], (3, 17, 3)).astype(np.float32)
    target = rng.uniform(0, 1, (3, 17, 16, 12)).astype(np.float32)
    output = rng.normal(0, 1, (3, 17, 16, 12)).astype(np.float32)
    pred = rng.uniform(0, 12, (3, 17, 2)).astype(np.float32) * 4
    files = {}
    for name, module, default_fn in (("port", vis, default_config),
                                     ("jax", jax_vis, jax_default_config)):
        cfg = default_fn()
        cfg.DEBUG.merge_from_dict({
            "DEBUG": True, "SAVE_BATCH_IMAGES_GT": True,
            "SAVE_BATCH_IMAGES_PRED": True, "SAVE_HEATMAPS_GT": True,
            "SAVE_HEATMAPS_PRED": True})
        prefix = tmp_path / name / "train_0_0"
        args = (images, joints, vis_, target, output, str(prefix))
        if name == "port":            # the trainer hands it tensors too
            args = (torch.from_numpy(images),) + args[1:]
        module.save_debug_images(cfg, *args, pred_joints=pred)
        files[name] = {p.name: p.read_bytes()
                       for p in sorted((tmp_path / name).iterdir())}
    assert sorted(files["port"]) == ["train_0_0_gt.jpg",
                                     "train_0_0_hm_gt.jpg",
                                     "train_0_0_hm_pred.jpg",
                                     "train_0_0_pred.jpg"]
    assert files["port"] == files["jax"]


def test_summary_equals_jax(few_threads):  # noqa: F811
    """The parameter count equals the JAX count; the FLOPs of one 64×64
    forward (matrix products and convolutions) lie within 10% of XLA's
    cost analysis (which also counts elementwise work; the reduced HRNet
    reads 1.04 of it)."""
    cfg, jcfg = reduced_cfg(default_config), reduced_cfg(jax_default_config)
    model = build_model(cfg, device="cpu")
    variables, _ = jax_convert.torch_to_flax_from_cfg(_numpy_sd(model), jcfg)
    jmodel = jax_build_model(jcfg)
    assert summary.count_params(model) == jax_summary.count_params(
        variables) > 10 ** 6
    got = summary.model_flops(model, (1, 64, 64, 3))
    want = jax_summary.model_flops(jmodel, variables, (1, 64, 64, 3))
    assert abs(got / want - 1) < 0.10, (got, want)
    assert summary.get_model_summary(model, (1, 64, 64, 3)).startswith(
        "params: 1.10M  fwd flops @ (1, 64, 64, 3): 0.22 GFLOPs")
