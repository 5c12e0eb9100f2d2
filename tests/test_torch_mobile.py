"""The port's mobile nets (ShuffleNetV2, ShuffleNetV2+, MobileNetV3-Small,
MobileViT, MobileViTv2 with their deconvolution or pixel-shuffle heads)
against the JAX package, on the CPU.

Seeded reference-format weights go into the JAX package through its
forward bridge (no flax init), come back through the port's
``variables_to_state_dict`` and load with ``strict=True``; the same
numpy-seeded inputs run through both.  The forwards are held in
float64, where the two agree to 1e-6 of the output's max, and the port's
float32 output against the JAX function in float64 at atol 1e-4 (the
summation order, as in ``test_torch_zoo``): MobileViT's float32 output in
the JAX package lies 1.5e-4 from its own float64 one (its LayerNorm and
attention in float32), the port's within 2e-5.  Each of the
nine registry names at 64×64 with the backbones at full width and
32-wide deconvolutions; the MobileViTs also at 64×48, whose stride-16
and -32 maps are no multiple of the patch.  Also the patch unfold and
fold, the align-corners resize, a bf16 drift case, parameter counts
(``jax.eval_shape``), ``conv_sites`` and one train step of MobileViTv2
0.5 against the JAX step in float64.  The int8 sites and QAT of the
mobile nets are in ``test_torch_int8_dwconv``.
"""

import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_quantize import _flax_pose_paths, _nchw
from test_torch_yolov5 import few_threads  # noqa: F401 (autouse)
from test_torch_zoo import seeded_state_dict
from udp_pose_tpu.config import default_config as jax_default_config
from udp_pose_tpu.core import loss as jax_loss
from udp_pose_tpu.core.infer import make_infer_fn as jax_make_infer_fn
from udp_pose_tpu.models import build_model as jax_build_model
from udp_pose_tpu.models import mobile as jax_mobile
from udp_pose_tpu.models import mobilevit as jax_mobilevit
from udp_pose_tpu.utils.torch_convert import (convert_shufflenetv2_test,
                                              flax_to_torch_from_cfg,
                                              torch_to_flax_from_cfg)
from udp_pose_tpu_torch.config import default_config, load_config
from udp_pose_tpu_torch.core import loss
from udp_pose_tpu_torch.core.infer import make_infer_fn
from udp_pose_tpu_torch.core.train import create_train_state, make_train_step
from udp_pose_tpu_torch.models import MODELS, build_model
from udp_pose_tpu_torch.models import mobile, mobilevit
from udp_pose_tpu_torch.models.pose_mobile import MobilePoseNet
from udp_pose_tpu_torch.ops.targets import gaussian_targets_np
from udp_pose_tpu_torch.utils.convert import (MOBILE_NAMES, conv_sites,
                                              state_dict_to_torch,
                                              variables_to_state_dict)

REPO = Path(__file__).resolve().parents[1]
ATOL = 1e-4
HW = (64, 64)             # (h, w) of the reduced inputs
NAMES = sorted(MOBILE_NAMES)
EXTRA = {                 # EXTRA keys a test config sets
    "pose_shufflenetv2_plus": {"MODEL_SIZE": "Small"},
    "pose_shufflenetv2_10x": {"MODEL_SIZE": "1.0x"},
    "pose_mobilevit": {"MODEL_SIZE": "s"},
    "pose_mobilevitv2": {"MODEL_SIZE": 0.5},
}


def mobile_cfg(default_config_fn, name, hw=HW, dtype="float32",
               filters=32, target_type=None):
    """A ``name`` config at input ``hw`` (h, w) from either package's
    defaults: full-width backbone, ``filters``-wide deconvolutions of
    kernel 4, the default pixel-shuffle decoder."""
    cfg = default_config_fn()
    cfg.MODEL.NAME = name
    cfg.MODEL.TARGET_TYPE = target_type or (
        "offset" if name == "shufflenetv2_test" else "gaussian")
    cfg.MODEL.IMAGE_SIZE = [hw[1], hw[0]]
    cfg.MODEL.HEATMAP_SIZE = [hw[1] // 4, hw[0] // 4]
    cfg.TPU.DTYPE = dtype
    extra = {"NUM_DECONV_LAYERS": 3, "NUM_DECONV_FILTERS": [filters] * 3,
             "NUM_DECONV_KERNELS": [4, 4, 4], "DECONV_WITH_BIAS": False,
             "FINAL_CONV_KERNEL": 1}
    for prefix, kw in EXTRA.items():
        if name.startswith(prefix + ("_" if prefix == "pose_mobilevit"
                                     else "")):
            extra.update(kw)
    cfg.MODEL.EXTRA.merge_from_dict(extra)
    return cfg


def _test_layout(sd):
    """The port's ``shufflenetv2_test`` state dict in the layout of the
    reference's experimental class (backbone at the top level,
    ``duc1``..``duc3``), which the JAX bridge reads for that name."""
    out = {}
    for k, v in sd.items():
        if k.startswith("backbone."):
            out[k[len("backbone."):]] = v
        elif k.startswith("decoder.duc."):
            i, rest = k[len("decoder.duc."):].split(".", 1)
            out[f"duc{int(i) + 1}.{rest}"] = v
        elif k.startswith("decoder."):
            out[k[len("decoder."):]] = v
        else:
            out[k] = v
    return out


def bridged(name, seed=0, **kw):
    """(jax model, numpy flax variables, port model on the CPU with the
    same weights, port cfg)."""
    jcfg = mobile_cfg(jax_default_config, name, **kw)
    cfg = mobile_cfg(default_config, name, **kw)
    model = build_model(cfg, device="cpu")
    sd = seeded_state_dict(model, seed)
    if name == "shufflenetv2_test":
        v, unused = convert_shufflenetv2_test(_test_layout(sd))
    else:
        v, unused = torch_to_flax_from_cfg(sd, jcfg)
    assert not unused
    res = model.load_state_dict(
        state_dict_to_torch(variables_to_state_dict(v, cfg)), strict=True)
    assert not res.missing_keys and not res.unexpected_keys
    return jax_build_model(jcfg), v, model, cfg


@pytest.fixture(scope="module")
def nets():
    """Each registry name bridged once, shared by the tests below."""
    return {name: bridged(name, seed=i) for i, name in enumerate(NAMES)}


def _x(seed, hw=HW, B=2):
    return np.random.default_rng(seed).normal(
        size=(B,) + tuple(hw) + (3,)).astype(np.float32)


def _apply64(jmodel, v, x):
    """The JAX model's eval forward in float64 (numpy NHWC)."""
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                     v)
        return np.asarray(jax.jit(lambda v, x: jmodel.clone(
            dtype=jnp.float64).apply(v, x, train=False))(
                v64, jnp.asarray(x, jnp.float64)))


def check_forward(model, jmodel, v, x):
    """The port's float32 forward within ATOL of the JAX one in float64,
    and its float64 forward within 1e-6 of the output's max (the JAX
    package's align-corners resize runs in float32 whatever the input);
    returns the float32 output (NHWC numpy)."""
    want = _apply64(jmodel, v, x)
    with torch.inference_mode():
        got = model(_nchw(x)).permute(0, 2, 3, 1).numpy()
        got64 = copy.deepcopy(model).double()(
            _nchw(x).double()).permute(0, 2, 3, 1).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got64, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    return got


def test_nine_registry_names():
    assert len(NAMES) == 9 and set(NAMES) <= set(MODELS)


@pytest.mark.parametrize("name", NAMES)
def test_fp32_output_matches_jax(nets, name):
    """Bridged weights load ``strict=True``, equal the JAX package's own
    reverse bridge key for key, and give the JAX output (NCHW float32)
    at 64×64."""
    jmodel, v, model, cfg = nets[name]
    sd = variables_to_state_dict(v, cfg)
    jcfg = mobile_cfg(jax_default_config, name)
    if name == "shufflenetv2_test":   # the JAX bridge knows it by its layout
        jcfg.MODEL.NAME = "pose_shufflenetv2_10x_pixel_shuffle"
        jcfg.MODEL.EXTRA.merge_from_dict({"MODEL_SIZE": "1.0x"})
    gold = flax_to_torch_from_cfg(v, jcfg)
    assert sorted(sd) == sorted(gold) == sorted(model.state_dict())
    for k in gold:
        np.testing.assert_array_equal(sd[k], np.asarray(gold[k]), err_msg=k)
    out = check_forward(model, jmodel, v, _x(1))
    J = 17 * (3 if cfg.MODEL.TARGET_TYPE == "offset" else 1)
    assert out.shape == (2, 16, 16, J)


@pytest.mark.parametrize("name", ["pose_mobilevit_pixel_shuffle",
                                  "pose_mobilevitv2_pixel_shuffle"])
def test_patch_resize_matches_jax(nets, name):
    """At 64×48 the stride-16 maps are 4×3 and the stride-32 ones 2×2
    (MobileViT) or resized up from 2×2 (v2: its stride-16 block's 4×3
    input is resized to 4×4 with align corners and stays so): the
    patch unfold resizes up and the fold back down (MobileViT), the
    align-corners resize runs (v2); the outputs equal the JAX package's."""
    jmodel, v, model, _ = nets[name]
    out = check_forward(model, jmodel, v, _x(2, (64, 48)))
    assert out.shape == (2, 16, 16, 17)


@pytest.mark.parametrize("hw", [(4, 4), (4, 3), (5, 7), (3, 2)])
def test_unfold_fold_patches_equal_jax(hw):
    x = np.random.default_rng(3).normal(size=(2,) + hw + (5,)).astype(
        np.float32)
    want = np.asarray(jax_mobilevit.unfold_patches(jnp.asarray(x), 2, 2))
    got = mobilevit.unfold_patches(_nchw(x), 2, 2)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-6, rtol=0)
    back = np.asarray(jax_mobilevit.fold_patches(jnp.asarray(want), hw, 2, 2))
    got_back = mobilevit.fold_patches(got, hw, 2, 2)
    np.testing.assert_allclose(got_back.permute(0, 2, 3, 1).numpy(), back,
                               atol=1e-6, rtol=0)
    if hw[0] % 2 == 0 and hw[1] % 2 == 0:
        np.testing.assert_array_equal(got_back.permute(0, 2, 3, 1).numpy(),
                                      x)


@pytest.mark.parametrize("hw,out", [((3, 3), (4, 4)), ((4, 3), (4, 4)),
                                    ((1, 5), (2, 6)), ((5, 7), (1, 3)),
                                    ((6, 4), (9, 5))])
def test_resize_align_corners_equals_jax(hw, out):
    """The port's ``resize_align_corners`` is the JAX package's, sizes of
    1 included.  There the JAX helper averages where torch's
    ``align_corners=True`` takes the first row; ``MobileViTBlockv2``
    only resizes up to a multiple of the patch (never to 1), where the
    two agree."""
    x = np.random.default_rng(4).normal(size=(2,) + hw + (3,)).astype(
        np.float32)
    want = np.asarray(jax_mobilevit._resize_align_corners(jnp.asarray(x),
                                                          out))
    got = mobilevit.resize_align_corners(_nchw(x), out)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-6, rtol=0)
    ref = F.interpolate(_nchw(x), size=out, mode="bilinear",
                        align_corners=True)
    if 1 in out and out[0] * out[1] != hw[0] * hw[1]:
        assert (ref - got).abs().max() > 0.1
    else:
        np.testing.assert_allclose(ref.numpy(), got.numpy(), atol=1e-5)


def test_hard_sigmoid_and_swish_equal_jax():
    x = np.linspace(-8, 8, 4001, dtype=np.float32)
    np.testing.assert_array_equal(
        mobile.hard_sigmoid(torch.from_numpy(x)).numpy(),
        np.asarray(jax_mobile.hard_sigmoid(jnp.asarray(x))))
    np.testing.assert_array_equal(
        mobile.hard_swish(torch.from_numpy(x)).numpy(),
        np.asarray(jax_mobile.hard_swish(jnp.asarray(x))))
    xs = torch.from_numpy(x)
    assert torch.equal(torch.clamp(xs + 3, 0, 6) / 6, F.hardsigmoid(xs))


def _features(model, x):
    """The head's output (the input of ``final_layer``)."""
    f = model.backbone(x)
    return model.deconv_layers(f) if model.head == "deconv" else \
        model.decoder(f)


def _fit_final_layer(model, v, crops, joints, pairs, hw):
    """``final_layer`` of ``model`` and of ``v`` set to the least-squares
    fit of Gaussian targets at ``joints`` (and at their mirror images on
    the mirrored crops) on the head's features: heatmaps that peak near
    the joints, as trained ones do (``test_torch_zoo``'s gate)."""
    from udp_pose_tpu_torch.core.infer import normalize_images
    from udp_pose_tpu_torch.ops.flip import fliplr_joints_np
    x = normalize_images(torch.as_tensor(crops)).permute(0, 3, 1, 2)
    with torch.inference_mode():
        feats = [_features(model, im) for im in (x, x.flip(3))]
    Fm = torch.cat(feats).permute(0, 2, 3, 1).double().numpy()
    C = Fm.shape[-1]
    targets = []
    for flip in (False, True):
        for j in joints:
            j3 = np.concatenate([j, np.zeros((len(j), 1), np.float32)], 1)
            if flip:
                j3, _ = fliplr_joints_np(j3, np.ones_like(j3), hw[1], pairs)
            targets.append(gaussian_targets_np(
                j3, np.ones_like(j3), (hw[1] // 4, hw[0] // 4),
                (hw[1], hw[0]), 2)[0])
    A = np.concatenate([Fm, np.ones(Fm.shape[:-1] + (1,))], -1)
    Y = np.stack(targets).transpose(0, 2, 3, 1)
    W = np.linalg.lstsq(A.reshape(-1, C + 1), Y.reshape(-1, Y.shape[-1]),
                        rcond=None)[0].astype(np.float32)
    with torch.no_grad():
        model.final_layer.weight.copy_(torch.from_numpy(
            np.ascontiguousarray(W[:C].T))[:, :, None, None])
        model.final_layer.bias.copy_(torch.from_numpy(W[C]))
    v["params"]["final_layer"] = {"kernel": W[None, None, :C], "bias": W[C]}


def _calibrate_bn(model, x):
    """Every BatchNorm's running statistics set to those of ``x`` and its
    mirror image (one train-mode forward at momentum 1): a seeded net's
    activations then vary over the image as a trained one's do, where the
    seeded running statistics leave its stride-32 features nearly
    constant and no head can localise on them."""
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    for m in bns:
        m.momentum = 1.0
    model.train()
    with torch.no_grad():
        model(torch.cat([x, x.flip(3)]))
    model.eval()
    for m in bns:
        m.momentum = 0.1


def test_bf16_drift_against_jax_fp32():
    """MobileNetV3-Small with its 256-wide deconvolution head, BatchNorm
    statistics taken from the crops and the head fitted to peak at known
    joints, served in bf16 by the port against the JAX package in fp32 on
    the same weights, flip-tested: keypoints within the bf16 bounds of
    ``tests/test_quantize.py`` (median < 0.5 px, 95% < 2 px, confidence
    < 0.1)."""
    from udp_pose_tpu_torch.core.infer import (COCO_FLIP_PAIRS,
                                               normalize_images)
    name = "pose_mobilenetv3_small"
    _, _, model, _ = bridged(name, seed=8, filters=256)
    jcfg = mobile_cfg(jax_default_config, name, filters=256)
    jmodel = jax_build_model(jcfg)
    rng = np.random.default_rng(6)
    crops = rng.integers(0, 256, (2,) + HW + (3,), dtype=np.uint8)
    _calibrate_bn(model, normalize_images(torch.as_tensor(crops)).permute(
        0, 3, 1, 2))
    v, unused = torch_to_flax_from_cfg(
        {k: t.numpy() for k, t in model.state_dict().items()}, jcfg)
    assert not unused
    joints = rng.uniform(8, HW[0] - 8, (2, 17, 2)).astype(np.float32)
    _fit_final_layer(model, v, crops, joints, COCO_FLIP_PAIRS, HW)
    bf16 = build_model(mobile_cfg(default_config, name, filters=256,
                                  dtype="bfloat16"), device="cpu")
    bf16.load_state_dict(model.state_dict(), strict=True)
    center = np.tile(np.float32([[HW[1] / 2, HW[0] / 2]]), (2, 1))
    scale = np.tile(np.float32([[HW[1] / 200, HW[0] / 200]]), (2, 1))
    p_j, m_j, _ = jax_make_infer_fn(jmodel, target_type="gaussian",
                                    flip_test=True)(v, crops, center, scale)
    p_j = np.asarray(p_j)
    assert np.median(np.linalg.norm(p_j - joints, axis=-1)) < 6.0
    p_t, m_t, _ = make_infer_fn(bf16, target_type="gaussian",
                                flip_test=True)(crops, center, scale)
    d = np.abs(p_t.numpy() - p_j)
    assert np.median(d) < 0.5, np.median(d)
    assert (d < 2.0).mean() > 0.95, np.percentile(d, 95)
    assert np.abs(m_t.numpy() - np.asarray(m_j)).max() < 0.1


YAMLS = ["mobilenetv3_small_256x192", "mobilevit_s_256x192_pixel_shuffle",
         "mobilevitv2_05_256x192_pixel_shuffle",
         "shufflenetv2_10x_256x192_pixel_shuffle",
         "shufflenetv2_plus_small_256x192"]   # the shipped mobile yamls


@pytest.mark.parametrize("yaml", YAMLS)
def test_yaml_parameter_count_equals_jax(yaml):
    """Each shipped mobile yaml at full width (256×192): the port's
    parameters equal the JAX package's in number, from
    ``jax.eval_shape`` (no init)."""
    from udp_pose_tpu.config import load_config as jax_load_config
    path = REPO / "configs" / "coco" / f"{yaml}.yaml"
    jcfg = jax_load_config(str(path))
    shapes = jax.eval_shape(lambda r: jax_build_model(jcfg).init(
        r, jnp.zeros((1, 256, 192, 3)), train=False), jax.random.PRNGKey(0))
    n_jax = sum(int(np.prod(p.shape))
                for p in jax.tree_util.tree_leaves(shapes["params"]))
    with torch.device("meta"):
        model = MODELS[jcfg.MODEL.NAME](load_config(path))
    assert sum(p.numel() for p in model.parameters()) == n_jax


@pytest.mark.parametrize("name", NAMES)
def test_conv_sites_are_the_flax_paths(nets, name):
    """Every Conv2d of the port's model has a site, and the sites are the
    flax modules holding a (non-transposed) conv kernel."""
    _, v, model, _ = nets[name]
    sites = conv_sites(model)
    assert set(sites) == {n for n, m in model.named_modules()
                          if isinstance(m, torch.nn.Conv2d)}
    flax = [p for p in _flax_pose_paths(v["params"])
            if not p.startswith("deconv/") and "/tr" not in p]
    assert sorted(sites.values()) == sorted(flax)
    assert isinstance(model, MobilePoseNet)


def _gaussian_batch(cfg, B=2, seed=5):
    rng = np.random.default_rng(seed)
    w, h = cfg.MODEL.IMAGE_SIZE
    image = rng.normal(size=(B, h, w, 3)).astype(np.float32)
    tgts, wts = [], []
    for _ in range(B):
        joints = np.concatenate([rng.uniform(0, w - 1, (17, 1)),
                                 rng.uniform(0, h - 1, (17, 1)),
                                 np.zeros((17, 1))], 1)
        vis = rng.choice([0.0, 1.0], (17, 1), p=[0.2, 0.8]).repeat(3, 1)
        t, wt = gaussian_targets_np(joints, vis, cfg.MODEL.HEATMAP_SIZE,
                                    cfg.MODEL.IMAGE_SIZE, cfg.MODEL.SIGMA)
        tgts.append(t)
        wts.append(wt)
    return {"image": image, "target": np.stack(tgts).astype(np.float32),
            "target_weight": np.stack(wts).astype(np.float32)}


def test_mobilevitv2_train_step_equals_jax_float64(nets):
    """One fp32 train step of MobileViTv2 0.5 (B=2, 64×64): the loss to
    rtol 1e-5 against the JAX package's ``value_and_grad`` in float64, every
    gradient to 1e-4 × its tensor's max |g|, or × 1e-2 of the largest
    gradient of the step where that is more, against the same function
    computed in float64 (attention, ``LayerNorm2D`` and train-mode
    BatchNorm on 2×2 maps included).  float32 rounds the backward to
    ~1e-7 of the largest gradient in every tensor, so the floor holds
    the small ones: eight shifts (BatchNorm and LayerNorm biases whose
    output the next normalisation centres again) have a gradient of 0,
    and the FFNs' last biases ~1e-3 of the largest; an error in the
    function moves a gradient by its own size."""
    name = "pose_mobilevitv2_pixel_shuffle"
    jmodel, variables, model, cfg = nets[name]
    batch = _gaussian_batch(cfg)
    loss_fn = jax_loss.make_loss_fn(mobile_cfg(jax_default_config, name))

    def value_and_grad(dtype):
        jm = jmodel.clone(dtype=dtype)
        vs = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype),
                                    variables)

        def loss_of(params):
            out, _ = jm.apply(
                {"params": params, "batch_stats": vs["batch_stats"]},
                jnp.asarray(batch["image"], dtype), train=True,
                mutable=["batch_stats"])
            return loss_fn(out.transpose(0, 3, 1, 2).astype(jnp.float32),
                           jnp.asarray(batch["target"]),
                           jnp.asarray(batch["target_weight"]))

        (jl, _), grads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(
            vs["params"])
        return float(jl), jax.tree_util.tree_map(np.asarray, grads)

    with jax.enable_x64(True):
        jl, grads64 = value_and_grad(jnp.float64)
    want = variables_to_state_dict(
        {"params": grads64, "batch_stats": variables["batch_stats"]}, cfg)
    fresh = build_model(cfg, device="cpu", train=True)
    fresh.load_state_dict(model.state_dict())
    state = create_train_state(cfg, fresh, steps_per_epoch=10)
    metrics = make_train_step(loss.make_loss_fn(cfg))(state, {
        k: torch.from_numpy(b) for k, b in batch.items()})
    np.testing.assert_allclose(float(metrics["loss"]), jl, rtol=1e-5)
    named = dict(state.model.named_parameters())
    assert len(named) > 100 and set(named) <= set(want)
    gmax = max(float(np.abs(want[k]).max()) for k in named)
    zero = 0
    for k, p in named.items():
        assert want[k].dtype == np.float64
        scale = float(np.abs(want[k]).max())
        zero += scale < 1e-12 * gmax
        np.testing.assert_allclose(p.grad.numpy(), want[k], rtol=0,
                                   atol=1e-4 * max(scale, 1e-2 * gmax),
                                   err_msg=k)
    assert zero == 8
