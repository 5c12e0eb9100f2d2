"""The port's SimpleBaseline, PSA and PSA-HRNet against the JAX package,
on the CPU.

Seeded reference-format weights go into the JAX package through its
forward bridge (no flax init), come back through the port's
``variables_to_state_dict`` and load with ``strict=True``; the same
numpy-seeded inputs run through both in float32 (atol 1e-4, the
summation-order difference of the convs, as in ``test_torch_hrnet``).
Reduced nets: ResNet-18 and -50 at 64×64 with 32-wide deconvolutions,
the reduced HRNet of ``test_torch_hrnet`` with PSA.  Also the deconv
head's geometry for kernels 4, 3 and 2, the parameter counts of
full-width ``pose_resnet50`` (from ``jax.eval_shape``), the int8 sites,
a bf16 drift case, and every yaml of ``configs/`` through the registry.
"""

from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_hrnet import REDUCED_EXTRA
from test_torch_quantize import _flax_pose_paths, _nchw
from test_torch_yolov5 import few_threads  # noqa: F401 (autouse)
from udp_pose_tpu.config import default_config as jax_default_config
from udp_pose_tpu.core.infer import make_infer_fn as jax_make_infer_fn
from udp_pose_tpu.models import build_model as jax_build_model
from udp_pose_tpu.models import layers as jax_layers
from udp_pose_tpu.models import psa as jax_psa
from udp_pose_tpu.models import quantize as jq
from udp_pose_tpu.utils.torch_convert import (flax_to_torch_from_cfg,
                                              torch_to_flax_from_cfg)
from udp_pose_tpu_torch.config import default_config, load_config
from udp_pose_tpu_torch.core.infer import make_infer_fn
from udp_pose_tpu_torch.models import MODELS, build_model
from udp_pose_tpu_torch.models import quantize as tq
from udp_pose_tpu_torch.models.layers import DeconvHead
from udp_pose_tpu_torch.models.psa import PSA_p, PSA_s
from udp_pose_tpu_torch.models.resnet import PoseResNet
from udp_pose_tpu_torch.utils.convert import (Converter, _convert_psa,
                                              conv_sites, state_dict_to_torch,
                                              variables_to_state_dict)

REPO = Path(__file__).resolve().parents[1]
ATOL = 1e-4
HW = 64                   # input side of the reduced nets


def np_variables(module, x_shape, seed=0, **call_kw):
    """Seeded numpy flax variables of ``module`` from the shapes of its
    init (kernels normal / sqrt(fan_in), biases small, norm scales and
    running variances in [0.5, 1.5])."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda r: module.init(
        r, jnp.zeros(x_shape), **call_kw), jax.random.PRNGKey(0))

    def make(path, leaf):
        name = path[-1].key
        if name == "kernel":
            v = rng.normal(0, 1 / np.sqrt(np.prod(leaf.shape[:-1])),
                           leaf.shape)
        elif name in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, leaf.shape)
        else:
            v = rng.normal(0, 0.1, leaf.shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(make, shapes)


def zoo_cfg(default_config_fn, name, target_type="gaussian", layers=18,
            kernels=(4, 4, 4), final=1, dtype="float32", filters=32):
    """A reduced ``name`` config (64×64 input, 16×16 maps) from either
    package's defaults: ResNet-``layers`` with ``filters``-wide
    deconvolutions of ``kernels``, or the reduced HRNet of
    ``test_torch_hrnet``."""
    cfg = default_config_fn()
    cfg.MODEL.NAME = name
    cfg.MODEL.TARGET_TYPE = target_type
    cfg.MODEL.IMAGE_SIZE = [HW, HW]
    cfg.MODEL.HEATMAP_SIZE = [HW // 4, HW // 4]
    cfg.TPU.DTYPE = dtype
    if name.startswith("pose_resnet"):
        cfg.MODEL.EXTRA.merge_from_dict({
            "NUM_LAYERS": layers, "NUM_DECONV_LAYERS": 3,
            "NUM_DECONV_FILTERS": [filters] * 3,
            "NUM_DECONV_KERNELS": list(kernels),
            "DECONV_WITH_BIAS": False, "FINAL_CONV_KERNEL": final})
    else:
        cfg.MODEL.EXTRA.merge_from_dict(dict(REDUCED_EXTRA,
                                             FINAL_CONV_KERNEL=final))
    return cfg


def seeded_state_dict(model, seed):
    """``model``'s state dict with seeded numpy values: kernels normal /
    sqrt(fan_in), biases and running means small, norm scales and running
    variances in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)
    mods = dict(model.named_modules())
    out = {}
    for key, t in model.state_dict().items():
        mod, _, leaf = key.rpartition(".")
        m = mods[mod]
        if leaf == "num_batches_tracked":
            v = np.zeros((), np.int64)
        elif leaf == "weight" and isinstance(m, torch.nn.ConvTranspose2d):
            v = rng.normal(0, 1 / np.sqrt(t[:, 0].numel()), t.shape)
        elif leaf == "weight" and isinstance(m, torch.nn.Conv2d):
            v = rng.normal(0, 1 / np.sqrt(t[0].numel()), t.shape)
        elif leaf in ("weight", "running_var"):
            v = rng.uniform(0.5, 1.5, t.shape)
        else:
            v = rng.normal(0, 0.1, t.shape)
        out[key] = v.astype(np.int64 if leaf == "num_batches_tracked"
                            else np.float32)
    return out


def bridged(name, seed=0, **kw):
    """(jax model, numpy flax variables, port model on the CPU with the
    same weights, port cfg).  The variables come from seeded reference
    weights through the JAX package's forward bridge (no flax init), and
    reach the port through its own reverse bridge."""
    jcfg = zoo_cfg(jax_default_config, name, **kw)
    cfg = zoo_cfg(default_config, name, **kw)
    model = build_model(cfg, device="cpu")
    v, unused = torch_to_flax_from_cfg(seeded_state_dict(model, seed), jcfg)
    assert not unused
    res = model.load_state_dict(
        state_dict_to_torch(variables_to_state_dict(v, cfg)), strict=True)
    assert not res.missing_keys and not res.unexpected_keys
    return jax_build_model(jcfg), v, model, cfg


NETS = {  # name: (registry name, options)
    "resnet18_gaussian_k4_f1": ("pose_resnet", {}),
    "resnet50_offset_k2_f3": ("pose_resnet", dict(
        layers=50, target_type="offset", kernels=(2, 2, 2), final=3)),
    "resnet18_psa_offset": ("pose_resnet_psa", dict(target_type="offset")),
    "hrnet_psa_offset": ("pose_hrnet_psa", dict(target_type="offset")),
}


@pytest.fixture(scope="module")
def nets():
    """Each of ``NETS`` bridged once, shared by the tests below."""
    return {k: bridged(name, seed=i, **kw)
            for i, (k, (name, kw)) in enumerate(NETS.items())}


def _x(seed, shape=(2, HW, HW, 3)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("key", list(NETS))
def test_fp32_output_matches_jax(nets, key):
    """Bridged weights load ``strict=True``, equal the JAX package's own
    reverse bridge key for key, and give the JAX output (NCHW float32)."""
    jmodel, v, model, cfg = nets[key]
    sd = variables_to_state_dict(v, cfg)
    gold = flax_to_torch_from_cfg(v, zoo_cfg(jax_default_config,
                                             cfg.MODEL.NAME, **NETS[key][1]))
    assert sorted(sd) == sorted(gold) == sorted(model.state_dict())
    for k in gold:
        np.testing.assert_array_equal(sd[k], np.asarray(gold[k]), err_msg=k)
    x = _x(1)
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        v, jnp.asarray(x)))
    with torch.inference_mode():
        out = model(_nchw(x))
    J = cfg.MODEL.NUM_JOINTS * (3 if cfg.MODEL.TARGET_TYPE == "offset"
                                else 1)
    assert out.dtype == torch.float32 and out.shape == (2, J, 16, 16)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), want,
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("k", [4, 3, 2])
def test_deconv_head_geometry_matches_jax(k):
    """One deconv layer (ConvTranspose stride 2 + BN + ReLU) on bridged
    weights.  Kernels 4 and 2: the JAX head's output.  Kernel 3: the
    reference torch geometry (padding 1, output padding 1), which the
    flax head's "SAME" padding places one pixel later: the port's output
    at (i, j) is the JAX output at (i + 1, j + 1)."""
    jhead = jax_layers.DeconvHead((8,), (k,))
    x = _x(2, (2, 5, 6, 4))
    v = np_variables(jhead, x.shape, seed=k, train=False)
    cv = Converter(v)
    cv.conv("0", "deconv0", transposed=True)
    cv.bn("1", "bn0")
    head = DeconvHead(4, (8,), (k,))
    head.load_state_dict(state_dict_to_torch(cv.sd), strict=True)
    head.eval()
    want = np.asarray(jhead.apply(v, jnp.asarray(x), train=False))
    with torch.inference_mode():
        got = head(_nchw(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 10, 12, 8)
    if k == 3:
        np.testing.assert_allclose(got[:, :-1, :-1], want[:, 1:, 1:],
                                   atol=ATOL, rtol=0)
        assert np.abs(got - want).max() > 0.1
    else:
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("variant", ["PSA_s", "PSA_p"])
def test_psa_matches_jax(variant):
    """``PSA_s`` and ``PSA_p`` alone on bridged weights (16 channels,
    7×5 maps), fp32."""
    planes = 16
    jmod = getattr(jax_psa, variant)(planes)
    x = _x(3, (2, 7, 5, planes))
    v = np_variables(jmod, x.shape, seed=4)
    cv = Converter({"params": {"m": v["params"]}})
    if variant == "PSA_s":
        _convert_psa(cv, "m", "m")
        mod = PSA_s(planes)
    else:
        for name in ("conv_q_right", "conv_v_right", "conv_up",
                     "conv_q_left", "conv_v_left"):
            cv.conv(f"m.{name}", "m", name)
        mod = PSA_p(planes)
    mod.load_state_dict(state_dict_to_torch(
        {k[2:]: w for k, w in cv.sd.items()}), strict=True)
    want = np.asarray(jax.jit(jmod.apply)(v, jnp.asarray(x)))
    with torch.inference_mode():
        got = mod(_nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def _fit_final_layer(model, v, crops, joints, pairs):
    """Set the final 1×1 conv of ``model`` and of the flax variables ``v``
    to the least-squares fit of Gaussian targets at ``joints`` on the
    deconv features of ``crops`` and of their mirror images: heatmaps that
    peak near the joints, as trained ones do, where a random head's are
    flat noise whose near-tied maxima any rounding moves."""
    from udp_pose_tpu_torch.core.infer import normalize_images
    from udp_pose_tpu_torch.ops.flip import fliplr_joints_np
    from udp_pose_tpu_torch.ops.targets import gaussian_targets_np
    x = normalize_images(torch.as_tensor(crops)).permute(0, 3, 1, 2)
    with torch.inference_mode():
        feats = [model.deconv_layers(model.layer4(model.layer3(
            model.layer2(model.layer1(model.maxpool(torch.relu(
                model.bn1(model.conv1(im))))))))) for im in (x, x.flip(3))]
    F = torch.cat(feats).permute(0, 2, 3, 1).double().numpy()
    C = F.shape[-1]
    targets = []
    for flip in (False, True):
        for j in joints:
            j3 = np.concatenate([j, np.zeros((len(j), 1), np.float32)], 1)
            if flip:
                j3, _ = fliplr_joints_np(j3, np.ones_like(j3), HW, pairs)
            targets.append(gaussian_targets_np(
                j3, np.ones_like(j3), (HW // 4,) * 2, (HW,) * 2, 2)[0])
    A = np.concatenate([F, np.ones(F.shape[:-1] + (1,))], -1)
    Y = np.stack(targets).transpose(0, 2, 3, 1)
    W = np.linalg.lstsq(A.reshape(-1, C + 1), Y.reshape(-1, Y.shape[-1]),
                        rcond=None)[0].astype(np.float32)
    with torch.no_grad():
        model.final_layer.weight.copy_(torch.from_numpy(
            np.ascontiguousarray(W[:C].T))[:, :, None, None])
        model.final_layer.bias.copy_(torch.from_numpy(W[C]))
    v["params"]["final_layer"] = {"kernel": W[None, None, :C],
                                  "bias": W[C]}


def test_bf16_drift_against_jax_fp32():
    """The port's ResNet-18 (256-wide deconvolutions, the head fitted to
    peak at known joints) serving in bf16 against the JAX package's in
    fp32 on the same weights, decoded with the flip test: keypoints
    within the bf16 bounds of ``tests/test_quantize.py`` (median < 0.5
    px, 95% < 2 px, confidence < 0.1)."""
    from udp_pose_tpu_torch.core.infer import COCO_FLIP_PAIRS
    jmodel, v, model, _ = bridged("pose_resnet", seed=8, filters=256)
    rng = np.random.default_rng(6)
    crops = rng.integers(0, 256, (2, HW, HW, 3), dtype=np.uint8)
    joints = rng.uniform(8, HW - 8, (2, 17, 2)).astype(np.float32)
    _fit_final_layer(model, v, crops, joints, COCO_FLIP_PAIRS)
    bf16 = build_model(zoo_cfg(default_config, "pose_resnet", filters=256,
                               dtype="bfloat16"), device="cpu")
    bf16.load_state_dict(model.state_dict(), strict=True)
    center = np.tile(np.float32([[HW / 2, HW / 2]]), (2, 1))
    scale = np.tile(np.float32([[HW / 200, HW / 200]]), (2, 1))
    p_j, m_j, _ = jax_make_infer_fn(jmodel, target_type="gaussian",
                                    flip_test=True)(v, crops, center, scale)
    p_j = np.asarray(p_j)
    # the regime where drift means something: peaks near the joints
    # (within 1.5 heatmap pixels, median)
    assert np.median(np.linalg.norm(p_j - joints, axis=-1)) < 6.0
    p_t, m_t, _ = make_infer_fn(bf16, target_type="gaussian",
                                flip_test=True)(crops, center, scale)
    d = np.abs(p_t.numpy() - p_j)
    assert np.median(d) < 0.5, np.median(d)
    assert (d < 2.0).mean() > 0.95, np.percentile(d, 95)
    assert np.abs(m_t.numpy() - np.asarray(m_j)).max() < 0.1


@pytest.mark.parametrize("target_type,want", [("gaussian", 34.0e6),
                                              ("offset", 34.2e6)])
def test_pose_resnet50_parameter_count_equals_jax(target_type, want):
    """Full-width ``pose_resnet50`` (256×192): the port's parameters equal
    the JAX package's in number, from ``jax.eval_shape`` (no init), and
    are 34.0 M (gaussian) or 34.2 M (offset) as ``MODELS.md`` says."""
    jcfg = jax_default_config()
    jcfg.MODEL.NAME = "pose_resnet"
    jcfg.MODEL.TARGET_TYPE = target_type
    jcfg.MODEL.EXTRA.merge_from_dict({
        "NUM_LAYERS": 50, "NUM_DECONV_FILTERS": [256, 256, 256],
        "NUM_DECONV_KERNELS": [4, 4, 4], "DECONV_WITH_BIAS": False,
        "FINAL_CONV_KERNEL": 1})
    shapes = jax.eval_shape(lambda r: jax_build_model(jcfg).init(
        r, jnp.zeros((1, 256, 192, 3)), train=False), jax.random.PRNGKey(0))
    n_jax = sum(int(np.prod(p.shape))
                for p in jax.tree_util.tree_leaves(shapes["params"]))
    with torch.device("meta"):
        model = PoseResNet(50, target_type=target_type)
    n = sum(p.numel() for p in model.parameters())
    assert n == n_jax
    assert abs(n - want) / want < 0.01, n


@pytest.mark.parametrize("key", ["resnet50_offset_k2_f3",
                                 "resnet18_psa_offset", "hrnet_psa_offset"])
def test_conv_sites_are_the_flax_paths(nets, key):
    """Every Conv2d of the port's model has a site; the sites are the
    flax modules holding a (non-transposed) conv kernel; the PSA convs are
    the ones ``DEFAULT_SKIP`` keeps in float."""
    _, v, model, _ = nets[key]
    sites = conv_sites(model)
    assert set(sites) == {n for n, m in model.named_modules()
                          if isinstance(m, torch.nn.Conv2d)}
    flax = [p for p in _flax_pose_paths(v["params"])
            if not p.startswith("deconv/")]
    assert sorted(sites.values()) == sorted(flax)
    psa = {p for p in sites.values() if "/deattn/" in p}
    assert bool(psa) == ("psa" in key)
    assert not {p for p in psa if not tq._matches(p, tq.DEFAULT_SKIP)}


def test_int8_sites_equal_jax(nets):
    """int8 PTQ of the reduced ResNet-50 (its 7×7 stem, 1×1 convs of up
    to 2048 channels, the stride-2 3×3 and 1×1 downsample convs) on the
    JAX package's calibration table: the same engaged sites (the
    transposed convs and ``final_layer`` in float), and every int8 site,
    fed the input it gets inside the JAX ``QuantizedModel``, gives the
    JAX output bit for bit."""
    jmodel, v, model, _ = nets["resnet50_offset_k2_f3"]
    x = _x(7)
    table = jq.calibrate(jmodel, v, [jnp.asarray(x)])
    jqm = jq.QuantizedModel(jmodel, table)
    # the int8 weights that ``prepare_variables`` makes, in numpy with a
    # true division (``quantize_kernel``'s eager math; under jit XLA turns
    # the division into a multiply, one ulp off for some scales); the
    # apply below reads them
    quant = {}
    for path in table:
        if not jq._matches(path, jq.DEFAULT_SKIP):
            node = v["params"]
            for part in path.split("/"):
                node = node[part]
            k = node["kernel"]
            s_w = np.maximum(np.abs(k).max(axis=(0, 1, 2)) / np.float32(127),
                             np.float32(1e-12))
            w_i8 = np.clip(np.round(k / s_w), -127, 127).astype(np.int8)
            leaf = quant
            for part in path.split("/"):
                leaf = leaf.setdefault(part, {})
            leaf.update(kernel_i8=w_i8, scale=s_w)

    @jax.jit
    def sites_io(variables, x):
        """Each int8 site's input and output in one apply of ``jqm``
        (its own interceptor)."""
        seen = {}

        def record(next_fun, args, kwargs, context):
            y = jqm._interceptor(next_fun, args, kwargs, context)
            path = jq._path_of(context.module)
            if path in jqm.engaged and path not in seen:
                seen[path] = (args[0], y)
            return y

        with fnn.intercept_methods(record):
            jmodel.apply(variables, x, train=False)
        return seen

    seen = jax.tree_util.tree_map(np.asarray, sites_io(
        {**v, "quant": quant}, jnp.asarray(x)))
    qm = tq.QuantizedModel(model, table)
    assert qm.engaged == jqm.engaged == set(seen)
    assert len(qm.engaged) == len(conv_sites(model)) - 1
    assert all(type(m) is torch.nn.ConvTranspose2d
               for m in qm.net.deconv_layers if isinstance(
                   m, torch.nn.modules.conv._ConvNd))
    names = {p: n for n, p in conv_sites(model).items()}
    for path, (site_in, site_out) in seen.items():
        with torch.inference_mode():
            got = qm.net.get_submodule(names[path])(_nchw(site_in))
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                      site_out, err_msg=path)


YAMLS = sorted(str(p.relative_to(REPO)) for p in REPO.glob("configs/*/*.yaml"))


def test_yaml_census():
    """28 yamls, every one of a ported family: 5 of them RSN, 5 of the
    mobile families."""
    names = [load_config(REPO / y).MODEL.NAME for y in YAMLS]
    assert len(YAMLS) == 28
    assert sum(n in MODELS for n in names) == 28
    assert names.count("rsn") == 5
    assert sum(n.startswith(("pose_shufflenetv2", "pose_mobile"))
               for n in names) == 5


@pytest.mark.parametrize("yaml", YAMLS)
def test_every_yaml_builds_or_names_the_registry(yaml):
    """Each yaml of ``configs/`` through the registry: every one builds
    (output channels per its head) and has conv sites.  Full width, so
    the models are built on the meta device (no weights drawn).  A name
    that is not registered raises ``KeyError`` listing what is."""
    cfg = load_config(REPO / yaml)
    name = cfg.MODEL.NAME
    assert name in MODELS
    unknown = cfg.clone()
    unknown.MODEL.NAME = "pose_" + name + "_unregistered"
    with pytest.raises(KeyError, match="pose_mobilevitv2_pixel_shuffle"):
        build_model(unknown, device="cpu")
    with torch.device("meta"):
        model = MODELS[name](cfg)
    J = cfg.MODEL.NUM_JOINTS * (3 if cfg.MODEL.TARGET_TYPE == "offset"
                                else 1)
    if name == "rsn":           # the heads: each upsample unit's res_conv2
        last = cfg.MODEL.EXTRA.get("STAGE_NUM", 1) - 1
        head = model.get_submodule(f"stage{last}.upsample.up4.res_conv2")
        assert head.conv.out_channels == J
    else:
        assert model.final_layer.out_channels == J
    assert conv_sites(model)


@pytest.mark.parametrize("key", ["resnet18_psa_offset", "hrnet_psa_offset"])
def test_qat_engages_the_jax_sites_and_trains(nets, key):
    """``TPU.QAT int8``: the port's ``FakeQuantModel`` fake-quantises the
    sites the JAX package's does (traced with ``jax.eval_shape``: the
    transposed convs, the PSA convs and ``final_layer`` stay in float),
    and one QAT train step moves every parameter the float model trains,
    the PSA ones included."""
    from udp_pose_tpu_torch.core.loss import make_loss_fn
    from udp_pose_tpu_torch.core.train import (create_train_state,
                                               make_train_step)
    jmodel, v, model, cfg = nets[key]
    jfq = jq.FakeQuantModel(jmodel)
    jax.eval_shape(lambda v, x: jfq.apply(v, x, train=False), v,
                   jnp.zeros((1, HW, HW, 3)))
    fq = tq.FakeQuantModel(model)
    assert fq.engaged == jfq.engaged
    assert not any("deattn" in p or p.startswith("deconv")
                   or p == "final_layer" for p in fq.engaged)
    cfg = cfg.clone()
    cfg.TPU.QAT = "int8"
    train_model = build_model(cfg, device="cpu", train=True)
    train_model.load_state_dict(model.state_dict(), strict=True)
    state = create_train_state(cfg, train_model, steps_per_epoch=1)
    assert isinstance(state.model, tq.FakeQuantModel)
    before = {k: p.detach().clone()
              for k, p in train_model.named_parameters()}
    C, H = (cfg.MODEL.NUM_JOINTS * (3 if cfg.MODEL.TARGET_TYPE == "offset"
                                    else 1), HW // 4)
    rng = np.random.default_rng(10)
    metrics = make_train_step(make_loss_fn(cfg))(state, {
        "image": torch.from_numpy(_x(11)),
        "target": torch.from_numpy(rng.random((2, C, H, H), np.float32)),
        "target_weight": torch.ones(2, cfg.MODEL.NUM_JOINTS, 1)})
    assert np.isfinite(float(metrics["loss"]))
    moved = {k for k, p in train_model.named_parameters()
             if not torch.equal(p, before[k])}
    assert moved == set(before)
