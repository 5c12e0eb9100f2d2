"""The port's RSN against the JAX package, on the CPU: the model, its
resize, targets, datasets, decode, losses and int8 sites.

Seeded reference-format weights go into the JAX package through its
forward bridge (no flax init) and come back through the port's
``variables_to_state_dict``, loaded with ``strict=True``.  Reduced nets:
``LAYERS [1, 1, 1, 1]``, upsample width 32, 64×48 input, one or two
stages; base RSN, two stages, the plain Res18 bottleneck, SE with the
conv stem, and PRM.  Float32 outputs of every stage and scale are held
at atol 1e-4 × the output's max (the convs' summation order).
"""

import os

import jax
import jax.numpy as jnp
import flax.linen as fnn
import numpy as np
import pytest
import torch

from ref_harness import make_mini_coco
from test_torch_mpii import make_mini_mpii
from test_torch_quantize import _nchw
from test_torch_yolov5 import few_threads  # noqa: F401 (autouse)
from test_torch_zoo import seeded_state_dict
from udp_pose_tpu.config import default_config as jax_default_config
from udp_pose_tpu.core import loss as jax_loss
from udp_pose_tpu.data import build_dataset as jax_build_dataset
from udp_pose_tpu.models import build_model as jax_build_model
from udp_pose_tpu.models import quantize as jq
from udp_pose_tpu.models import rsn as jax_rsn
from udp_pose_tpu.ops import blur as jax_blur
from udp_pose_tpu.ops import rsn_decode as jax_decode
from udp_pose_tpu.ops import targets as jax_targets
from udp_pose_tpu.utils.torch_convert import torch_to_flax_from_cfg
from udp_pose_tpu_torch.config import default_config
from udp_pose_tpu_torch.core import loss
from udp_pose_tpu_torch.data import build_dataset
from udp_pose_tpu_torch.data.rsn import RSNCOCODataset, RSNMPIIDataset
from udp_pose_tpu_torch.models import build_model
from udp_pose_tpu_torch.models import quantize as tq
from udp_pose_tpu_torch.models.rsn import RSN, resize_bilinear_ac
from udp_pose_tpu_torch.ops import blur, rsn_decode
from udp_pose_tpu_torch.ops.targets import rsn_targets_np
from udp_pose_tpu_torch.utils.convert import (conv_sites, state_dict_to_torch,
                                              variables_to_state_dict)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-4                 # × each output's max |value|
H, W = 64, 48               # input of the reduced nets
HM = (16, 12)               # their heatmaps (h, w)


def rsn_cfg(default_config_fn, **extra):
    """A reduced RSN config from either package's defaults."""
    cfg = default_config_fn()
    cfg.MODEL.NAME = "rsn"
    cfg.MODEL.IMAGE_SIZE = [W, H]
    cfg.MODEL.HEATMAP_SIZE = [HM[1], HM[0]]
    cfg.TPU.DTYPE = "float32"
    cfg.DATASET.DATASET = "coco"
    cfg.MODEL.EXTRA.merge_from_dict(dict(
        {"STAGE_NUM": 1, "UPSAMPLE_CHANNEL_NUM": 32,
         "LAYERS": [1, 1, 1, 1]}, **extra))
    return cfg


def bridged_rsn(seed=0, **extra):
    """(jax model, numpy flax variables, port model on the CPU with the
    same weights, port cfg)."""
    jcfg, cfg = rsn_cfg(jax_default_config, **extra), rsn_cfg(default_config,
                                                               **extra)
    model = build_model(cfg, device="cpu")
    v, unused = torch_to_flax_from_cfg(seeded_state_dict(model, seed), jcfg)
    assert not unused
    res = model.load_state_dict(
        state_dict_to_torch(variables_to_state_dict(v, cfg)), strict=True)
    assert not res.missing_keys and not res.unexpected_keys
    return jax_build_model(jcfg), v, model, cfg


VARIANTS = {
    "base": {},
    "two_stage": {"STAGE_NUM": 2},
    "plain_res18": {"PLAIN_BOTTLENECK": True},
    "se_conv_stem": {"USE_SE": True},
    "prm": {"USE_PRM": True},
}


@pytest.fixture(scope="module")
def nets():
    return {k: bridged_rsn(seed=i, **extra)
            for i, (k, extra) in enumerate(VARIANTS.items())}


def _x(seed, B=2):
    return np.random.default_rng(seed).normal(
        size=(B, H, W, 3)).astype(np.float32)


@pytest.mark.parametrize("key", list(VARIANTS))
def test_fp32_outputs_equal_jax(nets, key):
    """Every stage's four heatmaps (``all_stages``) and the eval output,
    from weights bridged ``strict=True``, against the JAX package."""
    jmodel, v, model, cfg = nets[key]
    x = _x(1)
    want = jax.jit(lambda v, x: jmodel.apply(v, x, train=False,
                                             all_stages=True))(v, x)
    with torch.no_grad():
        got = model(_nchw(x), all_stages=True)
        final = model(_nchw(x))
    assert len(got) == len(want) == cfg.MODEL.EXTRA.STAGE_NUM
    for s, (g_stage, w_stage) in enumerate(zip(got, want)):
        assert len(g_stage) == len(w_stage) == 4
        for j, (g, w) in enumerate(zip(g_stage, w_stage)):
            w = np.asarray(w).transpose(0, 3, 1, 2)
            assert g.shape == w.shape == (2, 17) + HM
            np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                       atol=ATOL * np.abs(w).max(),
                                       err_msg=f"stage {s} unit {j}")
    assert torch.equal(final, got[-1][-1])
    if key == "se_conv_stem":
        assert model.top.conv_stem and model.stage0.downsample.layer1[0].se
    if key == "prm":
        assert model.stage0.upsample.up4.prm is not None


@pytest.mark.parametrize("hw,out", [((2, 2), (4, 3)), ((8, 6), (64, 48)),
                                    ((5, 7), (5, 7)), ((1, 3), (4, 1)),
                                    ((16, 12), (9, 13))])
def test_resize_bilinear_ac_equals_jax(hw, out):
    x = np.random.default_rng(3).normal(size=(2,) + hw + (5,)).astype(
        np.float32)
    want = np.asarray(jax_rsn.resize_bilinear_ac(jnp.asarray(x), out))
    got = resize_bilinear_ac(_nchw(x), out).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if min(hw + out) > 1:   # align corners: the corner pixels are kept
        np.testing.assert_array_equal(got[:, [0, -1]][:, :, [0, -1]],
                                      x[:, [0, -1]][:, :, [0, -1]])


@pytest.mark.parametrize("kernels", [(15, 11, 9, 7, 5), (5, 11)])
def test_rsn_targets_np_bit_equal(kernels):
    rng = np.random.default_rng(4)
    joints = np.concatenate([rng.uniform(-5, W + 5, (17, 1)),
                             rng.uniform(-5, H + 5, (17, 1))], 1)
    valid = rng.choice([0.0, 1.0, 2.0], (17, 1))
    want = jax_targets.rsn_targets_np(joints, valid, (HM[1], HM[0]), (W, H),
                                      kernels)
    got = rsn_targets_np(joints, valid, (HM[1], HM[0]), (W, H), kernels)
    assert got.dtype == np.float32 and got.shape == (len(kernels), 17) + HM
    np.testing.assert_array_equal(got, want)
    assert got.max() == pytest.approx(255.0, rel=0.2)


# --------------------------------------------------------------- datasets
@pytest.fixture(scope="module")
def rsn_data(tmp_path_factory):
    coco = tmp_path_factory.mktemp("rsn_coco")
    make_mini_coco(str(coco), image_set="train2017", n_images=6, seed=21)
    make_mini_coco(str(coco), image_set="val2017", n_images=4, seed=22)
    mpii = tmp_path_factory.mktemp("rsn_mpii")
    make_mini_mpii(mpii, seed=5)
    return {"coco": str(coco), "mpii": str(mpii)}


def data_cfg(default_config_fn, rsn_data, dataset):
    cfg = rsn_cfg(default_config_fn)
    cfg.DATASET.DATASET = dataset
    cfg.DATASET.ROOT = rsn_data[dataset]
    if dataset == "coco":
        cfg.DATASET.TRAIN_SET, cfg.DATASET.TEST_SET = "train2017", "val2017"
        cfg.TEST.USE_GT_BBOX = True
    else:
        cfg.DATASET.TRAIN_SET, cfg.DATASET.TEST_SET = "train", "valid"
        cfg.MODEL.NUM_JOINTS = 16
    return cfg


@pytest.mark.parametrize("dataset,is_train", [
    ("coco", True), ("coco", False), ("mpii", True), ("mpii", False)])
def test_samples_bit_equal_jax(rsn_data, dataset, is_train):
    """RSN samples of the same db, seed and index in both packages: the
    image, the five-kernel labels and the visibility in training, the
    center, scale and score, bit for bit."""
    ours = build_dataset(data_cfg(default_config, rsn_data, dataset),
                         is_train=is_train)
    theirs = jax_build_dataset(data_cfg(jax_default_config, rsn_data,
                                        dataset), is_train=is_train)
    cls = RSNCOCODataset if dataset == "coco" else RSNMPIIDataset
    assert type(ours) is cls and len(ours) == len(theirs) > 4
    keys = ["image", "center", "scale", "score"]
    if is_train:
        keys += ["labels", "valid"]
    for seed in (0, 1):
        ours.seed(seed)
        theirs.seed(seed)
        for i in range(len(ours)):
            a, b = ours[i], theirs[i]
            assert sorted(a) == sorted(b), i
            assert a["image_path"] == b["image_path"]
            for k in keys:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{k} {i}")
    if is_train:
        J = ours.num_joints
        assert a["labels"].shape == (5, J) + HM
        assert a["valid"].shape == (J, 1)


def test_rsn_coco_evaluate_equals_jax(rsn_data, tmp_path):
    """RSN's COCO results protocol (score = box score × mean maxval, no
    OKS-NMS) gives the JAX package's AP table on the same preds."""
    ours = build_dataset(data_cfg(default_config, rsn_data, "coco"))
    theirs = jax_build_dataset(data_cfg(jax_default_config, rsn_data,
                                        "coco"))
    n, J = len(ours), ours.num_joints
    rng = np.random.default_rng(6)
    preds = np.zeros((n, J, 3), np.float32)
    for i, rec in enumerate(ours.db):
        preds[i, :, :2] = rec["joints_3d"][:, :2] + rng.normal(0, 2, (J, 2))
        preds[i, :, 2] = rng.uniform(0.2, 1.0, J)
    boxes = np.zeros((n, 6))
    boxes[:, 5] = rng.uniform(0.5, 1.0, n)
    paths = [rec["image"] for rec in ours.db]
    got = ours.evaluate(ours.cfg, preds, str(tmp_path / "a"), boxes, paths)
    want = theirs.evaluate(theirs.cfg, preds, str(tmp_path / "b"), boxes,
                           paths)
    assert got[0] == pytest.approx(want[0], abs=1e-9)
    assert got[1] == pytest.approx(want[1], abs=1e-9) and got[1] > 0.1


# ----------------------------------------------------------------- decode
def decode_maps(seed, B=3, J=4):
    """Noise plus a Gaussian peak a map, and two maps of the last sample
    made special: a flat map, and a map of two equal one-pixel peaks (a
    tie, exact in either blur: one term a sum)."""
    rng = np.random.default_rng(seed)
    h, w = 64, 48
    maps = rng.uniform(0, 30, (B, J, h, w)).astype(np.float32)
    ys, xs = np.mgrid[0:h, 0:w]
    for b in range(B):
        for j in range(J):
            cy, cx = rng.uniform(4, h - 4), rng.uniform(4, w - 4)
            maps[b, j] += (255 * np.exp(-((xs - cx) ** 2 + (ys - cy) ** 2)
                                        / (2 * 2.0 ** 2))).astype(np.float32)
    maps[-1, 0] = 0.0
    maps[-1, 1] = 0.0
    maps[-1, 1, 20, 30] = maps[-1, 1, 40, 10] = 255.0
    centers = rng.uniform(100, 400, (B, 2)).astype(np.float32)
    scales = rng.uniform(0.5, 2.0, (B, 2)).astype(np.float32)
    return maps, centers, scales


@pytest.mark.parametrize("kernel", [5, 9])
@pytest.mark.parametrize("shifts", [(0.25,), (0.25, 0.125)])
def test_rsn_decode_equals_jax(kernel, shifts):
    """The same argmax pixels of the blurred bordered maps, keypoints
    within 1e-4 px and scores within 1e-6, a tie and a flat map among
    the maps."""
    maps, centers, scales = decode_maps(8 + kernel)
    jmaps = jnp.asarray(maps)
    padded = jnp.pad(jmaps, ((0, 0), (0, 0), (10, 10), (10, 10)))
    want_yx = [np.asarray(a) for a in jax_decode._argmax2d(
        jax_blur.gaussian_blur(padded, kernel))]
    got_yx = rsn_decode._argmax2d(blur.gaussian_blur(
        torch.nn.functional.pad(torch.from_numpy(maps), (10,) * 4), kernel))
    for g, w in zip(got_yx, want_yx):
        np.testing.assert_array_equal(g.numpy(), w)
    assert (got_yx[0][-1, 1], got_yx[1][-1, 1]) == (30, 40)   # first peak
    want_p, want_s = jax_decode.rsn_decode(jmaps, centers, scales,
                                           kernel=kernel, shifts=shifts)
    got_p, got_s = rsn_decode.rsn_decode(torch.from_numpy(maps), centers,
                                         scales, kernel=kernel,
                                         shifts=shifts)
    assert got_p.shape == (3, 4, 2) and got_s.shape == (3, 4, 1)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=0,
                               atol=1e-6)


# ------------------------------------------------------------------ loss
def loss_inputs(seed, stages=2, B=3, J=17):
    rng = np.random.default_rng(seed)
    outputs = [[rng.normal(0, 60, (B, J) + HM).astype(np.float32)
                for _ in range(4)] for _ in range(stages)]
    labels = rng.uniform(0, 255, (B, 5, J) + HM).astype(np.float32)
    valid = rng.choice([0.0, 1.0, 2.0], (B, J, 1)).astype(np.float32)
    return outputs, valid, labels


@pytest.mark.parametrize("ohkm", [True, False])
@pytest.mark.parametrize("coarse_to_fine", [True, False])
def test_multi_stage_loss_equals_jax(ohkm, coarse_to_fine):
    outputs, valid, labels = loss_inputs(9)
    want = jax_loss.rsn_multi_stage_loss(
        [[jnp.asarray(o) for o in s] for s in outputs], jnp.asarray(valid),
        jnp.asarray(labels), 2, ohkm=ohkm, topk=8,
        coarse_to_fine=coarse_to_fine)
    got = loss.rsn_multi_stage_loss(
        [[torch.from_numpy(o) for o in s] for s in outputs],
        torch.from_numpy(valid), torch.from_numpy(labels), 2, ohkm=ohkm,
        topk=8, coarse_to_fine=coarse_to_fine)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("has_ohkm", [True, False])
def test_joints_l2_loss_equals_jax(has_ohkm):
    outputs, valid, labels = loss_inputs(10, stages=1)
    args = (outputs[0][3], valid[..., 0], labels[:, 2])
    want = jax_loss.joints_l2_loss(*map(jnp.asarray, args),
                                   has_ohkm=has_ohkm, topk=6)
    got = loss.joints_l2_loss(*map(torch.from_numpy, args),
                              has_ohkm=has_ohkm, topk=6)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ------------------------------------------------------------------- int8
def test_int8_sites_equal_jax(nets):
    """int8 PTQ of the reduced RSN on the JAX package's calibration table:
    the same engaged sites (``*res_conv2*`` kept in float), and every
    int8 site, fed the input it gets inside the JAX ``QuantizedModel``
    (channel slices and their sums at the residual steps included),
    gives the JAX output bit for bit."""
    _int8_sites_equal_jax(nets["base"])


def _int8_sites_equal_jax(net, only=""):
    """The int8 sites of ``net`` against the JAX ``QuantizedModel``'s:
    engaged sets equal, and each site whose path holds ``only`` bit for
    bit on the input it gets there."""
    jmodel, v, model, _ = net
    x = _x(7)
    table = jq.calibrate(jmodel, v, [jnp.asarray(x)])
    jqm = jq.QuantizedModel(jmodel, table)
    # the int8 weights of ``prepare_variables`` made in numpy with a true
    # division (the eager scales; under jit XLA multiplies by 1/127)
    quant = {}
    for path in table:
        if not jq._matches(path, jq.DEFAULT_SKIP):
            node = v["params"]
            for part in path.split("/"):
                node = node[part]
            k = node["kernel"]
            s_w = np.maximum(np.abs(k).max(axis=(0, 1, 2)) / np.float32(127),
                             np.float32(1e-12))
            leaf = quant
            for part in path.split("/"):
                leaf = leaf.setdefault(part, {})
            leaf.update(kernel_i8=np.clip(np.round(k / s_w), -127,
                                          127).astype(np.int8), scale=s_w)

    @jax.jit
    def site_inputs(variables, x):
        """Each int8 site's input in one apply of ``jqm``."""
        seen = {}

        def record(next_fun, args, kwargs, context):
            y = jqm._interceptor(next_fun, args, kwargs, context)
            path = jq._path_of(context.module)
            if path in jqm.engaged and path not in seen:
                seen[path] = args[0]
            return y

        with fnn.intercept_methods(record):
            jmodel.apply(variables, x, train=False)
        return seen

    seen = jax.tree_util.tree_map(np.asarray, site_inputs(
        {**v, "quant": quant}, jnp.asarray(x)))
    qm = tq.QuantizedModel(model, table)
    sites = conv_sites(model)
    floats = {p for p in sites.values() if p.endswith("res_conv2/conv")}
    assert qm.engaged == jqm.engaged == set(seen)
    assert len(floats) == 4 and qm.engaged == set(sites.values()) - floats
    names = {p: n for n, p in sites.items()}
    checked = [p for p in seen if only in p]
    assert checked
    for path in checked:
        site_in = seen[path]
        conv = model.get_submodule(names[path])
        params = v["params"]
        for part in path.split("/"):
            params = params[part]
        # the JAX site, run eagerly: under jit XLA fuses the epilogue's
        # ``· scale + bias`` into one rounding (a fused multiply-add),
        # where the JAX expression, the port's plain version and its
        # kernel round twice
        (kh, kw), (sh, sw), (ph, pw) = (conv.kernel_size, conv.stride,
                                        conv.padding)
        flax_conv = fnn.Conv(conv.out_channels, (kh, kw), strides=(sh, sw),
                             padding=((ph, ph), (pw, pw)), use_bias=True,
                             feature_group_count=conv.groups,
                             dtype=jnp.float32).bind({"params": params})
        leaf = quant
        for part in path.split("/"):
            leaf = leaf[part]
        want = np.asarray(jq._quantized_conv(flax_conv, jnp.asarray(site_in),
                                             table[path], leaf))
        site = qm.net.get_submodule(names[path])
        assert isinstance(site, tq.Int8DepthwiseConv2d) == (conv.groups > 1)
        with torch.inference_mode():
            got = site(_nchw(site_in))
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                      want, err_msg=path)
    return checked


def test_int8_refuses_prm_depthwise_conv(nets):
    """int8 PTQ of the PRM net (kept under its old name, from when PRM's
    9×9 depthwise conv had no int8 kernel): the engaged sites are the JAX
    ``QuantizedModel``'s, the 9×9 spatial gate among them, and every PRM
    site, fed the input it gets inside the JAX ``QuantizedModel``, gives
    the JAX output bit for bit; the 9×9 one serves through the
    depthwise int8 conv."""
    checked = _int8_sites_equal_jax(nets["prm"], only="/prm/")
    assert len(checked) == 5
    model = nets["prm"][2]
    assert model.stage0.upsample.up4.prm.conv_bn_relu_prm_3_2.conv.groups \
        == 32 and any(p.endswith("prm3_2/conv") for p in checked)


def test_conv_sites_name_the_jax_paths(nets):
    """Each RSN variant's conv sites are the flax paths of the JAX
    package's convs, one for one."""
    from test_torch_quantize import _flax_pose_paths
    for key, (_, v, model, _) in nets.items():
        sites = conv_sites(model)
        convs = [p for p in _flax_pose_paths(v["params"])
                 if "/se/" not in p]      # the SE layers' Dense kernels
        assert sorted(sites.values()) == sorted(convs), key
        assert all(isinstance(model.get_submodule(n), torch.nn.Conv2d)
                   for n in sites)
    assert isinstance(nets["base"][2], RSN)


@pytest.mark.parametrize("yaml", ["rsn18_256x192", "rsn50_256x192",
                                  "res18_256x192", "4xrsn18_256x192",
                                  "4xrsn50_384x288"])
def test_pose_pipeline_refuses_rsn(yaml):
    """``UdpPosePipeline`` (so ``serve`` and the infer CLI) serves RSN
    through RSN's own inference (``make_rsn_infer_fn``: BGR crops, RSN's
    constants and decode), and so does the detect-then-pose graph of
    ``FusedDetectPose``, which no longer refuses RSN: each yaml, reduced
    (``LAYERS [1, 1, 1, 1]``, upsample width 32, a 48x64 input, its own
    stage count, float32), built from the yaml or from the pipeline,
    gives on a frame with a stubbed detector head the keypoints and
    maxvals of ``infer_pose`` on the boxes it found (keypoints 1e-3 px;
    the two batch the crops differently)."""
    from test_torch_fused_engine import _mk_pred, _torch_stub
    from udp_pose_tpu_torch.config import load_config
    from udp_pose_tpu_torch.engine.fused import FusedDetectPose
    from udp_pose_tpu_torch.engine.pose_engine import UdpPosePipeline
    cfg = load_config(os.path.join(REPO, "configs", "coco", f"{yaml}.yaml"))
    assert cfg.MODEL.NAME == "rsn"
    cfg.MODEL.IMAGE_SIZE = [48, 64]
    cfg.MODEL.HEATMAP_SIZE = [12, 16]
    cfg.TPU.DTYPE = "float32"
    cfg.MODEL.EXTRA.merge_from_dict({"UPSAMPLE_CHANNEL_NUM": 32,
                                     "LAYERS": [1, 1, 1, 1]})
    pipe = UdpPosePipeline(cfg, device="cpu")
    assert pipe.bgr and pipe.input_wh == (48, 64)
    frame = np.random.default_rng(3).integers(0, 256, (240, 320, 3),
                                              dtype=np.uint8)
    pred = _mk_pred([(28, 46, 40, 68, 0.95, 0.95), (90, 40, 30, 60, 0.8,
                                                    0.9)])
    kw = dict(max_persons=4, det_size=128, topk=32)
    for eng in (FusedDetectPose(pipe, **kw),
                FusedDetectPose(cfg, device="cpu", **kw)):
        eng.yolo = _torch_stub(pred)
        assert eng._pose.bgr
        got = eng.infer_frame(frame)
        n = len(got["boxes"])
        assert n == 2 and got["keypoints"].shape == (n, 17, 2)
        kp, mv = eng._pose.infer_pose(frame, got["boxes"])
        np.testing.assert_allclose(got["keypoints"], kp, rtol=0, atol=1e-3)
        np.testing.assert_allclose(got["maxvals"], mv, rtol=1e-4, atol=1e-5)


def test_pose_pipeline_serves_rsn_as_make_rsn_infer_fn(nets):
    """RSN through ``UdpPosePipeline.infer_pose`` (crops warped on the
    device) and through the ``CropBatcher`` of ``/v1/pose`` (host crops):
    the JAX package's ``make_rsn_infer_fn`` on the JAX graph's crops of
    the same boxes (``classic_affine_matrix`` and ``crop_boxes``; for the
    batcher the host crops), in BGR order, bucket-padded by repeating the
    first row.  Float32: maxvals (the blurred maps' peaks) to 1e-5,
    keypoints to 1e-3 px (both agree to 1.5e-5 px here)."""
    from udp_pose_tpu.core.infer import COCO_FLIP_PAIRS
    from udp_pose_tpu.core.rsn import make_rsn_infer_fn as jax_rsn_infer
    from udp_pose_tpu.engine.server import host_crops as jax_host_crops
    from udp_pose_tpu.ops import affine as jax_affine
    from udp_pose_tpu.ops.boxes import xyxy_to_cs
    from udp_pose_tpu_torch.data.rsn import RSN_COCO
    from udp_pose_tpu_torch.engine.pose_engine import UdpPosePipeline
    from udp_pose_tpu_torch.engine.server import CropBatcher

    jmodel, v, _, cfg = nets["base"]
    cfg.TEST.FLIP_TEST = True
    pipe = UdpPosePipeline(cfg, weights=v, device="cpu")
    assert pipe.bgr
    jinfer = jax_rsn_infer(
        jmodel, flip_test=True, flip_pairs=COCO_FLIP_PAIRS,
        kernel=RSN_COCO["test_gaussian_kernel"],
        shifts=tuple(RSN_COCO["test_shift_ratios"]), input_size_hw=(H, W))
    rng = np.random.default_rng(31)
    frame = rng.integers(0, 256, (80, 100, 3), dtype=np.uint8)
    boxes = np.array([[-8, 4, 40, 70], [30, 10, 110, 75], [5, 20, 45, 60]],
                     np.float32)
    center, scale = xyxy_to_cs(boxes, (W, H))
    cp, sp = (np.concatenate([a, a[:1]]) for a in (center, scale))
    mats = jax.vmap(lambda c, s: jax_affine.classic_affine_matrix(
        c, s, 0.0, (W, H), inv=True))(cp, sp)
    crops = np.asarray(jax_affine.crop_boxes(
        jnp.asarray(frame, jnp.float32), mats, (H, W)))
    host = jax_host_crops(frame, boxes, (W, H))[0]
    host = np.concatenate([host, host[:1]])
    batcher = CropBatcher(pipe, window_ms=1.0)
    try:
        got = {"infer_pose": pipe.infer_pose(frame, boxes),
               "batcher": batcher.infer(*host_crops_of(frame, boxes))}
    finally:
        batcher.close()
    for path, x in (("infer_pose", crops), ("batcher", host)):
        preds, maxvals, hm = (np.asarray(a) for a in jinfer(
            v, x[..., ::-1], cp, sp))
        kp, sc = got[path]
        assert kp.shape == (3, 17, 2) and sc.shape == (3, 17, 1)
        np.testing.assert_allclose(sc, maxvals[:3], rtol=0, atol=1e-5,
                                   err_msg=path)
        np.testing.assert_allclose(kp, preds[:3], rtol=0, atol=1e-3,
                                   err_msg=path)


def host_crops_of(frame, boxes):
    from udp_pose_tpu_torch.engine.server import host_crops
    return host_crops(frame, boxes, (W, H))


def test_int8_rsn_pipeline_calibrates_then_serves_quantized(nets):
    """int8 RSN with PRM through ``UdpPosePipeline``: the first batch is
    recorded (on the BGR crops, normalised with RSN's constants) and
    served in float; the table then holds every conv site, and the next
    call serves through ``QuantizedModel``, the 9×9 depthwise site through
    ``int8_dwconv``: what ``make_rsn_infer_fn`` over
    ``QuantizedModel(model, table)`` gives on the same device crops."""
    from udp_pose_tpu_torch.core.rsn import make_rsn_infer_fn_from_cfg
    from udp_pose_tpu_torch.engine.pose_engine import UdpPosePipeline
    from udp_pose_tpu.ops.boxes import xyxy_to_cs
    from udp_pose_tpu_torch.models.quantize import (Int8DepthwiseConv2d,
                                                    QuantizedModel)

    _, v, model, cfg = nets["prm"]
    pipe = UdpPosePipeline(cfg, weights=v, device="cpu", quantize="int8",
                           calib_batches=1, flip_test=True)
    rng = np.random.default_rng(33)
    frame = rng.integers(0, 256, (80, 100, 3), dtype=np.uint8)
    boxes = np.array([[4, 4, 50, 70], [30, 10, 95, 75]], np.float32)
    fp = pipe.infer_pose(frame, boxes)
    assert pipe.int8.table is not None
    assert set(pipe.int8.table) == set(conv_sites(pipe.model).values())
    q = pipe.infer_pose(frame, boxes)
    assert sum(isinstance(m, Int8DepthwiseConv2d)
               for m in pipe.int8.qmodel.modules()) == 1
    center, scale = xyxy_to_cs(boxes, (W, H))
    crops = pipe.crop_frame(frame, center, scale).flip(-1)
    want = make_rsn_infer_fn_from_cfg(
        QuantizedModel(pipe.model, pipe.int8.table), cfg,
        pipe.flip_pairs, flip_test=True)(crops, center, scale)
    np.testing.assert_array_equal(q[0], want[0].numpy())
    np.testing.assert_array_equal(q[1], want[1].numpy())
    assert not np.array_equal(q[1], fp[1])
