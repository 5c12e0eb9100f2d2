"""The port's quantisation-aware training (``FakeQuantModel`` of
``udp_pose_tpu_torch/models/quantize.py``) against the JAX package's on
the CPU, and the ``TPU.QAT`` / ``TPU.QUANTIZE`` entry points.

The fake-quant conv is held to the JAX ``_fake_quant_conv`` forward and
gradients, with per-batch and with frozen activation scales.  On the
reduced HRNet every fake-quantised site, fed the input it gets inside
the JAX ``FakeQuantModel``, gives the JAX output.  The whole net's
gradient is not compared: its grid flips (an activation ulps from a
rounding tie lands on the other int8 step) put even JAX's own float32
gradient 1.83 × a tensor's max |g| away from its float64 one on this net
(measured; the port's float32 lies 1.91 away), so only a conv at a time
has a meaningful reference.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import linen as fnn

from ref_harness import make_mini_coco
from test_torch_hrnet import reduced_cfg
from test_torch_quantize import _nchw, _one_conv
from test_torch_train import _data_cfg, restore_root_logger  # noqa: F401
from test_torch_yolov5 import few_threads  # noqa: F401 (autouse)
from test_torch_yolov5 import numpy_variables
from udp_pose_tpu.config import default_config as jax_default_config
from udp_pose_tpu.models import build_model as jax_build_model
from udp_pose_tpu.models import quantize as jq
from udp_pose_tpu_torch.config import default_config
from udp_pose_tpu_torch.models import build_model
from udp_pose_tpu_torch.models import quantize as tq
from udp_pose_tpu_torch.utils.convert import (conv_sites, state_dict_to_torch,
                                              variables_to_state_dict)

# float32 conv of the same fake-quantised operands, XLA against PyTorch's
# CPU kernels: the summation order differs (measured below 2e-6)
CONV_REL = 1e-5


def _jax_fake_quant(module, v, x, amax):
    """Output and gradients (input, kernel, bias) of ``sum(out · r)``
    through the JAX one-conv ``FakeQuantModel``, in float64 outside the
    conv (``_fake_quant_conv`` computes the conv in float32)."""
    table = None if amax is None else {"conv": amax}
    fq = jq.FakeQuantModel(module, act_scales=table)
    r = np.random.default_rng(9).normal(size=np.asarray(
        fq.apply(v, jnp.asarray(x))).shape)
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), v)

        def loss(params, xx):
            y = fq.apply({"params": params}, xx)
            return jnp.sum(y * jnp.asarray(r)), y

        (_, y), (g_p, g_x) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(
                v64["params"], jnp.asarray(x, jnp.float64))
        out = (np.asarray(y), np.asarray(g_x),
               jax.tree_util.tree_map(np.asarray, g_p["conv"]), r)
    assert fq.engaged == {"conv"}
    return out


def _close(got, want, what):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=CONV_REL * scale,
                               err_msg=what)


@pytest.mark.parametrize("frozen", [False, True])
@pytest.mark.parametrize("k,s,p,cin,cout,bias", [
    (3, 1, 1, 16, 24, False), (3, 2, 1, 8, 16, True), (1, 1, 0, 32, 16, True)])
def test_fake_quant_conv_equals_jax(k, s, p, cin, cout, bias, frozen):
    """Forward and gradients of a fake-quantised conv: the STE passes the
    gradient to the input and the kernel as the identity would."""
    module, v, conv = _one_conv(k, s, p, cin, cout, bias, seed=cin + k)
    x = np.random.default_rng(4).normal(0, 1.5, (2, 11, 9, cin)).astype(
        np.float32)
    amax = float(np.abs(x).max()) * 0.7 if frozen else None
    want_y, want_gx, want_gp, r = _jax_fake_quant(module, v, x, amax)

    layer = tq.FakeQuantConv2d(conv, amax)
    xt = _nchw(x).clone().requires_grad_(True)
    y = layer(xt)
    assert y.dtype == torch.float32
    (y * torch.from_numpy(r).permute(0, 3, 1, 2)).sum().backward()
    _close(y.detach().permute(0, 2, 3, 1).numpy(), want_y, "output")
    _close(xt.grad.permute(0, 2, 3, 1).numpy(), want_gx, "d input")
    _close(conv.weight.grad.permute(2, 3, 1, 0).numpy(), want_gp["kernel"],
           "d kernel")
    if bias:
        _close(conv.bias.grad.numpy(), want_gp["bias"], "d bias")


def test_fake_quant_model_sites_equal_jax():
    """Dynamic scales on the reduced HRNet: the same engaged sites (the
    heads in float), and each site fed its JAX input gives the JAX
    site's output; the wrapper trains the original parameters."""
    jmodel = jax_build_model(reduced_cfg(jax_default_config))
    v = numpy_variables(jmodel, (1, 64, 64, 3), seed=7)
    cfg = reduced_cfg(default_config)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(state_dict_to_torch(variables_to_state_dict(v, cfg)),
                          strict=True)
    jfq = jq.FakeQuantModel(jmodel)
    seen = {}

    def record(next_fun, args, kwargs, context):
        y = jfq._interceptor(next_fun, args, kwargs, context)
        path = jq._path_of(context.module)
        if path in jfq.engaged and path not in seen:
            seen[path] = (np.asarray(args[0]), np.asarray(y))
        return y

    x = np.random.default_rng(8).normal(size=(1, 64, 64, 3)).astype(
        np.float32)
    with fnn.intercept_methods(record):
        jmodel.apply(v, jnp.asarray(x), train=False)
    fq = tq.FakeQuantModel(model)
    assert fq.engaged == jfq.engaged == set(seen)
    assert len(fq.engaged) == len(conv_sites(model)) - 1
    sites = {p: n for n, p in conv_sites(model).items()}
    with torch.no_grad():
        for path, (site_in, site_out) in seen.items():
            got = fq.net.get_submodule(sites[path])(_nchw(site_in))
            _close(got.permute(0, 2, 3, 1).numpy(), site_out, path)
    ids = {id(t) for t in model.parameters()}
    assert {id(t) for t in fq.parameters()} == ids
    # skipping every site leaves the float model, bit for bit
    none = tq.FakeQuantModel(model, skip=("*",))
    with torch.no_grad():
        assert torch.equal(none(_nchw(x)), model(_nchw(x)))


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("coco_q")
    make_mini_coco(str(root), image_set="train2017", n_images=6, seed=31)
    make_mini_coco(str(root), image_set="val2017", n_images=4, seed=32,
                   all_visible=True)
    return str(root)


def test_train_qat_and_test_int8_entry_points(coco_root, tmp_path, caplog,
                                              restore_root_logger):
    """``train`` with ``TPU.QAT int8`` for one epoch trains through the
    fake-quant grid and writes the float model's keys; ``test`` with
    ``TPU.QUANTIZE int8`` calibrates every site but the head, and with
    ``TPU.QAT int8`` evaluates through the fake-quant grid."""
    from udp_pose_tpu_torch import test as test_cli
    from udp_pose_tpu_torch import train as train_cli
    cfg = _data_cfg(default_config, coco_root)
    cfg.TRAIN.END_EPOCH = 1
    cfg.OUTPUT_DIR = str(tmp_path / "output")
    cfg.LOG_DIR = str(tmp_path / "log")
    path = tmp_path / "reduced.yaml"
    path.write_text(yaml.safe_dump(cfg.to_dict()))
    caplog.set_level(logging.INFO)

    record = train_cli.main(["--cfg", str(path), "--device", "cpu",
                             "TPU.QAT", "int8"])
    assert "QAT int8: training through the fake-quant grid" in caplog.text
    assert record["steps"] and all(np.isfinite(s["loss"])
                                   for s in record["steps"])
    weights = (tmp_path / "output" / "coco" / "pose_hrnet" / "reduced"
               / "final_state.pth")
    model = build_model(cfg, device="cpu")
    model.load_state_dict(torch.load(weights), strict=True)

    caplog.clear()
    nv_q, _ = test_cli.main(["--cfg", str(path), "--device", "cpu",
                             "TEST.MODEL_FILE", str(weights),
                             "TPU.QUANTIZE", "int8"])
    n_sites = len(conv_sites(model)) - 1
    assert f"int8 PTQ: calibrated {n_sites} conv sites" in caplog.text
    caplog.clear()
    nv_qat, _ = test_cli.main(["--cfg", str(path), "--device", "cpu",
                               "TEST.MODEL_FILE", str(weights),
                               "TPU.QAT", "int8"])
    assert "QAT int8: evaluating through the fake-quant grid" in caplog.text
    assert nv_q.keys() == nv_qat.keys() == record["name_values"].keys()
    with pytest.raises(ValueError, match="TPU.QAT"):
        train_cli.main(["--cfg", str(path), "--device", "cpu",
                        "TPU.QAT", "int4"])


def test_quantize_for_eval_calibrates_the_serving_input(coco_root):
    """``quantize_for_eval`` takes the first ``TPU.QUANTIZE_CALIB_BATCHES``
    val batches, normalised and cast to the compute dtype, as serving
    feeds the stem."""
    from udp_pose_tpu_torch.core.infer import normalize_images
    from udp_pose_tpu_torch.data import build_dataset
    from udp_pose_tpu_torch.data.base import epoch_loader
    cfg = _data_cfg(default_config, coco_root)
    cfg.TPU.DTYPE = "bfloat16"
    cfg.TEST.BATCH_SIZE_PER_GPU = 2
    cfg.TPU.QUANTIZE_CALIB_BATCHES = 1
    model = build_model(cfg, device="cpu")
    assert tq.quantize_for_eval(cfg, model, None) is model
    cfg.TPU.QUANTIZE = "int8"
    ds = build_dataset(cfg, is_train=False)
    qm = tq.quantize_for_eval(cfg, model, ds)
    first = next(iter(epoch_loader(ds, 2, shuffle=False, drop_last=False)))
    x = normalize_images(torch.as_tensor(first["image"])).to(torch.bfloat16)
    want = tq.calibrate(model, [x.permute(0, 3, 1, 2)])
    assert qm.act_scales == want and "final_layer" not in want
    assert qm.engaged == set(want) and qm.dtype == torch.bfloat16
