"""The port's YOLOv5 against the JAX package's on the CPU.

Flax variables are initialised on the CPU, bridged into the port with
``utils/convert.yolov5_variables_to_state_dict`` (held equal to the JAX
package's ``flax_to_torch_yolov5``) and loaded with ``strict=True``;
both run the same numpy-seeded input in float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from udp_pose_tpu.models.yolov5 import STRIDES
from udp_pose_tpu.models.yolov5 import YOLOv5 as JaxYOLOv5
from udp_pose_tpu.utils.torch_convert import flax_to_torch_yolov5
from udp_pose_tpu_torch.models import build_detector
from udp_pose_tpu_torch.models.yolov5 import YOLOv5
from udp_pose_tpu_torch.utils.convert import (load_yolov5_weights,
                                              state_dict_to_torch,
                                              ultralytics_state_dict,
                                              yolov5_variables_to_state_dict)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the suite runs several test processes at
    once, and each would otherwise start one thread per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def numpy_variables(module, input_shape, seed=0):
    """Seeded flax variables of ``module`` made in numpy from the shapes
    of its init (no compile): conv kernels normal / sqrt(fan_in), biases
    small, BatchNorm scale near 1, running mean near 0, var in [0.5,
    1.5]."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda r: module.init(
        r, jnp.zeros(input_shape), train=False), jax.random.PRNGKey(0))

    def make(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            v = rng.normal(0, 1 / np.sqrt(fan_in), leaf.shape)
        elif name in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, leaf.shape)
        else:                                   # bias, mean
            v = rng.normal(0, 0.1, leaf.shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(make, shapes)


@pytest.fixture(scope="module")
def bridged_n():
    """(flax model, its variables with non-trivial BN statistics, the
    port's model on the CPU with the same weights)."""
    jmodel = JaxYOLOv5(variant="n")
    v = numpy_variables(jmodel, (1, 64, 64, 3))
    model = build_detector("yolov5n", device="cpu")
    model.load_state_dict(state_dict_to_torch(
        yolov5_variables_to_state_dict(v)), strict=True)
    return jmodel, v, model


def test_output_shape_and_decode_bounds_at_320():
    model = build_detector("n", device="cpu")
    with torch.inference_mode():
        out = model(torch.zeros(1, 3, 320, 320))
    assert out.dtype == torch.float32
    assert out.shape == (1, sum((320 // s) ** 2 * 3 for s in STRIDES), 85)
    out = out.numpy()
    assert out[..., 0].min() > -20 and out[..., 0].max() < 340
    assert out[..., 2:4].min() > 0 and out[..., 2:4].max() <= 4 * 373 + 1
    assert 0 < out[..., 4].min() and out[..., 4].max() < 1


@pytest.mark.parametrize("variant", ["n", "s"])
def test_parameter_count_equals_flax(variant):
    model = JaxYOLOv5(variant=variant)
    shapes = jax.eval_shape(lambda r: model.init(
        r, jnp.zeros((1, 64, 64, 3)), train=False), jax.random.PRNGKey(0))
    n_flax = sum(np.prod(p.shape) for p in
                 jax.tree_util.tree_leaves(shapes["params"]))
    n_port = sum(p.numel() for p in YOLOv5(variant).parameters())
    assert n_port == n_flax


def test_key_map_equals_flax_to_torch_yolov5(bridged_n):
    _, v, model = bridged_n
    sd = yolov5_variables_to_state_dict(v)
    gold = {"model." + k: np.asarray(val)
            for k, val in flax_to_torch_yolov5(v).items()}
    assert sorted(sd) == sorted(gold) == sorted(model.state_dict())
    for k in gold:
        np.testing.assert_array_equal(sd[k], gold[k], err_msg=k)


def test_fp32_forward_equals_flax(bridged_n):
    """Relative 1e-4 of the largest |value| per output field group (the
    xy/wh pixels and the sigmoided scores)."""
    jmodel, v, model = bridged_n
    x = np.random.default_rng(1).uniform(0, 1, (2, 96, 128, 3)).astype(
        np.float32)
    gold = np.asarray(jmodel.apply(v, jnp.asarray(x), train=False))
    with torch.inference_mode():
        out = model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert out.shape == gold.shape
    for sl in (slice(0, 4), slice(4, None)):
        err = np.abs(out[..., sl] - gold[..., sl]).max()
        assert err <= 1e-4 * np.abs(gold[..., sl]).max(), err


def test_ultralytics_state_dict_loads_strict(bridged_n, tmp_path):
    """One or two ``model.`` prefixes and the anchor buffers of an
    ultralytics state dict; the JAX variables and a saved ``.pt`` give
    the same weights."""
    _, v, model = bridged_n
    want = model.state_dict()
    ultra = {("model." + k): t.clone() for k, t in want.items()}
    ultra["model.model.24.anchors"] = torch.zeros(3, 3, 2)
    ultra["model.model.24.anchor_grid"] = torch.zeros(3)
    sd = ultralytics_state_dict(ultra)
    assert sorted(sd) == sorted(want)
    path = tmp_path / "yolov5n.pt"
    torch.save(ultra, path)
    for weights in (v, ultra, str(path)):
        got = build_detector("n", device="cpu", seed=3)
        res = got.load_state_dict(
            state_dict_to_torch(load_yolov5_weights(weights)), strict=True)
        assert not res.missing_keys and not res.unexpected_keys
        for k in want:
            assert torch.equal(got.state_dict()[k], want[k]), k
    with pytest.raises(ValueError, match=".pt"):
        load_yolov5_weights(str(tmp_path / "yolov5n.onnx"))
    with pytest.raises(KeyError, match="yolov5n"):
        build_detector("yolov5x", device="cpu")
