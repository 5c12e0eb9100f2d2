"""The port's fused-BN VJP (``ops/fused_bn.py``) against the JAX package's
``bn_relu_train`` and ``FusedBatchNorm``, on the CPU.

The same numpy-seeded NHWC data (NCHW in the port) through both: the
forward, dx, dscale, dbias and the running statistics, with and without
the fused ReLU, in float32 and bfloat16, and eval mode.  The tolerances
are ``tests/test_fused_bn.py``'s oracle's (float32); in bfloat16 an
output or dx element may sit one bfloat16 ulp (2^-8 relative) apart,
where float32 sums in another order round across a bfloat16 tie.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_hrnet import reduced_cfg
from test_torch_yolov5 import few_threads  # noqa: F401 (autouse)
from udp_pose_tpu.ops.fused_bn import FusedBatchNorm as JaxFusedBN
from udp_pose_tpu.ops.fused_bn import bn_relu_train as jax_bn_relu_train
from udp_pose_tpu_torch.config import default_config
from udp_pose_tpu_torch.models import build_model
from udp_pose_tpu_torch.models.layers import BatchNorm2d
from udp_pose_tpu_torch.ops.fused_bn import (FusedBatchNorm, bn_relu_train,
                                             use_fused_batchnorm)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _data(seed=0, shape=(4, 8, 6, 16)):
    g = np.random.default_rng(seed)
    x = g.normal(size=shape).astype(np.float32)
    scale = g.normal(size=shape[-1]).astype(np.float32) * 0.5 + 1.0
    bias = g.normal(size=shape[-1]).astype(np.float32) * 0.2
    dy = g.normal(size=shape).astype(np.float32)
    return x, scale, bias, dy


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def _close(got, want, dtype, rtol=2e-4, atol=2e-4):
    want = np.asarray(want, np.float32)
    if dtype == "bfloat16":
        # one bfloat16 ulp of the largest magnitude
        atol = 2.0 ** -8 * float(np.abs(want).max())
        rtol = 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("relu", [False, True])
def test_bn_relu_train_equals_jax(relu, dtype):
    """Forward, dx, dscale and dbias of ``sum(y · dy)``."""
    jdt, tdt = DTYPES[dtype]
    x, scale, bias, dy = _data()

    def jax_loss(x, scale, bias):
        y = jax_bn_relu_train(x, scale, bias, 1e-5, relu)
        return jnp.sum(y.astype(jnp.float32) * dy), y

    (_, y_want), g_want = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x, jdt), jnp.asarray(scale), jnp.asarray(bias))

    xt = _nchw(x).to(tdt).requires_grad_(True)
    st = torch.from_numpy(scale).requires_grad_(True)
    bt = torch.from_numpy(bias).requires_grad_(True)
    y = bn_relu_train(xt, st, bt, 1e-5, relu)
    assert y.dtype == tdt
    (y.float() * _nchw(dy)).sum().backward()
    _close(_nhwc(y), y_want, dtype)
    _close(_nhwc(xt.grad), g_want[0], dtype)
    for got, want in ((st.grad, g_want[1]), (bt.grad, g_want[2])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-4, atol=2e-4 if dtype ==
                                   "float32" else 2e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("relu", [False, True])
def test_fused_module_equals_jax_module(relu, dtype):
    """``FusedBatchNorm`` in train mode: output and running statistics
    (flax's momentum 0.9 with the biased variance) against the JAX
    module from the same state."""
    jdt, tdt = DTYPES[dtype]
    x, scale, bias, _ = _data(seed=3)
    g = np.random.default_rng(4)
    mean0 = g.normal(size=16).astype(np.float32) * 0.1
    var0 = g.uniform(0.5, 1.5, 16).astype(np.float32)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}
    y_want, stats = JaxFusedBN(use_running_average=False, momentum=0.9,
                               epsilon=1e-5, relu=relu).apply(
        variables, jnp.asarray(x, jdt), mutable=["batch_stats"])

    bn = FusedBatchNorm(16, relu=relu)
    bn.load_state_dict({"weight": torch.from_numpy(scale),
                        "bias": torch.from_numpy(bias),
                        "running_mean": torch.from_numpy(mean0),
                        "running_var": torch.from_numpy(var0),
                        "num_batches_tracked": torch.tensor(0)})
    y = bn.train()(_nchw(x).to(tdt))
    _close(_nhwc(y), y_want, dtype, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(stats["batch_stats"]["mean"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(stats["batch_stats"]["var"]),
                               rtol=1e-4, atol=1e-5)
    assert int(bn.num_batches_tracked) == 1


@pytest.mark.parametrize("relu", [False, True])
def test_fused_module_eval_mode_equals_jax(relu):
    """Eval mode: the plain affine normalisation with the running
    statistics, the JAX module's ``use_running_average`` (1e-5)."""
    x, scale, bias, _ = _data(seed=7)
    g = np.random.default_rng(8)
    mean0 = g.normal(size=16).astype(np.float32)
    var0 = g.uniform(0.5, 2.0, 16).astype(np.float32)
    want = JaxFusedBN(use_running_average=True, relu=relu).apply(
        {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": mean0, "var": var0}}, jnp.asarray(x))
    flax_bn = fnn.BatchNorm(use_running_average=True, epsilon=1e-5).apply(
        {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": mean0, "var": var0}}, jnp.asarray(x))
    if relu:
        flax_bn = fnn.relu(flax_bn)
    bn = FusedBatchNorm(16, relu=relu)
    bn.load_state_dict({"weight": torch.from_numpy(scale),
                        "bias": torch.from_numpy(bias),
                        "running_mean": torch.from_numpy(mean0),
                        "running_var": torch.from_numpy(var0),
                        "num_batches_tracked": torch.tensor(0)})
    with torch.no_grad():
        y = _nhwc(bn.eval()(_nchw(x)))
    np.testing.assert_allclose(y, np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y, np.asarray(flax_bn), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("relu", [False, True])
def test_fused_batchnorm_train_step_equals_plain(relu):
    """A reduced HRNet routed through ``FusedBatchNorm``
    (``use_fused_batchnorm``; with ``relu`` its ``Sequential`` BN-ReLU
    pairs fused) keeps its state-dict keys, and one float64 train step
    from the same weights and batch gives the plain model's output,
    gradients and running statistics (1e-9 of each tensor's max)."""
    cfg = reduced_cfg(default_config)
    torch.manual_seed(0)
    plain = build_model(cfg, device="cpu", train=True).double()
    fused = build_model(cfg, device="cpu", train=True).double()
    fused.load_state_dict(plain.state_dict())
    n_bn = sum(type(m) is BatchNorm2d for m in plain.modules())
    assert use_fused_batchnorm(fused, relu=relu) == n_bn
    assert not any(type(m) is BatchNorm2d for m in fused.modules())
    assert fused.state_dict().keys() == plain.state_dict().keys()
    assert any(isinstance(m, FusedBatchNorm) and m.relu
               for m in fused.modules()) == relu
    g = torch.Generator().manual_seed(1)
    x = torch.randn((2, 3, 64, 64), generator=g, dtype=torch.float64)
    outs = []
    for model in (plain, fused):
        out = model.train()(x)
        (out * torch.linspace(-1, 1, out.numel(), dtype=torch.float64)
         .reshape(out.shape)).sum().backward()
        outs.append(out.detach())
    assert torch.allclose(outs[1], outs[0], rtol=0,
                          atol=1e-9 * float(outs[0].abs().max()))
    grads = dict(plain.named_parameters())
    for name, p in fused.named_parameters():
        want = grads[name].grad
        assert torch.allclose(p.grad, want, rtol=0, atol=1e-9 * max(
            float(want.abs().max()), 1e-30)), name
    stats = plain.state_dict()
    for name, v in fused.state_dict().items():
        assert torch.allclose(v.double(), stats[name].double(), rtol=0,
                              atol=1e-9 * max(float(v.abs().max()), 1.0)), \
            name
