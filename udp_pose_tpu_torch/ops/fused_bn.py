"""Train-mode BatchNorm(+ReLU) with a hand-written two-pass backward (port
of ``udp_pose_tpu/ops/fused_bn.py``).

The same math as the port's BatchNorm, scheduled by hand: the forward
takes float32 statistics by the fast form ``E[x²] - E[x]²`` and saves
only ``(x, mean, rstd)``; the backward is two passes over the
activation,

  pass 1: Σ dy', Σ dy'·x̂ per channel (dy' the ReLU-masked dy),
  pass 2: dx = rstd·scale · (dy' - Σdy'/N - x̂ · Σdy'x̂/N),

recomputing the ReLU mask from the saved tensors instead of keeping the
output or a mask.  :class:`FusedBatchNorm` is a drop-in for
:class:`..models.layers.BatchNorm2d` (the same state names, so the
weights bridge loads it; flax's running-stat update with the biased
variance); :func:`use_fused_batchnorm` routes a model's train-mode
BatchNorms through it.  It is an A/B path, on no default path (the JAX
package's caller is ``tools/profile_train.py``'s ``v_fused_bn``).  Plain
PyTorch: no kernel replaces a Pallas one here.
"""

from __future__ import annotations

import torch
from torch import nn

from ..models.layers import BatchNorm2d

_DIMS = (0, 2, 3)


def _col(v):
    return v[None, :, None, None]


def _acc(t):
    """``t`` in the statistics' type: float32 for bfloat16 and float32
    tensors, float64 for float64 ones."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _stats(x32):
    """Per-channel mean and biased variance of (N, C, H, W) ``x32`` (in
    the statistics' type) over (N, H, W), ``E[x²] - E[x]²`` as the JAX
    package takes them."""
    mean = x32.mean(_DIMS)
    var = x32.square().mean(_DIMS) - mean.square()
    return mean, var


class _BNReLUTrain(torch.autograd.Function):
    """(x, scale, bias) → (y, batch mean, batch variance); the statistics
    are outputs without a gradient, so the module's running-stat update
    reads the forward's reductions."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, relu):
        x32 = _acc(x)
        mean, var = _stats(x32)
        rstd = torch.rsqrt(var + eps)
        y = (x32 - _col(mean)) * _col(rstd) * _col(_acc(scale)) \
            + _col(_acc(bias))
        if relu:
            y = y.clamp_min(0.0)
        ctx.save_for_backward(x, mean, rstd, scale, bias)
        ctx.relu = relu
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, mean, rstd, scale, bias = ctx.saved_tensors
        s32 = _acc(scale)
        xhat = (_acc(x) - _col(mean)) * _col(rstd)
        dy32 = _acc(dy)
        if ctx.relu:
            # the mask recomputed from the saved residuals
            dy32 = torch.where(xhat * _col(s32) + _col(_acc(bias)) > 0.0,
                               dy32, 0.0)
        n = x.numel() // x.shape[1]
        sum_dy = dy32.sum(_DIMS)
        sum_dy_xhat = (dy32 * xhat).sum(_DIMS)
        dx = _col(rstd * s32) * (dy32 - _col(sum_dy / n)
                                 - xhat * _col(sum_dy_xhat / n))
        return (dx.to(x.dtype), sum_dy_xhat.to(scale.dtype),
                sum_dy.to(bias.dtype), None, None)


def bn_relu_train(x, scale, bias, eps=1e-5, relu=False):
    """Train-mode BatchNorm of (N, C, H, W) ``x`` with its batch
    statistics, then a ReLU when ``relu``, with the two-pass backward;
    ``scale``, ``bias`` (C,).  Returns y in ``x``'s dtype."""
    return _BNReLUTrain.apply(x, scale, bias, eps, relu)[0]


class FusedBatchNorm(BatchNorm2d):
    """:class:`..models.layers.BatchNorm2d` (its state dict, its flax
    momentum form ``running = (1 - momentum)·running + momentum·batch``
    with the biased variance, its ``update_stats``) whose train mode runs
    :func:`bn_relu_train`, with the ReLU fused when ``relu``.  Eval mode
    is the plain affine normalisation with the running statistics (and
    the ReLU)."""

    def __init__(self, num_features, eps=1e-5, momentum=0.1, relu=False):
        super().__init__(num_features, eps=eps, momentum=momentum)
        self.relu = relu

    def forward(self, x):
        if not self.training:
            rstd = torch.rsqrt(self.running_var + self.eps)
            y = (_acc(x) - _col(self.running_mean)) * _col(rstd) \
                * _col(self.weight) + _col(self.bias)
            if self.relu:
                y = y.clamp_min(0.0)
            return y.to(x.dtype)
        y, mean, var = _BNReLUTrain.apply(x, self.weight, self.bias,
                                          self.eps, self.relu)
        if self.update_stats:
            with torch.no_grad():
                dt = self.running_mean.dtype
                self.running_mean.lerp_(mean.to(dt), self.momentum)
                self.running_var.lerp_(var.to(dt), self.momentum)
                self.num_batches_tracked.add_(1)
        return y


def _fused_copy(bn: BatchNorm2d, relu=False) -> FusedBatchNorm:
    """A :class:`FusedBatchNorm` with ``bn``'s settings and state."""
    fused = FusedBatchNorm(bn.num_features, eps=bn.eps,
                           momentum=bn.momentum, relu=relu)
    fused.update_stats = getattr(bn, "update_stats", True)
    fused.load_state_dict(bn.state_dict())
    fused.train(bn.training)
    return fused.to(device=bn.weight.device, dtype=bn.weight.dtype)


def use_fused_batchnorm(model: nn.Module, relu: bool = False) -> int:
    """Route every :class:`..models.layers.BatchNorm2d` of ``model``
    (exactly that class; data parallelism's global one keeps its own
    statistics) through a :class:`FusedBatchNorm` copy, in place.  With
    ``relu``, a BatchNorm followed by a ``ReLU`` in an ``nn.Sequential``
    takes it in (the ReLU becomes an identity).  Returns the BatchNorms
    replaced."""
    n = 0
    for module in list(model.modules()):
        names = list(module._modules)
        for i, name in enumerate(names):
            child = module._modules[name]
            if type(child) is not BatchNorm2d:
                continue
            fuse = (relu and isinstance(module, nn.Sequential)
                    and i + 1 < len(names)
                    and isinstance(module._modules[names[i + 1]], nn.ReLU))
            module._modules[name] = _fused_copy(child, relu=fuse)
            if fuse:
                module._modules[names[i + 1]] = nn.Identity()
            n += 1
    return n
