"""BatchNorm over the global batch of a data-parallel step.

The JAX package computes a sharded step's batch statistics over the
whole global batch: XLA inserts the cross-replica mean
(``udp_pose_tpu/parallel/mesh.py:9-12``), which is not the reference's
per-GPU statistics.  Here it is an autograd function over plain torch
reductions and two all-reduces a layer:

* forward: each rank's per-channel count, sum and sum of squares are
  all-reduced, and the mean and the
  variance are those of the global batch, the variance by flax's fast
  form ``E[x²] - E[x]²``;
* backward: ``Σdy`` and ``Σdy·x̂`` are all-reduced, so the input gradient
  is that of the sum of every rank's loss through the global statistics;
  the scale and bias gradients stay local, and DDP averages them with the
  rest.

So a step on N ranks of B rows each is one step of the same model on the
concatenated N·B rows.  The card and the CPU run the same expressions,
which the CPU tests hold against flax.  The running stats follow :class:`..models.
layers.BatchNorm2d` (flax's update with the biased variance, and its
``update_stats`` switch), with the global statistics, so every rank's
stay equal.  ``torch.nn.SyncBatchNorm`` is not used: it folds the
unbiased variance into ``running_var`` and takes only card tensors.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from ..models.layers import BatchNorm2d


def global_batch_stats(x, eps, group=None):
    """(mean, biased variance, element count) per channel of ``x`` (N, C,
    H, W) over every rank's batch, in the statistics' float type (float32
    for a bfloat16 ``x``).  Two reductions that read ``x`` and write no
    tensor of its size, the sum and the 2-norm, each accumulated in that
    type; every other operation is on C-long vectors."""
    with torch.no_grad():
        dt = torch.promote_types(x.dtype, torch.float32)
        C = x.shape[1]
        packed = torch.empty(2 * C + 1, dtype=dt, device=x.device)
        torch.sum(x, (0, 2, 3), dtype=dt, out=packed[:C])
        torch.linalg.vector_norm(x, 2, (0, 2, 3), dtype=dt,
                                 out=packed[C:2 * C])
        packed[C:2 * C].square_()
        # a fill: a number assigned into a card tensor is a copy from the
        # host, which waits for the stream
        packed[2 * C:].fill_(x.numel() // C)
        dist.all_reduce(packed, group=group)
        count = packed[2 * C:]
        moments = packed[:2 * C] / count            # E[x], E[x²]
        mean = moments[:C]
        var = torch.addcmul(moments[C:], mean, mean, value=-1)
        return mean, var.clamp_min_(0.0), count


class _GlobalBatchNorm(torch.autograd.Function):
    """``x`` normalised with given global statistics; the backward
    all-reduces the two sums the input gradient needs."""

    @staticmethod
    def forward(ctx, x, weight, bias, mean, var, count, eps, group):
        invstd = (var + eps).rsqrt()
        ctx.save_for_backward(x, weight, mean, invstd, count)
        ctx.eps, ctx.group = eps, group
        return torch.batch_norm(x, weight, bias, mean, var, False, 0.0, eps,
                                torch.backends.cudnn.enabled)

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, invstd, count = ctx.saved_tensors
        C = x.shape[1]
        # this rank's Σdy·x̂ and Σdy: the scale's and the bias's gradients
        _, g_weight, g_bias = torch.ops.aten.native_batch_norm_backward(
            dy, x, weight, None, None, mean, invstd, True, ctx.eps,
            [False, True, True])
        sums = torch.cat([g_bias, g_weight])
        dist.all_reduce(sums, group=ctx.group)
        means = sums / count                        # mean(dy), mean(dy·x̂)
        # dx = k·(dy - mean(dy) - x̂·mean(dy·x̂)), k = w·invstd, means over
        # the global batch, x̂ = (x - mean)·invstd: k·dy - c·x + b with
        # c = k·invstd·mean(dy·x̂), b = c·mean - k·mean(dy); two passes
        # over the tensor, then the cast
        k = weight * invstd
        c = torch.mul(means[C:], invstd).mul_(k)
        b = torch.addcmul(mean * c, means[:C], k, value=-1)
        dx = torch.addcmul(b.view(1, C, 1, 1), x, c.view(1, C, 1, 1),
                           value=-1)
        dx.addcmul_(dy, k.view(1, C, 1, 1))
        return dx.to(x.dtype), g_weight, g_bias, None, None, None, None, None


class GlobalBatchNorm2d(BatchNorm2d):
    """:class:`..models.layers.BatchNorm2d` whose train-mode statistics
    are those of the global batch over ``group`` (None: the default
    process group).  Eval mode and the state-dict keys are
    ``nn.BatchNorm2d``'s."""

    def __init__(self, num_features, eps=1e-5, momentum=0.1, group=None):
        super().__init__(num_features, eps=eps, momentum=momentum)
        self.group = group

    def forward(self, x):
        if not self.training:
            return nn.BatchNorm2d.forward(self, x)
        mean, var, count = global_batch_stats(x, self.eps, self.group)
        if self.update_stats:
            with torch.no_grad():
                dt = self.running_mean.dtype
                self.running_mean.lerp_(mean.to(dt), self.momentum)
                self.running_var.lerp_(var.to(dt), self.momentum)
                self.num_batches_tracked.add_(1)
        return _GlobalBatchNorm.apply(x, self.weight, self.bias, mean, var,
                                      count, self.eps, self.group)


def convert_batchnorm(module: nn.Module, group=None) -> nn.Module:
    """Put a :class:`GlobalBatchNorm2d` in place of every
    :class:`..models.layers.BatchNorm2d` under ``module`` (in place;
    returns ``module``).  Each takes the old layer's parameter and buffer
    tensors themselves, so the state-dict keys, an optimizer built over
    the parameters and a model sharing the tensors all stay valid."""
    for name, child in list(module.named_children()):
        if isinstance(child, BatchNorm2d) and not isinstance(
                child, GlobalBatchNorm2d):
            new = GlobalBatchNorm2d(child.num_features, child.eps,
                                    child.momentum, group)
            new.weight, new.bias = child.weight, child.bias
            for buf in ("running_mean", "running_var", "num_batches_tracked"):
                setattr(new, buf, getattr(child, buf))
            new.update_stats = child.update_stats
            new.train(child.training)
            setattr(module, name, new)
        else:
            convert_batchnorm(child, group)
    return module
