"""Model summary and profiling (port of ``udp_pose_tpu/utils/summary.py``;
parity: deep_hrnet lib/utils/utils.py:113-229 ``get_model_summary``).

The parameter count is the model's parameters (the JAX package's
``params`` leaves: BatchNorm's running statistics are buffers and do not
count).  FLOPs come from ``torch.utils.flop_counter.FlopCounterMode`` over
one forward: it counts the matrix products and convolutions (2 per
multiply-add), as the reference's hook estimate does, where the JAX
package reads XLA's cost analysis of the compiled graph, which also
counts elementwise work.  :func:`profile_trace` is a ``torch.profiler``
context that writes a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os

import torch


def count_params(model) -> int:
    """The number of parameter elements of ``model``."""
    return int(sum(p.numel() for p in model.parameters()))


def model_flops(model, input_shape) -> float:
    """FLOPs of one eval-mode forward of ``model`` on zeros of
    ``input_shape`` (B, H, W, 3), in the model's dtype and device."""
    from torch.utils.flop_counter import FlopCounterMode
    p = next(model.parameters())
    x = torch.zeros(input_shape, dtype=p.dtype, device=p.device)
    was_training = model.training
    model.eval()
    counter = FlopCounterMode(display=False)
    try:
        with torch.no_grad(), counter:
            model(x.permute(0, 3, 1, 2))
    finally:
        model.train(was_training)
    return float(counter.get_total_flops())


def get_model_summary(model, input_shape) -> str:
    n_params = count_params(model)
    flops = model_flops(model, input_shape)
    return (f"params: {n_params / 1e6:.2f}M  "
            f"fwd flops @ {tuple(input_shape)}: {flops / 1e9:.2f} GFLOPs")


@contextlib.contextmanager
def profile_trace(logdir="log/torch_trace"):
    """Profile the host and, where there is one, the card inside the
    context; write ``<logdir>/trace.json`` (Chrome trace format) at its
    end and yield the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
