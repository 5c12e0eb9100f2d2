"""The port's standalone engine and its ONNX backend against the JAX
package's, on the CPU.

A reduced HRNet (Gaussian head, as the reference's standalone engine
decodes: a plain argmax of each map) is exported once; the JAX package's
``StandalonePoseEngine`` over its ``onnx_model_fn`` and the port's over
its own, on the CPU, give the same keypoints and scores for the same
frame and boxes, to the bit, with more persons than the graph's batch
(chunked and zero-padded) and an empty box.
"""

import numpy as np
import pytest
import torch

from test_torch_hrnet import reduced_cfg
from test_torch_yolov5 import few_threads  # noqa: F401 (autouse)
from test_torch_zoo import seeded_state_dict
from udp_pose_tpu.engine.standalone import \
    StandalonePoseEngine as JaxStandalone
from udp_pose_tpu.engine.standalone import onnx_model_fn as jax_model_fn
from udp_pose_tpu_torch.config import default_config
from udp_pose_tpu_torch.engine.standalone import (StandalonePoseEngine,
                                                  onnx_model_fn)
from udp_pose_tpu_torch.export import export_onnx_from_cfg
from udp_pose_tpu_torch.models import build_model


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    cfg = reduced_cfg(default_config, "gaussian")
    model = build_model(cfg, device="cpu")
    blob = export_onnx_from_cfg(seeded_state_dict(model, 4), cfg, batch=2)
    path = tmp_path_factory.mktemp("standalone") / "hrnet.onnx"
    path.write_bytes(blob)
    return str(path), blob


def test_standalone_engine_equals_jax(artifact):
    path, blob = artifact
    rng = np.random.default_rng(6)
    img = rng.integers(0, 256, (100, 140, 3), dtype=np.uint8)
    boxes = np.array([[5, 8, 60, 95], [40, 10, 139, 70], [0, 0, 30, 30],
                      [70, 50, 71, 51], [20, 20, 20, 40]], np.float32)
    got = StandalonePoseEngine(onnx_model_fn(path, device="cpu"),
                               input_wh=(64, 64)).infer_pose(img, boxes)
    want = JaxStandalone(jax_model_fn(blob),
                         input_wh=(64, 64)).infer_pose(img, boxes)
    assert got[0].shape == (5, 17, 2) and got[1].shape == (5, 17, 1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_onnx_model_fn_chunks_and_needs_a_card(artifact):
    """Five rows through a batch-2 graph: the same maps as the rows run
    two at a time; without a card the backend refuses unless asked for
    the CPU."""
    path, blob = artifact
    fn = onnx_model_fn(blob, device="cpu")
    x = np.random.default_rng(2).normal(size=(5, 64, 64, 3)).astype(
        np.float32)
    out = fn(x)
    assert out.shape == (5, 16, 16, 17)
    np.testing.assert_array_equal(out[4:], fn(x[4:]))
    np.testing.assert_array_equal(out[:2], fn(x[:2]))
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        onnx_model_fn(path)
