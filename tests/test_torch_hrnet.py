"""The PyTorch port's HRNet and weight bridge against the JAX package.

A reduced HRNet (widths 16-128, one block per branch, 64×64 input, UDP
offset head) is initialised in flax on the CPU; its variables are bridged
into the port with ``variables_to_state_dict`` and loaded with
``strict=True``; both run the same numpy-seeded input in float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from udp_pose_tpu.config import default_config as jax_default_config
from udp_pose_tpu.models import build_model as jax_build_model
from udp_pose_tpu.utils.torch_convert import flax_to_torch_from_cfg
from udp_pose_tpu_torch.config import default_config
from udp_pose_tpu_torch.models import build_model
from udp_pose_tpu_torch.models.hrnet import PoseHRNet, stages_from_cfg
from udp_pose_tpu_torch.utils.convert import (state_dict_to_torch,
                                              variables_to_state_dict)

# the reduced HRNet of tests/test_models.py (remat test), offset head
REDUCED_EXTRA = {
    "FINAL_CONV_KERNEL": 1,
    "STAGE2": {"NUM_MODULES": 1, "NUM_BRANCHES": 2, "BLOCK": "BASIC",
               "NUM_BLOCKS": [1, 1], "NUM_CHANNELS": [16, 32],
               "FUSE_METHOD": "SUM"},
    "STAGE3": {"NUM_MODULES": 1, "NUM_BRANCHES": 3, "BLOCK": "BASIC",
               "NUM_BLOCKS": [1, 1, 1], "NUM_CHANNELS": [16, 32, 64],
               "FUSE_METHOD": "SUM"},
    "STAGE4": {"NUM_MODULES": 1, "NUM_BRANCHES": 4, "BLOCK": "BASIC",
               "NUM_BLOCKS": [1, 1, 1, 1],
               "NUM_CHANNELS": [16, 32, 64, 128], "FUSE_METHOD": "SUM"},
}


def reduced_cfg(default_config_fn, target_type="offset"):
    """The reduced HRNet config (fp32) from either package's defaults."""
    cfg = default_config_fn()
    cfg.MODEL.NAME = "pose_hrnet"
    cfg.MODEL.TARGET_TYPE = target_type
    cfg.MODEL.IMAGE_SIZE = [64, 64]
    cfg.MODEL.HEATMAP_SIZE = [16, 16]
    cfg.TPU.DTYPE = "float32"
    cfg.MODEL.EXTRA.merge_from_dict(REDUCED_EXTRA)
    return cfg


def bridged_pair(target_type="offset", seed=0):
    """(jax model, jax variables, port model on CPU with the same weights,
    port cfg)."""
    jcfg = reduced_cfg(jax_default_config, target_type)
    jmodel = jax_build_model(jcfg)
    variables = jax.jit(lambda r: jmodel.init(
        r, jnp.zeros((1, 64, 64, 3)), train=False))(jax.random.PRNGKey(seed))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    cfg = reduced_cfg(default_config, target_type)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(
        state_dict_to_torch(variables_to_state_dict(variables, cfg)),
        strict=True)
    return jmodel, variables, model, cfg


@pytest.fixture(scope="module")
def pair():
    return bridged_pair()


def test_bridged_state_dict_loads_strict_and_equals_jax_reverse(pair):
    jmodel, variables, model, cfg = pair
    sd = variables_to_state_dict(variables, cfg)
    gold = flax_to_torch_from_cfg(variables,
                                  reduced_cfg(jax_default_config))
    assert sorted(sd) == sorted(gold)
    assert sorted(sd) == sorted(model.state_dict())
    for k in gold:
        np.testing.assert_array_equal(sd[k], np.asarray(gold[k]), err_msg=k)
        assert sd[k].shape == tuple(model.state_dict()[k].shape), k
    # strict=True load reports nothing missing or unexpected
    res = model.load_state_dict(state_dict_to_torch(sd), strict=True)
    assert not res.missing_keys and not res.unexpected_keys


def test_reduced_hrnet_fp32_output_matches_jax(pair):
    """fp32 on the CPU on both sides: atol 1e-4 (summation order of the
    convs differs between XLA and PyTorch's CPU kernels)."""
    jmodel, variables, model, _ = pair
    x = np.random.default_rng(0).normal(size=(2, 64, 64, 3)).astype(
        np.float32)
    gold = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))
    with torch.inference_mode():
        out = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert out.dtype == torch.float32
    assert out.shape == (2, 51, 16, 16)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), gold,
                               atol=1e-4, rtol=0)


def test_w32_parameter_count():
    """HRNet-w32 + UDP offset: 28.7M parameters (tests/test_models.py)."""
    cfg = default_config()
    cfg.MODEL.NAME = "pose_hrnet"
    cfg.MODEL.TARGET_TYPE = "offset"
    cfg.MODEL.EXTRA.merge_from_dict({
        "FINAL_CONV_KERNEL": 1,
        "STAGE2": {"NUM_MODULES": 1, "NUM_BRANCHES": 2, "BLOCK": "BASIC",
                   "NUM_BLOCKS": [4, 4], "NUM_CHANNELS": [32, 64]},
        "STAGE3": {"NUM_MODULES": 4, "NUM_BRANCHES": 3, "BLOCK": "BASIC",
                   "NUM_BLOCKS": [4, 4, 4], "NUM_CHANNELS": [32, 64, 128]},
        "STAGE4": {"NUM_MODULES": 3, "NUM_BRANCHES": 4, "BLOCK": "BASIC",
                   "NUM_BLOCKS": [4, 4, 4, 4],
                   "NUM_CHANNELS": [32, 64, 128, 256]},
    })
    model = PoseHRNet(stages_from_cfg(cfg), num_joints=17,
                      target_type="offset")
    n = sum(p.numel() for p in model.parameters())
    assert abs(n - 28.7e6) / 28.7e6 < 0.01, n
    assert model.final_layer.weight.shape == (51, 128, 1, 1)


def test_registry_refuses_unported_models():
    cfg = reduced_cfg(default_config)
    for name in ("pose_mobilenetv3_large", "pose_mobilenetv3"):
        cfg.MODEL.NAME = name
        with pytest.raises(KeyError, match="pose_hrnet"):
            build_model(cfg, device="cpu")


def test_pipeline_loads_jax_variables_and_reference_pth(pair, tmp_path):
    """``UdpPosePipeline`` weights: the JAX package's variables dict, and a
    reference ``.pth`` checkpoint (``state_dict`` wrapper, DataParallel
    ``module.`` prefixes) give the bridged model's weights."""
    from udp_pose_tpu_torch.engine.pose_engine import UdpPosePipeline
    _, variables, model, cfg = pair
    want = model.state_dict()
    from_jax = UdpPosePipeline(cfg, weights=variables, device="cpu")
    path = tmp_path / "w.pth"
    torch.save({"state_dict": {"module." + k: v for k, v in want.items()}},
               path)
    from_pth = UdpPosePipeline(cfg, weights=str(path), device="cpu")
    for pipe in (from_jax, from_pth):
        got = pipe.model.state_dict()
        assert sorted(got) == sorted(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    with pytest.raises(ValueError, match=".pth"):
        UdpPosePipeline(cfg, weights=str(tmp_path / "w.msgpack"),
                        device="cpu")
