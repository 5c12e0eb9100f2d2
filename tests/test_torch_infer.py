"""The port's serving graph (``core/infer.make_infer_fn``) against the JAX
package's, on the reduced HRNet with bridged weights, fp32 on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_hrnet import bridged_pair
from test_torch_yolov5 import few_threads  # noqa: F401 (autouse)
from udp_pose_tpu.core.infer import make_infer_fn as jax_make_infer_fn
from udp_pose_tpu_torch.core.infer import (make_infer_fn,
                                           make_infer_fn_from_cfg)
from udp_pose_tpu_torch.ops import decode
from udp_pose_tpu_torch.ops.blur import gaussian_blur

HM_ATOL = 1e-4      # fp32 heatmaps: conv summation order, XLA vs PyTorch
B = 4


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(3)
    images = rng.integers(0, 256, (B, 64, 64, 3)).astype(np.uint8)
    center = rng.uniform(50, 150, (B, 2)).astype(np.float32)
    # scale·200 ≈ 64: one source px per input-crop px, so the px
    # tolerances below are crop px
    scale = rng.uniform(0.3, 0.34, (B, 2)).astype(np.float32)
    return images, center, scale


@pytest.fixture(scope="module", params=["offset", "gaussian"])
def runs(request, inputs):
    """Both packages' (preds, maxvals, heatmaps) for both flip modes."""
    target_type = request.param
    jmodel, variables, model, cfg = bridged_pair(target_type)
    out = {}
    for mode in ("fold", "two_pass"):
        jinfer = jax_make_infer_fn(jmodel, target_type=target_type,
                                   flip_test=True, post_process=True,
                                   flip_mode=mode)
        infer = make_infer_fn(model, target_type=target_type,
                              flip_test=True, post_process=True,
                              flip_mode=mode)
        out[mode] = (tuple(np.asarray(a) for a in jinfer(variables, *inputs)),
                     tuple(t.numpy() for t in infer(*inputs)))
    return target_type, model, cfg, out


def test_heatmaps_match_jax(runs):
    _, _, _, out = runs
    for mode, (gold, got) in out.items():
        assert got[2].shape == gold[2].shape, mode
        np.testing.assert_allclose(got[2], gold[2], rtol=0, atol=HM_ATOL,
                                   err_msg=mode)


def test_decode_of_jax_heatmaps_matches_jax(runs, inputs):
    """Same heatmaps in.  The blurs sum in another order than XLA's
    einsum, so: maxvals to 1e-6 (absolute; the offset decode's maxvals
    are blurred values), coords to 1e-4 px for the offset decode and
    1e-3 px for DARK, whose Newton step divides by the Hessian's
    determinant and so magnifies that rounding on the flat maps of a
    randomly initialised net (joints where it magnifies it past the
    tolerance are left out, as in ``_ambiguous_joints``)."""
    target_type, _, _, out = runs
    _, center, scale = inputs
    gold, _ = out["fold"]
    preds, maxvals, _ = decode.get_final_preds(
        torch.from_numpy(gold[2].copy()), torch.from_numpy(center),
        torch.from_numpy(scale), target_type=target_type, kpd=4.0)
    np.testing.assert_allclose(maxvals.numpy(), gold[1], rtol=0, atol=1e-6)
    ok = ~_ambiguous_joints(gold[2], 0.0, target_type, center, scale)
    np.testing.assert_allclose(preds.numpy()[ok], gold[0][ok], rtol=0,
                               atol=1e-4 if target_type == "offset" else 1e-3)


def _ambiguous_joints(hm, hm_err, target_type, center, scale):
    """(B, J) mask of joints whose decode is not fixed to 1e-3 px by
    heatmaps known to ±``hm_err``: the top two values of the decoded map
    lie within 2·hm_err, the peak lies within hm_err of the mask
    threshold 0, or the decoded coords move by more than 1e-3 px when
    seeded noise of that size is added (DARK's Newton step on a
    near-singular Hessian, common on a random net's flat maps).  hm_err
    is taken as at least 1e-5, which covers the last-bit differences of
    the float32 reductions between runs."""
    hm_err = max(hm_err, 1e-5)
    maps = torch.from_numpy(hm.copy())
    peak_maps = (gaussian_blur(maps[:, 0::3], 15)
                 if target_type == "offset" else maps)
    top2 = peak_maps.flatten(2).topk(2, dim=2).values.numpy()
    amb = ((top2[..., 0] - top2[..., 1] < 2 * hm_err)
           | (np.abs(top2[..., 0]) < hm_err))
    c, s = torch.from_numpy(center), torch.from_numpy(scale)
    base = decode.get_final_preds(maps, c, s, target_type=target_type)[0]
    for seed in range(3):
        noise = torch.from_numpy(np.random.default_rng(seed).uniform(
            -hm_err, hm_err, hm.shape).astype(np.float32))
        for sign in (1.0, -1.0):
            moved = decode.get_final_preds(maps + sign * noise, c, s,
                                           target_type=target_type)[0]
            amb |= ((moved - base).abs().amax(-1) > 1e-3).numpy()
    return amb


def _assert_preds_close(got, gold, hm_err, target_type, inputs, what):
    """1e-3 px and HM_ATOL-close maxvals on the joints that
    ``_ambiguous_joints`` does not flag; those are reported, and few."""
    amb = _ambiguous_joints(gold[2], hm_err, target_type, *inputs[1:])
    print(f"{what}: {int(amb.sum())} of {amb.size} joints ambiguous at "
          f"heatmap error {hm_err:.3g}")
    assert amb.sum() <= amb.size // 4, what
    ok = ~amb
    np.testing.assert_allclose(got[0][ok], gold[0][ok], rtol=0, atol=1e-3,
                               err_msg=what)
    np.testing.assert_allclose(got[1][ok], gold[1][ok], rtol=0,
                               atol=HM_ATOL, err_msg=what)


def test_end_to_end_preds_match_jax(runs, inputs):
    target_type, _, _, out = runs
    for mode, (gold, got) in out.items():
        hm_err = float(np.abs(got[2] - gold[2]).max())
        _assert_preds_close(got, gold, hm_err, target_type, inputs,
                            f"{target_type}/{mode} vs JAX")


def test_two_pass_equals_fold(runs, inputs):
    target_type, _, _, out = runs
    fold, two = out["fold"][1], out["two_pass"][1]
    np.testing.assert_allclose(two[2], fold[2], rtol=0, atol=1e-5)
    _assert_preds_close(two, fold, float(np.abs(two[2] - fold[2]).max()),
                        target_type, inputs, f"{target_type} two_pass/fold")


def test_make_infer_fn_from_cfg_and_options(runs, inputs):
    target_type, model, cfg, out = runs
    cfg.TEST.FLIP_TEST = True
    cfg.TEST.POST_PROCESS = True
    got = [t.numpy() for t in make_infer_fn_from_cfg(model, cfg)(*inputs)]
    fold = out["fold"][1]
    np.testing.assert_allclose(got[2], fold[2], rtol=0, atol=1e-5)
    _assert_preds_close(got, fold, float(np.abs(got[2] - fold[2]).max()),
                        target_type, inputs, f"{target_type} from_cfg")
    infer = make_infer_fn(model, target_type=target_type, flip_test=False,
                          return_heatmaps=False)
    preds, maxvals, hm = infer(*inputs)
    assert hm is None
    assert preds.shape == (B, 17, 2) and maxvals.shape == (B, 17, 1)
    with pytest.raises(ValueError, match="flip_mode"):
        make_infer_fn(model, flip_mode="sideways")
