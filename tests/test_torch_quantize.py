"""The port's int8 PTQ (``udp_pose_tpu_torch/models/quantize.py`` and the
plain versions of ``ops/int8_conv.py``) against the JAX package's
``models/quantize.py`` on the CPU.

The int8 arithmetic is held bit for bit: weight quantisation, the int32
accumulators of quantise → im2col → integer GEMM against
``lax.conv_general_dilated(..., preferred_element_type=int32)``, and the
dequantised output of a one-conv module.  On the reduced HRNet and on
YOLOv5n the calibration tables, the engaged sites and the outputs agree
with the JAX package's; tables written by either package load in the
other.  Flax variables are made in numpy (no init compiles).

The JAX side runs eagerly, so its weight scales are ``max|w| / 127``
as written.  (Under ``jit``, as in its ``prepare_variables``, XLA turns
that division into a multiply by ``f32(1/127)``, which lands one ulp off
for some channels; the port divides.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from jax import lax

from test_torch_hrnet import reduced_cfg
from test_torch_yolov5 import few_threads  # noqa: F401 (autouse)
from test_torch_yolov5 import numpy_variables
from udp_pose_tpu.config import default_config as jax_default_config
from udp_pose_tpu.models import build_model as jax_build_model
from udp_pose_tpu.models import quantize as jq
from udp_pose_tpu.models.yolov5 import YOLOv5 as JaxYOLOv5
from udp_pose_tpu_torch.config import default_config
from udp_pose_tpu_torch.engine.pose_engine import UdpPosePipeline
from udp_pose_tpu_torch.models import build_detector, build_model
from udp_pose_tpu_torch.models import quantize as tq
from udp_pose_tpu_torch.ops import int8_conv
from udp_pose_tpu_torch.utils.convert import (conv_sites, state_dict_to_torch,
                                              variables_to_state_dict,
                                              yolov5_variables_to_state_dict)

# fp32 heatmaps of the reduced HRNet, int8 in both packages.  Each int8
# site is exact given the same input (test_quantized_model_equals_jax),
# but the float passes between the convs (BN, adds) differ in XLA and
# PyTorch by ulps, and where that moves an activation across a rounding
# tie of the next quantiser its int8 value differs by one step; the step
# then cascades through the later sites.  Measured 0.175 of a largest
# |heatmap| of 8.59 (2.0%) against an int8-vs-float drift of 0.388 (4.5%).
HEATMAP_REL = 0.05
CONV_CASES = [  # (kernel, stride, padding, cin, cout)
    (3, 1, 1, 16, 32), (3, 2, 1, 16, 24), (1, 1, 0, 32, 16), (6, 2, 2, 3, 16)]


def _flax_pose_paths(tree, prefix=()):
    """Flax paths (``a/b/conv``) of every conv kernel in a params tree."""
    out = []
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out += _flax_pose_paths(v, prefix + (k,))
        elif k == "kernel":
            out.append("/".join(prefix))
    return out


@pytest.fixture(scope="module")
def hrnet():
    """(jax model, numpy variables, port model with the same weights on
    the CPU, port cfg, two normalised-like input batches NHWC)."""
    jcfg = reduced_cfg(jax_default_config)
    jmodel = jax_build_model(jcfg)
    v = numpy_variables(jmodel, (1, 64, 64, 3), seed=3)
    cfg = reduced_cfg(default_config)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(state_dict_to_torch(variables_to_state_dict(v, cfg)),
                          strict=True)
    rng = np.random.default_rng(5)
    batches = [rng.normal(size=(2, 64, 64, 3)).astype(np.float32) * s
               for s in (1.0, 1.5)]
    table = jq.calibrate(jmodel, v, [jnp.asarray(b) for b in batches])
    return jmodel, v, model, cfg, batches, table


def _nchw(x):
    return torch.from_numpy(np.array(x)).permute(0, 3, 1, 2)


def _one_conv(k, s, p, cin, cout, bias, seed):
    """A one-conv flax module named ``conv``, its numpy variables, and the
    torch conv with the same weights."""
    class One(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return fnn.Conv(cout, (k, k), strides=(s, s),
                            padding=((p, p), (p, p)), use_bias=bias,
                            name="conv")(x)

    rng = np.random.default_rng(seed)
    kernel = rng.normal(0, 1 / np.sqrt(k * k * cin),
                        (k, k, cin, cout)).astype(np.float32)
    params = {"kernel": kernel}
    conv = torch.nn.Conv2d(cin, cout, k, s, p, bias=bias)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
        if bias:
            params["bias"] = rng.normal(0, 0.5, cout).astype(np.float32)
            conv.bias.copy_(torch.from_numpy(params["bias"]))
    return One(), {"params": {"conv": params}}, conv


def test_quantize_kernel_bit_equal_jax():
    """int8 values and scales equal, an all-zero output channel included
    (its scale takes the 1e-12 floor)."""
    rng = np.random.default_rng(0)
    kernel = rng.normal(0, 0.2, (3, 3, 16, 8)).astype(np.float32)
    kernel[..., 5] = 0.0
    kernel[0, 0, 0, 2] = 7.5            # one outlier sets its channel's scale
    w_j, s_j = jq.quantize_kernel(jnp.asarray(kernel))
    w_t, s_t = tq.quantize_kernel(torch.from_numpy(
        kernel.transpose(3, 2, 0, 1)))
    assert w_t.dtype == torch.int8 and s_t.dtype == torch.float32
    np.testing.assert_array_equal(w_t.numpy().transpose(2, 3, 1, 0),
                                  np.asarray(w_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    assert s_t[5] == np.float32(1e-12) and not w_t[5].any()


@pytest.mark.parametrize("k,s,p,cin,cout", CONV_CASES)
def test_int32_accumulators_equal_xla_int8_conv(k, s, p, cin, cout):
    """quantise → im2col → integer GEMM gives XLA's int8 conv's int32
    accumulators exactly (the GEMM's padded rows and columns are 0)."""
    _, v, conv = _one_conv(k, s, p, cin, cout, False, seed=k + s + cin)
    x = np.random.default_rng(1).normal(0, 2, (2, 13, 11, cin)).astype(
        np.float32)
    amax = float(np.abs(x).max()) * 0.6          # some inputs saturate
    layer = tq.Int8Conv2d(conv, amax)
    s_a = max(amax, 1e-12) / 127.0
    x_i8 = jnp.clip(jnp.round(jnp.asarray(x) * (1.0 / s_a)), -127,
                    127).astype(jnp.int8)
    w_i8, _ = jq.quantize_kernel(jnp.asarray(v["params"]["conv"]["kernel"]))
    dn = lax.conv_dimension_numbers(x_i8.shape, w_i8.shape,
                                    ("NHWC", "HWIO", "NHWC"))
    want = np.asarray(lax.conv_general_dilated(
        x_i8, w_i8, (s, s), ((p, p), (p, p)), dimension_numbers=dn,
        preferred_element_type=jnp.int32))
    patches = int8_conv.quant_im2col(_nchw(x), layer.inv_s_a,
                                     layer.kernel_size, layer.stride,
                                     layer.padding, layer.k_pad)
    assert patches.dtype == torch.int8 and layer.k_pad % 8 == 0
    acc = int8_conv.int8_gemm(patches, layer.w_gemm)
    N, Ho, Wo, _ = want.shape
    M = N * Ho * Wo
    assert acc.dtype == torch.int32 and acc.shape[0] >= 17
    np.testing.assert_array_equal(acc[:M, :cout].numpy().reshape(want.shape),
                                  want)
    assert not acc[M:].any() and not acc[:, cout:].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("k,s,p,cin,cout", CONV_CASES)
def test_dequantised_output_equals_jax_quantized_model(k, s, p, cin, cout,
                                                       bias, dtype):
    """The port's ``Int8Conv2d`` output is bit for bit the JAX
    ``QuantizedModel``'s on a one-conv module, in its dtype and as a
    channels-last view."""
    module, v, conv = _one_conv(k, s, p, cin, cout, bias, seed=cin + cout)
    x = np.random.default_rng(2).normal(0, 1.5, (2, 12, 10, cin)).astype(
        np.float32)
    xj = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    amax = float(np.abs(x).max()) * 0.8
    qm = jq.QuantizedModel(module, {"conv": amax})
    want = np.asarray(qm.apply(v, xj))
    assert qm.engaged == {"conv"}
    xt = _nchw(np.asarray(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    got = tq.Int8Conv2d(conv, amax)(xt)
    assert got.dtype == xt.dtype
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(
        got.float().permute(0, 2, 3, 1).numpy(),
        np.asarray(jnp.asarray(want).astype(jnp.float32)))


def test_conv_sites_are_the_flax_paths(hrnet):
    """Every conv of the port's HRNet and YOLOv5n has a site, and the
    sites are exactly the flax modules holding a conv kernel."""
    jmodel, v, model, *_ = hrnet
    for port, params in (
            (model, v["params"]),
            (build_detector("n", device="cpu"),
             numpy_variables(JaxYOLOv5("n"), (1, 64, 64, 3))["params"])):
        sites = conv_sites(port)
        convs = {n for n, m in port.named_modules()
                 if isinstance(m, torch.nn.Conv2d)}
        assert set(sites) == convs
        assert sorted(sites.values()) == sorted(_flax_pose_paths(params))
    assert conv_sites(model)["stage2.0.branches.0.0.conv1"] == \
        "stage2_0/branch0_0/cb1/conv"


def test_calibrate_equals_jax(hrnet):
    """Same keys (final_layer skipped) and amax within 1e-5 relative."""
    _, _, model, _, batches, table = hrnet
    got = tq.calibrate(model, [_nchw(b) for b in batches])
    assert sorted(got) == sorted(table)
    assert "final_layer" not in got and len(got) == len(conv_sites(model)) - 1
    for k in table:
        np.testing.assert_allclose(got[k], table[k], rtol=1e-5, err_msg=k)


def test_quantized_model_equals_jax(hrnet):
    """The JAX table serves the port: the same engaged sites and
    ``final_layer`` in float.  Every int8 site, fed the input it gets
    inside the JAX ``QuantizedModel``, gives the JAX output bit for bit;
    the fp32 heatmaps agree within ``HEATMAP_REL`` of the largest
    |value|."""
    jmodel, v, model, _, batches, table = hrnet
    table = dict(table, final_layer=3.0)      # present, but skipped
    jqm = jq.QuantizedModel(jmodel, table)
    seen = {}

    def record(next_fun, args, kwargs, context):
        """``jqm``'s own interceptor, keeping each int8 site's input and
        output (one eager apply of the JAX ``QuantizedModel``)."""
        y = jqm._interceptor(next_fun, args, kwargs, context)
        path = jq._path_of(context.module)
        if path in jqm.engaged and path not in seen:
            seen[path] = (np.asarray(args[0]), np.asarray(y))
        return y

    with fnn.intercept_methods(record):
        want = np.asarray(jmodel.apply(v, jnp.asarray(batches[1]),
                                       train=False))
    qm = tq.QuantizedModel(model, table)
    assert qm.engaged == jqm.engaged == set(seen)
    assert "final_layer" not in qm.engaged
    assert type(qm.net.final_layer) is torch.nn.Conv2d
    assert qm.net.final_layer.weight is model.final_layer.weight
    sites = {p: n for n, p in conv_sites(model).items()}
    for path, (site_in, site_out) in seen.items():
        with torch.inference_mode():
            got = qm.net.get_submodule(sites[path])(_nchw(site_in))
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                      site_out, err_msg=path)
    with torch.inference_mode():
        got = qm(_nchw(batches[1])).permute(0, 2, 3, 1).numpy()
    err = np.abs(got - want).max()
    assert err <= HEATMAP_REL * np.abs(want).max(), err
    # the wrapper shares the model's tensors and leaves its convs alone
    own = {id(t) for t in model.parameters()} | {id(t)
                                                 for t in model.buffers()}
    assert all(id(t) in own for t in qm.parameters())
    assert all(type(m) is not tq.Int8Conv2d for m in model.modules())


def test_empty_table_is_the_fp_model_bit_for_bit(hrnet):
    _, _, model, _, batches, _ = hrnet
    qm = tq.QuantizedModel(model, {})
    assert qm.engaged == set()
    with torch.inference_mode():
        x = _nchw(batches[0])
        assert torch.equal(qm(x), model(x))


def test_act_scales_json_interchange(hrnet, tmp_path):
    """A table written by either package loads in the other and engages
    the same sites."""
    jmodel, v, model, _, batches, table = hrnet
    jq.save_act_scales(str(tmp_path / "jax.json"), table)
    from_jax = tq.load_act_scales_maybe(str(tmp_path / "jax.json"))
    assert from_jax == table
    port_table = tq.calibrate(model, [_nchw(b) for b in batches])
    tq.save_act_scales(str(tmp_path / "port.json"), port_table)
    assert jq.load_act_scales(str(tmp_path / "port.json")) == port_table
    assert (tq.QuantizedModel(model, from_jax).engaged
            == tq.QuantizedModel(model, port_table).engaged)


def test_min_in_channels_and_refusals(hrnet):
    _, _, model, _, _, table = hrnet
    qm = tq.QuantizedModel(model, table, min_in_channels=64)
    assert "stem1/conv" not in qm.engaged                     # Cin 3
    assert "stage4_0/branch3_0/cb1/conv" in qm.engaged        # Cin 128
    with pytest.raises(NotImplementedError, match="grouped"):
        tq.Int8Conv2d(torch.nn.Conv2d(8, 8, 3, groups=2), 1.0)


def test_yolov5n_engaged_sites_equal_jax():
    """YOLOv5n at det-size 128: the detect heads stay float in both
    packages, every other site runs int8, and the outputs agree."""
    jmodel = JaxYOLOv5("n")
    v = numpy_variables(jmodel, (1, 64, 64, 3), seed=4)
    model = build_detector("n", device="cpu")
    model.load_state_dict(state_dict_to_torch(
        yolov5_variables_to_state_dict(v)), strict=True)
    x = np.random.default_rng(6).uniform(0, 1, (1, 128, 128, 3)).astype(
        np.float32)
    jtable = jax.device_get(jax.jit(lambda v, x: jq.collect_conv_amax(
        jmodel, v, x, train=False))(v, jnp.asarray(x)))
    table = tq.collect_conv_amax(model, _nchw(x))
    assert sorted(table) == sorted(jtable)
    assert {k for k in table if k.startswith("detect")} == {
        "detect0", "detect1", "detect2"}
    jqm = jq.QuantizedModel(jmodel, jtable)
    want = np.asarray(jax.jit(lambda v, x: jqm.apply(v, x, train=False))(
        v, jnp.asarray(x)))
    qm = tq.QuantizedModel(model, {k: float(a) for k, a in jtable.items()})
    assert qm.engaged == jqm.engaged
    assert len(qm.engaged) == len(table) - 3
    with torch.inference_mode():
        got = qm(_nchw(x)).numpy()
    for sl in (slice(0, 4), slice(4, None)):
        err = np.abs(got[..., sl] - want[..., sl]).max()
        assert err <= 1e-4 * np.abs(want[..., sl]).max(), err


# ---------------------------------------------------------------- engines

def _crops(n, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, 64, 64, 3),
                                                dtype=np.uint8)


def _cs(n):
    return (np.tile([[32.0, 32.0]], (n, 1)).astype(np.float32),
            np.tile([[0.32, 0.32]], (n, 1)).astype(np.float32))


def test_pipeline_lazy_int8_calibration(hrnet, tmp_path):
    """The first ``calib_batches`` calls serve in float (equal to the fp
    pipeline's results) while recording the padded bucket's amax; then
    the pipeline serves int8 through the table it froze."""
    _, v, model, cfg, _, _ = hrnet
    fp = UdpPosePipeline(cfg, v, device="cpu")
    q = UdpPosePipeline(cfg, v, device="cpu", quantize="int8",
                        calib_batches=2)
    assert q.int8.calibrating and q.int8.quantize == "int8"
    with pytest.raises(RuntimeError, match="not calibrated"):
        q.save_act_scales(str(tmp_path / "t.json"))
    batches = [_crops(3, 1), _crops(4, 2)]
    for b in batches:
        got, want = q.infer_crops(b, *_cs(len(b))), fp.infer_crops(
            b, *_cs(len(b)))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert not q.int8.calibrating and q.int8.qmodel is None
    # the table: each padded bucket (4 rows, the first crop repeated)
    # through the stem, every site, final_layer included (engines
    # collect with no skip, as the JAX package's do)
    want_table = tq.Calibrator(2)
    for b in batches:
        padded = np.concatenate([b, np.repeat(b[:1], 4 - len(b), 0)])
        x = (torch.from_numpy(padded).float() / 255.0 - torch.tensor(
            [0.485, 0.456, 0.406])) / torch.tensor([0.229, 0.224, 0.225])
        want_table.update(tq.collect_conv_amax(model, x.permute(0, 3, 1, 2)))
    assert q.int8.table == want_table.table()
    assert "final_layer" in q.int8.table
    kp, mv = q.infer_crops(batches[0], *_cs(3))
    assert len(q.int8.qmodel.engaged) == len(q.int8.table) - 1
    qm = tq.QuantizedModel(model, q.int8.table)
    ref = UdpPosePipeline(cfg, v, device="cpu")
    ref._infer_fp = ref._make_infer(qm)
    want_kp, want_mv = ref.infer_crops(batches[0], *_cs(3))
    np.testing.assert_array_equal(kp, want_kp)
    np.testing.assert_array_equal(mv, want_mv)
    q.save_act_scales(str(tmp_path / "t.json"))
    assert jq.load_act_scales(str(tmp_path / "t.json")) == q.int8.table


def test_pipeline_table_gating(hrnet, tmp_path):
    """A table asks for int8; an explicit ``quantize=""`` wins over it;
    ``TPU.QUANTIZE`` applies without either; unknown modes raise."""
    _, v, _, cfg, _, table = hrnet
    tq.save_act_scales(str(tmp_path / "t.json"), table)
    by_path = UdpPosePipeline(cfg, v, device="cpu",
                              act_scales=str(tmp_path / "t.json"))
    assert by_path.int8.quantize == "int8" and not by_path.int8.calibrating
    assert by_path.active_infer() is not by_path._infer_fp
    assert by_path.int8.qmodel.engaged == set(table)
    off = UdpPosePipeline(cfg, v, device="cpu", quantize="", act_scales=table)
    assert off.active_infer() is off._infer_fp
    qcfg = cfg.clone()
    qcfg.TPU.QUANTIZE = "int8"
    assert UdpPosePipeline(qcfg, v, device="cpu").int8.calibrating
    with pytest.raises(ValueError, match="quantize mode"):
        UdpPosePipeline(cfg, v, device="cpu", quantize="int4")
