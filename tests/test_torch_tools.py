"""The port's user tools against the JAX package's ``tools/`` on the CPU:
``plot_coco`` (the matched-rendering selection and the drawn pixels),
``convert_weights`` (the ``.msgpack`` bytes of a reference ``.pth`` and
of a YOLOv5 state dict) and ``reproduce_zoo`` (the printed table, the
exit code, and the AP of the same weights)."""

import io
import json
import os
import sys

import cv2
import numpy as np
import pytest
import torch
import yaml

from ref_harness import make_mini_coco
from test_torch_hrnet import reduced_cfg
from tools import convert_weights as jax_convert_weights
from tools import plot_coco as jax_plot_coco
from tools import reproduce_zoo as jax_reproduce_zoo
from udp_pose_tpu_torch import convert_weights, plot_coco, reproduce_zoo
from udp_pose_tpu_torch.config import default_config
from udp_pose_tpu_torch.models import build_detector, build_model


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the suite runs several test processes at
    once, and each would otherwise start one thread per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("main,args", [
    (reproduce_zoo.main, ["--manifest", "m.json"]),
    (convert_weights.main, ["--pth", "x.pth", "--out", "x.msgpack"]),
])
def test_tools_need_the_card_unless_asked_for_the_cpu(main, args):
    """Without ``--device cpu`` a tool raises on a host with no card
    before it reads a file."""
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(args)


# ---------------------------------------------------------------- plot_coco
def _random_people(rng, image_ids, n, hw, score=True):
    """``n`` people per image: xywh boxes (some overlapping, some far
    apart, some beyond the frame) and 17 keypoints with scores or
    visibilities."""
    h, w = hw
    out = []
    for image_id in image_ids:
        for _ in range(n):
            bw, bh = rng.uniform(10, w / 2), rng.uniform(10, h / 2)
            x, y = rng.uniform(-w / 4, w), rng.uniform(-h / 4, h)
            kp = np.stack([rng.uniform(x - 5, x + bw + 40, 17),
                           rng.uniform(y - 5, y + bh + 40, 17),
                           rng.uniform(0, 1, 17) if score
                           else rng.choice([0, 1, 2], 17)], 1)
            out.append({"image_id": int(image_id), "bbox": [x, y, bw, bh],
                        "keypoints": kp.reshape(-1).tolist(),
                        "score": float(rng.uniform(0, 1)), "category_id": 1,
                        "iscrowd": int(rng.uniform() < 0.1)})
    return out


def test_matched_pairs_and_overlap_equal_jax():
    """The expanded overlap (negative spans unclamped) on every pair, and
    the selection for each image, equal the JAX functions' on seeded
    gt and dt sets, ties of score among them."""
    rng = np.random.default_rng(5)
    for trial in range(20):
        gts = _random_people(rng, [1], int(rng.integers(0, 4)), (240, 320),
                             score=False)
        dts = _random_people(rng, [1], int(rng.integers(0, 25)), (240, 320))
        if len(dts) > 2:
            dts[1]["score"] = dts[0]["score"]
        for g in gts:
            for d in dts:
                assert plot_coco.expanded_overlap(g["bbox"], d["bbox"]) == \
                    jax_plot_coco.expanded_overlap(g["bbox"], d["bbox"])
        thr = float(rng.choice([0.0, 0.3, 0.6]))
        got = plot_coco.matched_pairs(gts, dts, threshold=thr)
        want = jax_plot_coco.matched_pairs(gts, dts, threshold=thr)
        assert [(id(g), id(d)) for g, d in got] == \
            [(id(g), id(d)) for g, d in want], trial


@pytest.fixture(scope="module")
def plot_inputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("plot")
    rng = np.random.default_rng(113)
    image_dir = tmp / "images"
    image_dir.mkdir()
    ids = [7, 8, 9]
    for i in ids[:2]:               # image 9 has results but no file
        cv2.imwrite(str(image_dir / ("%012d.jpg" % i)),
                    rng.integers(0, 255, (240, 320, 3), np.uint8))
    results = _random_people(rng, ids, 4, (240, 320))
    gts = _random_people(rng, ids[:1], 3, (240, 320), score=False)
    (tmp / "results.json").write_text(json.dumps(results))
    (tmp / "gt.json").write_text(json.dumps({"annotations": gts}))
    return tmp


@pytest.mark.parametrize("style", ["chunhua", "xiaochu"])
@pytest.mark.parametrize("matched", [False, True])
def test_plot_writes_what_jax_writes(plot_inputs, tmp_path, style, matched):
    """The same files, pixel for pixel, in both styles, in threshold mode
    and in the matched-rendering mode."""
    kw = {"match_gt": str(plot_inputs / "gt.json")} if matched else {}
    args = (str(plot_inputs / "results.json"), str(plot_inputs / "images"))
    n = plot_coco.plot(*args, str(tmp_path / "port"), style, **kw)
    n_jax = jax_plot_coco.plot(*args, str(tmp_path / "jax"), style, **kw)
    assert n == n_jax == (1 if matched else 2)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    for name in names:
        got = cv2.imread(str(tmp_path / "port" / name))
        want = cv2.imread(str(tmp_path / "jax" / name))
        np.testing.assert_array_equal(got, want)
        assert (got != cv2.imread(str(plot_inputs / "images" / name))).any()


def test_plot_main_takes_the_jax_flags(plot_inputs, tmp_path, capsys):
    n = plot_coco.main(["--results", str(plot_inputs / "results.json"),
                        "--image-dir", str(plot_inputs / "images"),
                        "--save-dir", str(tmp_path), "--style", "xiaochu",
                        "--score-thre", "0.5"])
    assert n == len(os.listdir(tmp_path)) > 0
    assert f"wrote {n} annotated images to {tmp_path}" in \
        capsys.readouterr().out


# ---------------------------------------------------------- convert_weights
def _jax_convert(monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", ["convert_weights.py"] + argv)
    jax_convert_weights.main()


@pytest.fixture(scope="module")
def reduced_pth(tmp_path_factory):
    """A seeded random reference ``.pth`` of the reduced HRNet, one key
    no mapping reads added, and its yaml."""
    tmp = tmp_path_factory.mktemp("convert")
    cfg = reduced_cfg(default_config)
    sd = build_model(cfg, device="cpu", seed=7).state_dict()
    sd["head.extra.weight"] = torch.ones(3)
    torch.save(sd, tmp / "reduced.pth")
    (tmp / "reduced.yaml").write_text(yaml.safe_dump(cfg.to_dict()))
    return tmp, sd


def test_convert_pose_pth_writes_the_jax_bytes(reduced_pth, tmp_path,
                                               monkeypatch, capsys):
    src, _ = reduced_pth
    common = ["--cfg", str(src / "reduced.yaml"), "--pth",
              str(src / "reduced.pth")]
    assert convert_weights.main(common + ["--out", str(tmp_path / "p"),
                                          "--device", "cpu"]) == 0
    ours = capsys.readouterr().out.splitlines()
    _jax_convert(monkeypatch, common + ["--out", str(tmp_path / "j")])
    theirs = capsys.readouterr().out.splitlines()
    got, want = (tmp_path / "p").read_bytes(), (tmp_path / "j").read_bytes()
    assert got == want
    assert ours[0] == theirs[0] == ("warning: 1 unused torch keys, e.g. "
                                    "['head.extra.weight']")
    assert ours[1] == f"wrote {tmp_path / 'p'} ({len(got)} bytes)"
    assert theirs[1] == f"wrote {tmp_path / 'j'} ({len(want)} bytes)"


def test_convert_yolov5_writes_the_jax_bytes(tmp_path, monkeypatch, capsys):
    """A seeded random ``yolov5n`` state dict in ultralytics' keys, with
    its anchors and one key no mapping reads."""
    sd = {"model." + k: v for k, v in
          build_detector("yolov5n", device="cpu", seed=3).state_dict()
          .items()}
    sd["model.model.24.anchors"] = torch.rand(3, 3, 2)
    sd["model.model.25.spare"] = torch.zeros(2)
    torch.save(sd, tmp_path / "yolov5n.pt")
    common = ["--pth", str(tmp_path / "yolov5n.pt"), "--arch", "yolov5n"]
    assert convert_weights.main(common + ["--out", str(tmp_path / "p"),
                                          "--device", "cpu"]) == 0
    ours = capsys.readouterr().out.splitlines()
    _jax_convert(monkeypatch, common + ["--out", str(tmp_path / "j")])
    theirs = capsys.readouterr().out.splitlines()
    assert (tmp_path / "p").read_bytes() == (tmp_path / "j").read_bytes()
    assert ours[0] == theirs[0] == \
        "warning: 1 unused torch keys, e.g. ['25.spare']"


def test_convert_refuses_a_wrong_shape_as_jax_does(reduced_pth, tmp_path,
                                                   monkeypatch):
    src, sd = reduced_pth
    bad = dict(sd)
    w = bad["final_layer.weight"]
    bad["final_layer.weight"] = torch.zeros(w.shape[0] + 1, *w.shape[1:])
    torch.save(bad, tmp_path / "bad.pth")
    common = ["--cfg", str(src / "reduced.yaml"), "--pth",
              str(tmp_path / "bad.pth")]
    with pytest.raises(RuntimeError, match="size mismatch for "
                                           "final_layer.weight"):
        convert_weights.main(common + ["--out", str(tmp_path / "p"),
                                       "--device", "cpu"])
    with pytest.raises(ValueError, match="shape mismatch"):
        _jax_convert(monkeypatch, common + ["--out", str(tmp_path / "j")])
    assert not (tmp_path / "p").exists() and not (tmp_path / "j").exists()


# ------------------------------------------------------------ reproduce_zoo
def _fake_run_entry(entry, opts=(), data_dir=None, output_dir="",
                    quantize="", device=None):
    if entry["name"] == "broken":
        raise KeyError("metric 'NOPE' not in evaluate() output ['AP']")
    value = {"near": 0.75, "far": 0.2}[entry["name"]]
    return value - (0.013 if quantize else 0.0), {"AP": value}


ZOO_ROWS = [
    {"name": "near", "config": "c.yaml", "weights": "{w}", "expected": 0.7},
    {"name": "far", "config": "c.yaml", "weights": "{w}", "expected": 0.5},
    {"name": "missing", "config": "c.yaml",
     "weights": "$UDP_ZOO_NOT_SET/none.pth", "expected": 76.8},
    {"name": "broken", "config": "c.yaml", "weights": "{w}",
     "expected": 1.0},
]


@pytest.mark.parametrize("skip_missing", [False, True])
@pytest.mark.parametrize("quantize", ["", "int8"])
def test_zoo_table_is_the_jax_table(tmp_path, monkeypatch, skip_missing,
                                    quantize):
    """Missing weights with and without ``--skip-missing``, an entry that
    raises (it hides none of the rest), entries within and beyond the
    tolerance, with and without the int8 columns: the same rows, the same
    verdict and the same table, character for character."""
    weights = tmp_path / "w.pth"
    weights.write_bytes(b"")
    manifest = [dict(r, weights=r["weights"].format(w=weights))
                for r in ZOO_ROWS]
    monkeypatch.setattr(reproduce_zoo, "run_entry", _fake_run_entry)
    monkeypatch.setattr(jax_reproduce_zoo, "run_entry", _fake_run_entry)
    runs = []
    for mod in (reproduce_zoo, jax_reproduce_zoo):
        out = io.StringIO()
        rows, ok = mod.run_manifest(manifest, tolerance=0.1, out=out,
                                    skip_missing=skip_missing,
                                    quantize=quantize)
        runs.append((rows, ok, out.getvalue()))
    assert runs[0] == runs[1]
    rows, ok, table = runs[0]
    assert not ok and [r["status"].split()[0] for r in rows] == [
        "OK", "FAIL", "SKIP" if skip_missing else "FAIL", "ERROR"]
    assert len(table.splitlines()) == 5


def _zoo_cfg(root):
    """A tiny fp32 ``pose_resnet`` 18 on a mini-COCO val set."""
    cfg = default_config()
    cfg.MODEL.NAME = "pose_resnet"
    cfg.MODEL.TARGET_TYPE = "gaussian"
    cfg.MODEL.IMAGE_SIZE = [48, 64]
    cfg.MODEL.HEATMAP_SIZE = [12, 16]
    cfg.MODEL.EXTRA.merge_from_dict({
        "NUM_LAYERS": 18, "NUM_DECONV_LAYERS": 3,
        "NUM_DECONV_FILTERS": [32, 32, 32],
        "NUM_DECONV_KERNELS": [4, 4, 4],
        "DECONV_WITH_BIAS": False, "FINAL_CONV_KERNEL": 1})
    cfg.TPU.DTYPE = "float32"
    cfg.DATASET.DATASET = "coco"
    cfg.DATASET.ROOT = root
    cfg.DATASET.TEST_SET = "val2017"
    cfg.DATASET.COLOR_RGB = True
    cfg.TEST.USE_GT_BBOX = True
    cfg.TEST.FLIP_TEST = False
    cfg.TEST.BATCH_SIZE_PER_GPU = 4
    return cfg


@pytest.fixture(scope="module")
def zoo_env(tmp_path_factory):
    """A tiny ``.pth`` and a mini-COCO val set on which its AP lies
    between 0 and 1: every other person's joints are moved to where the
    weights put them, the rest stay where random weights miss them."""
    from udp_pose_tpu_torch.core.validate import validate
    from udp_pose_tpu_torch.data import build_dataset
    tmp = tmp_path_factory.mktemp("zoo")
    root = str(tmp / "data")
    make_mini_coco(root, n_images=5, seed=11, all_visible=True)
    cfg = _zoo_cfg(root)
    (tmp / "tiny.yaml").write_text(yaml.safe_dump(cfg.to_dict()))
    model = build_model(cfg, device="cpu", seed=3)
    torch.save(model.state_dict(), tmp / "tiny.pth")
    ds, preds = build_dataset(cfg), []
    ds.evaluate = lambda cfg, p, *a: preds.append(np.array(p)) or ({}, 0)
    validate(cfg, ds, model)
    ann_file = os.path.join(root, "annotations",
                            "person_keypoints_val2017.json")
    with open(ann_file) as f:
        data = json.load(f)
    # the val db's people, in its order (the harness adds a crowd and an
    # unlabelled box, which the db leaves out)
    people = [a for a in data["annotations"]
              if not a["iscrowd"] and max(a["keypoints"]) > 0]
    assert len(people) == len(preds[0]) == len(ds) > 4
    for ann, pred in list(zip(people, preds[0]))[::2]:
        ann["keypoints"] = np.concatenate(
            [pred[:, :2], np.full((17, 1), 2.0)], 1).reshape(-1).tolist()
    with open(ann_file, "w") as f:
        json.dump(data, f)
    return {"tmp": tmp, "cfg": str(tmp / "tiny.yaml"),
            "weights": str(tmp / "tiny.pth")}


def _spy_on_evaluate(monkeypatch, cls):
    seen = []
    evaluate = cls.evaluate

    def spy(self, cfg, preds, *args, **kwargs):
        seen.append(np.array(preds))
        return evaluate(self, cfg, preds, *args, **kwargs)

    monkeypatch.setattr(cls, "evaluate", spy)
    return seen


def test_zoo_run_entry_equals_jax(zoo_env, monkeypatch):
    """The same ``.pth`` through both ``run_entry``: every name value
    within 1e-3, the decoded keypoints within 1e-3 px and their scores
    within 1e-5."""
    from udp_pose_tpu.data.coco import COCODataset as JaxCOCO
    from udp_pose_tpu_torch.data.coco import COCODataset
    entry = {"name": "tiny", "config": zoo_env["cfg"],
             "weights": zoo_env["weights"], "expected": 0.0}
    seen = _spy_on_evaluate(monkeypatch, COCODataset)
    seen_jax = _spy_on_evaluate(monkeypatch, JaxCOCO)
    ap, nv = reproduce_zoo.run_entry(entry, device="cpu")
    jap, jnv = jax_reproduce_zoo.run_entry(entry)
    assert 0.1 < ap < 0.9 and sorted(nv) == sorted(jnv)
    for k in jnv:
        assert nv[k] == pytest.approx(jnv[k], abs=1e-3), k
    assert ap == pytest.approx(jap, abs=1e-3)
    got, want = seen[0], seen_jax[0][:len(seen[0])]
    np.testing.assert_allclose(got[..., :2], want[..., :2], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(got[..., 2], want[..., 2], rtol=0, atol=1e-5)


def test_zoo_main_passes_a_direct_validate_and_fails_a_shift(zoo_env,
                                                             capsys):
    """``main --device cpu``: an ``expected`` from a direct validation of
    the same weights passes with Δ 0 and exits 0; shifted past the
    tolerance, the run exits 1; the results json lands in
    ``--output-dir``."""
    from udp_pose_tpu_torch.config import load_config
    from udp_pose_tpu_torch.core.validate import validate
    from udp_pose_tpu_torch.data import build_dataset
    from udp_pose_tpu_torch.utils.convert import state_dict_to_torch
    cfg = load_config(zoo_env["cfg"])
    model = build_model(cfg, device="cpu")
    model.load_state_dict(state_dict_to_torch(
        torch.load(zoo_env["weights"])), strict=True)
    nv, _ = validate(cfg, build_dataset(cfg), model)
    tmp = zoo_env["tmp"]
    for expected, code, status in ((nv["AP"], 0, "OK"),
                                   (nv["AP"] + 0.5, 1, "FAIL")):
        (tmp / "m.json").write_text(json.dumps([{
            "name": "tiny", "config": zoo_env["cfg"],
            "weights": zoo_env["weights"], "expected": expected}]))
        out_dir = tmp / f"out{code}"
        assert reproduce_zoo.main(["--manifest", str(tmp / "m.json"),
                                   "--device", "cpu", "--output-dir",
                                   str(out_dir), "TEST.BATCH_SIZE_PER_GPU",
                                   "4"]) == code
        row = capsys.readouterr().out.splitlines()[-1].split()
        assert row[0] == "tiny" and row[4] == status
        assert float(row[3]) == (0.0 if code == 0 else -0.5)
        assert (out_dir / "results" /
                "keypoints_val2017_results_0.json").exists()
