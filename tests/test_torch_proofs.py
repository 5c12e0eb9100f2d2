"""The port's two learning proofs on the CPU: ``generalization_proof``
(its synthetic set against the JAX tool's, and its fp32 / int8 PTQ /
QAT machinery at the tiny scale) and ``overfit_proof`` (a short run up
to its AP gate).  The gates themselves hold at full scale, on the card
(``chip_smoke.py`` phase 17)."""

import json
import os
import tempfile

import cv2
import numpy as np
import pytest
import torch

from tools import generalization_proof as jax_generalization_proof
from udp_pose_tpu_torch import generalization_proof, overfit_proof


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the suite runs several test processes at
    once, and each would otherwise start one thread per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def gen_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("gen") / "set"
    generalization_proof.generate(str(root))
    return root


@pytest.mark.parametrize("main", [generalization_proof.main,
                                  overfit_proof.main])
def test_proofs_need_the_card_unless_asked_for_the_cpu(main, tmp_path):
    """Without ``--device cpu`` a proof raises on a host with no card,
    before it writes anything."""
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--root", str(tmp_path / "r")])
    assert not (tmp_path / "r").exists()


def test_generate_writes_the_jax_set(gen_root, tmp_path):
    """The annotations byte for byte and every image pixel for pixel."""
    jax_generalization_proof.generate(str(tmp_path))
    for split, n in (("train2017", 64), ("val2017", 16)):
        name = f"annotations/person_keypoints_{split}.json"
        assert (gen_root / name).read_bytes() == (tmp_path / name).read_bytes()
        files = sorted(os.listdir(tmp_path / "images" / split))
        assert sorted(os.listdir(gen_root / "images" / split)) == files
        assert len(files) == n
        for f in files:
            np.testing.assert_array_equal(
                cv2.imread(str(gen_root / "images" / split / f)),
                cv2.imread(str(tmp_path / "images" / split / f)))
    data = json.loads((gen_root / "annotations" /
                       "person_keypoints_val2017.json").read_text())
    assert [a["num_keypoints"] for a in data["annotations"]] == [17] * 16


def test_generalization_tiny_int8_qat_runs_through(gen_root, capsys,
                                                   tmp_path, monkeypatch):
    """``--tiny --quantize int8 --qat --device cpu`` at a few steps: the
    fp32 training and evaluation, the int8 PTQ evaluation of the same
    weights and the QAT twin's int8 deployment all run and print their
    lines, the results jsons in the printed directory."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    record = generalization_proof.main([
        "--tiny", "--root", str(gen_root), "--steps", "2",
        "--pool-epochs", "1", "--quantize", "int8", "--qat",
        "--device", "cpu"])
    out = capsys.readouterr().out
    for line in ("GENERALIZATION PROOF (tiny machinery drill)",
                 "INT8 PTQ on unseen val", "QAT->INT8 deployment on unseen "
                 "val", "[fp32] 2 steps in", "[qat] 2 steps in",
                 "pool of 2 augmented batches in",
                 f"results under {record['out_dir']}"):
        assert line in out, line
    assert record["pool_batches"] == 2
    for tag in ("fp32", "qat"):
        assert record[tag]["steps"] == 2
        assert np.isfinite(record[tag]["loss"])
    for key in ("ap", "ap_int8", "ap_qat"):
        assert 0.0 <= record[key] <= 1.0
    for sub in ("fp32", "int8", "qat"):
        assert os.path.exists(os.path.join(
            record["out_dir"], sub, "results",
            "keypoints_val2017_results_0.json"))
    assert record["d_ap_int8"] == abs(record["ap"] - record["ap_int8"])


def test_overfit_reaches_its_gate_and_fails_it(gen_root, capsys, tmp_path,
                                               monkeypatch):
    """Two CPU steps on the 16 unseen val images as one batch: the run
    reaches the AP line, and its AP, far below 0.95, exits nonzero with
    the JAX tool's message."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    with pytest.raises(SystemExit) as failed:
        overfit_proof.main(["--root", str(gen_root), "--steps", "2",
                            "--device", "cpu"])
    assert str(failed.value).startswith("E2E learning proof FAILED: AP ")
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("2 steps in ") and "final loss" in out[0]
    assert out[-1].startswith("{'AP': ")
    assert out[-2].startswith(f"results under {tmp_path}")
