"""Published-zoo reproduction harness of the PyTorch port (port of
``tools/reproduce_zoo.py``).

Reads a manifest of (config, weights, expected AP) entries (the eval
matrix of the reference's README, as shipped in
``configs/zoo_manifest.json``) and for each entry loads the weights,
validates them through the flip-test serving graph and COCOeval
(:func:`.core.validate.validate`), then prints a delta table and exits
nonzero if any |Δ| exceeds ``--tolerance`` (default 0.1, the BASELINE.md
budget).  With COCO val and the published ``.pth`` zoo on disk:

    UDP_ZOO=/path/to/pth python -m udp_pose_tpu_torch.reproduce_zoo \
        --manifest configs/zoo_manifest.json DATASET.ROOT /path/to/coco

Manifest entry schema (JSON list):
    {"name": "...",                 # display name
     "config": "configs/...yaml",   # a config (repo-relative ok)
     "weights": "$UDP_ZOO/x.pth",   # .pth/.pt/.tar, .msgpack or .onnx;
                                    # env vars are expanded
     "expected": 76.8,              # published value (BASELINE.md)
     "metric": "AP",                # key into validate() name_values
     "opts": ["TEST.FLIP_TEST", "true"]}   # optional dotted overrides

Runs on the card unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_entry(entry, opts=(), data_dir=None, output_dir="", quantize="",
              device="cuda"):
    """One manifest row → (measured value, name_values).

    ``quantize='int8'`` serves the entry through the int8 PTQ path,
    calibrated on the first val batches
    (:func:`.models.quantize.quantize_for_eval`), so that the same
    command measures the int8 AP delta the day real data and weights
    exist."""
    from .config import load_config
    from .core.validate import validate
    from .data import build_dataset
    from .models import build_model
    from .utils.convert import read_weights, state_dict_to_torch

    cfg_path = entry["config"]
    if not os.path.isabs(cfg_path) and not os.path.exists(cfg_path):
        cfg_path = os.path.join(REPO, cfg_path)
    merged_opts = list(entry.get("opts", [])) + list(opts)
    if quantize:
        merged_opts += ["TPU.QUANTIZE", quantize]
    cfg = load_config(cfg_path, merged_opts)
    if data_dir:
        cfg.defrost()
        cfg.DATASET.ROOT = data_dir
        cfg.freeze()

    model = build_model(cfg, device=device)
    ds = build_dataset(cfg, is_train=False)
    weights = os.path.expandvars(entry["weights"])
    model.load_state_dict(state_dict_to_torch(read_weights(weights, cfg)),
                          strict=True)
    if cfg.TPU.QUANTIZE == "int8":
        from .models.quantize import quantize_for_eval
        model = quantize_for_eval(cfg, model, ds)
    name_values, _perf = validate(cfg, ds, model, output_dir)
    metric = entry.get("metric", "AP")
    if metric not in name_values:
        raise KeyError(f"metric {metric!r} not in evaluate() output "
                       f"{sorted(name_values)}")
    return float(name_values[metric]), name_values


def run_manifest(manifest, opts=(), data_dir=None, tolerance=0.1,
                 output_dir="", skip_missing=False, out=None,
                 quantize="", device="cuda"):
    """Run every manifest entry; returns (rows, ok).

    rows: [{name, expected, measured, delta, status}].  ok is False when
    any entry exceeds tolerance or errors (missing weights count as
    errors unless ``skip_missing``).  The table goes to ``out`` (the
    standard output by default).

    ``quantize='int8'`` also serves each entry through the int8 PTQ path
    and reports ``measured_int8`` / ``delta_int8`` (int8 minus fp):
    informational columns, not held to the tolerance, as the published
    numbers are fp and the int8 drift is the deployment trade-off being
    measured."""
    out = sys.stdout if out is None else out
    rows, ok = [], True
    for entry in manifest:
        name = entry.get("name") or entry["config"]
        expected = float(entry["expected"])
        weights = os.path.expandvars(entry["weights"])
        if not os.path.exists(weights):
            status = "SKIP (weights missing)" if skip_missing else \
                "FAIL (weights missing)"
            if not skip_missing:
                ok = False
            rows.append({"name": name, "expected": expected,
                         "measured": None, "delta": None, "status": status,
                         "weights": weights})
            continue
        try:
            measured, _nv = run_entry(entry, opts, data_dir, output_dir,
                                      device=device)
        except Exception as e:    # an entry failing must not hide the rest
            ok = False
            rows.append({"name": name, "expected": expected,
                         "measured": None, "delta": None,
                         "status": f"ERROR ({type(e).__name__}: {e})"})
            continue
        delta = measured - expected
        good = abs(delta) <= tolerance
        ok = ok and good
        row = {"name": name, "expected": expected,
               "measured": measured, "delta": delta,
               "status": "OK" if good else
               f"FAIL (|delta| > {tolerance})"}
        if quantize:
            try:
                m_q, _ = run_entry(entry, opts, data_dir, output_dir,
                                   quantize=quantize, device=device)
                row["measured_int8"] = m_q
                row["delta_int8"] = m_q - measured
            except Exception as e:
                row["status"] += f"; int8 ERROR ({type(e).__name__}: {e})"
                ok = False
        rows.append(row)

    w = max((len(r["name"]) for r in rows), default=4)
    int8_cols = quantize and any("measured_int8" in r for r in rows)
    hdr = (f"{'model':<{w}} {'expected':>9} {'measured':>9} {'delta':>8}")
    if int8_cols:
        hdr += f" {'int8':>9} {'d_int8':>8}"
    print(hdr + "  status", file=out)
    for r in rows:
        meas = f"{r['measured']:.3f}" if r["measured"] is not None else "-"
        dl = f"{r['delta']:+.3f}" if r["delta"] is not None else "-"
        line = (f"{r['name']:<{w}} {r['expected']:>9.3f} {meas:>9} "
                f"{dl:>8}")
        if int8_cols:
            mq = (f"{r['measured_int8']:.3f}"
                  if r.get("measured_int8") is not None else "-")
            dq = (f"{r['delta_int8']:+.3f}"
                  if r.get("delta_int8") is not None else "-")
            line += f" {mq:>9} {dq:>8}"
        print(line + f"  {r['status']}", file=out)
    return rows, ok


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Reproduce the published zoo AP matrix")
    p.add_argument("--manifest", required=True)
    p.add_argument("--tolerance", type=float, default=0.1,
                   help="max |measured - expected| (BASELINE north-star)")
    p.add_argument("--data-dir", default=None,
                   help="override DATASET.ROOT for every entry")
    p.add_argument("--output-dir", default="",
                   help="where results jsons land ('' = nowhere)")
    p.add_argument("--skip-missing", action="store_true",
                   help="entries whose weights are absent are skipped "
                        "instead of failing the run")
    p.add_argument("--quantize", default="", choices=["", "int8"],
                   help="also serve each entry int8 (PTQ) and report the "
                        "AP delta vs the fp run")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    p.add_argument("opts", nargs=argparse.REMAINDER,
                   help="extra dotted config overrides for every entry")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from .utils.platform import resolve_device
    device = resolve_device(args.device)
    with open(args.manifest) as f:
        manifest = json.load(f)
    _rows, ok = run_manifest(manifest, args.opts, args.data_dir,
                             args.tolerance, args.output_dir,
                             args.skip_missing, quantize=args.quantize,
                             device=device)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
