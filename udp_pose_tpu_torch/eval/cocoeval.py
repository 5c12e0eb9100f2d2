"""Native COCO keypoint evaluation (the pycocotools COCOeval contract).

The port's own copy of ``udp_pose_tpu/eval/cocoeval.py``.  The evaluation
the reference relies on (deep_hrnet/lib/dataset/coco.py:431-445 → COCOeval('keypoints'))
is reimplemented here in vectorised numpy with the same algorithm:

* OKS between detections and ground truth uses the *gt* area and gt-visible
  keypoints (``e = d²/(2·area·(2σ)²)``; unannotated gts fall back to a
  box-distance penalty), matching pycocotools ``computeOks``.
* Greedy per-image matching in detection-score order at each OKS threshold,
  preferring non-ignored gts; crowd/ignored gts can absorb extra dets.
* Accumulation over 10 OKS thresholds (.50:.05:.95), 101 recall points,
  area rings all/medium/large, maxDets=20; interpolated precision.
* ``stats`` ordering identical to COCOeval.summarize for keypoints.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence

import numpy as np

COCO_KPT_SIGMAS = np.array(
    [.26, .25, .25, .35, .35, .79, .79, .72, .72, .62, .62,
     1.07, 1.07, .87, .87, .89, .89], np.float64) / 10.0

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.00, 101)
AREA_RNGS = {
    "all": (0.0, 1e10),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
MAX_DETS = 20

STATS_NAMES = ["AP", "Ap .5", "AP .75", "AP (M)", "AP (L)",
               "AR", "AR .5", "AR .75", "AR (M)", "AR (L)"]


def _dt_area(kpts_flat):
    """pycocotools loadRes: detection 'area' = tight bbox of the keypoints."""
    x = kpts_flat[0::3]
    y = kpts_flat[1::3]
    return (x.max() - x.min()) * (y.max() - y.min())


def compute_oks(gts: List[dict], dts: List[dict],
                sigmas=COCO_KPT_SIGMAS) -> np.ndarray:
    """(n_dt, n_gt) OKS matrix for one image (pycocotools computeOks)."""
    if not gts or not dts:
        return np.zeros((len(dts), len(gts)))
    vars_ = (sigmas * 2) ** 2
    ious = np.zeros((len(dts), len(gts)))
    for j, gt in enumerate(gts):
        g = np.asarray(gt["keypoints"], np.float64)
        xg, yg, vg = g[0::3], g[1::3], g[2::3]
        k1 = int((vg > 0).sum())
        bb = gt["bbox"]
        x0, x1 = bb[0] - bb[2], bb[0] + bb[2] * 2
        y0, y1 = bb[1] - bb[3], bb[1] + bb[3] * 2
        for i, dt in enumerate(dts):
            d = np.asarray(dt["keypoints"], np.float64)
            xd, yd = d[0::3], d[1::3]
            if k1 > 0:
                dx, dy = xd - xg, yd - yg
            else:
                dx = np.maximum(0, x0 - xd) + np.maximum(0, xd - x1)
                dy = np.maximum(0, y0 - yd) + np.maximum(0, yd - y1)
            e = ((dx ** 2 + dy ** 2) / vars_
                 / (gt["area"] + np.spacing(1)) / 2)
            if k1 > 0:
                e = e[vg > 0]
            ious[i, j] = np.exp(-e).sum() / e.shape[0]
    return ious


class COCOKeypointEval:
    """Evaluate keypoint detections against COCO-format ground truth.

    gt_annotations: list of dicts with image_id, keypoints (51,), bbox
    (xywh), area, num_keypoints, iscrowd.  detections: dicts with image_id,
    keypoints (51,), score.
    """

    def __init__(self, gt_annotations: Sequence[dict],
                 image_ids: Sequence[int], sigmas=COCO_KPT_SIGMAS):
        self.sigmas = np.asarray(sigmas, np.float64)
        self.img_ids = list(image_ids)
        self._gts: Dict[int, List[dict]] = defaultdict(list)
        for ann in gt_annotations:
            gt = dict(ann)
            ignore = gt.get("ignore", 0) or gt.get("iscrowd", 0)
            nk = gt.get("num_keypoints")
            if nk is None:
                nk = int((np.asarray(gt["keypoints"])[2::3] > 0).sum())
            gt["num_keypoints"] = nk
            gt["_ignore_base"] = 1 if (ignore or nk == 0) else 0
            self._gts[gt["image_id"]].append(gt)
        self.stats = None
        self.name_values = None

    def evaluate(self, detections: Sequence[dict], max_dets: int = MAX_DETS):
        dts_by_img: Dict[int, List[dict]] = defaultdict(list)
        for dt in detections:
            d = dict(dt)
            d["area"] = _dt_area(np.asarray(d["keypoints"], np.float64))
            dts_by_img[d["image_id"]].append(d)

        T = len(IOU_THRS)
        A = len(AREA_RNGS)
        # per (area, img): matching results
        eval_imgs = {a: [] for a in AREA_RNGS}

        for img_id in self.img_ids:
            gts = self._gts.get(img_id, [])
            dts = sorted(dts_by_img.get(img_id, []),
                         key=lambda d: -d["score"])[:max_dets]
            if not gts and not dts:
                for a in AREA_RNGS:
                    eval_imgs[a].append(None)
                continue
            ious_full = compute_oks(gts, dts, self.sigmas)

            for aname, (a0, a1) in AREA_RNGS.items():
                g_ignore = np.array(
                    [g["_ignore_base"] or not (a0 <= g["area"] <= a1)
                     for g in gts], bool)
                # gts sorted: non-ignored first (stable)
                g_order = np.argsort(g_ignore, kind="stable")
                gt_ig = g_ignore[g_order]
                gt_crowd = np.array([gts[int(i)].get("iscrowd", 0)
                                     for i in g_order], bool)
                ious = (ious_full[:, g_order]
                        if ious_full.size else ious_full)
                nG, nD = len(gts), len(dts)
                gtm = np.zeros((T, nG), np.int64) - 1
                dtm = np.zeros((T, nD), np.int64) - 1
                dt_ig = np.zeros((T, nD), bool)
                for t, thr in enumerate(IOU_THRS):
                    for di in range(nD):
                        iou_best = min(thr, 1 - 1e-10)
                        match = -1
                        for gi in range(nG):
                            # matched gts are off-limits unless crowd
                            if gtm[t, gi] >= 0 and not gt_crowd[gi]:
                                continue
                            # stop at ignored gts once matched to a real one
                            if match > -1 and not gt_ig[match] and gt_ig[gi]:
                                break
                            if ious[di, gi] < iou_best:
                                continue
                            iou_best = ious[di, gi]
                            match = gi
                        if match == -1:
                            continue
                        dt_ig[t, di] = gt_ig[match]
                        dtm[t, di] = match
                        gtm[t, match] = di
                # unmatched dts outside the area ring are ignored
                d_areas = np.array([d["area"] for d in dts])
                d_out = (d_areas < a0) | (d_areas > a1) if nD else \
                    np.zeros(0, bool)
                dt_ig = dt_ig | ((dtm < 0) & d_out[None, :])
                eval_imgs[aname].append({
                    "dt_scores": np.array([d["score"] for d in dts]),
                    "dtm": dtm, "dt_ig": dt_ig,
                    "n_gt": int((~gt_ig).sum()),
                })

        # accumulate
        precision = -np.ones((T, len(REC_THRS), A))
        recall = -np.ones((T, A))
        for ai, aname in enumerate(AREA_RNGS):
            Es = [e for e in eval_imgs[aname] if e is not None]
            if not Es:
                continue
            scores = np.concatenate([e["dt_scores"] for e in Es])
            order = np.argsort(-scores, kind="mergesort")
            dtm = np.concatenate([e["dtm"] for e in Es], axis=1)[:, order]
            dt_ig = np.concatenate([e["dt_ig"] for e in Es],
                                   axis=1)[:, order]
            npig = sum(e["n_gt"] for e in Es)
            if npig == 0:
                continue
            tps = (dtm >= 0) & ~dt_ig
            fps = (dtm < 0) & ~dt_ig
            tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
            fp_sum = np.cumsum(fps, axis=1).astype(np.float64)
            for t in range(T):
                tp, fp = tp_sum[t], fp_sum[t]
                nd = len(tp)
                rc = tp / npig
                pr = tp / (fp + tp + np.spacing(1))
                recall[t, ai] = rc[-1] if nd else 0
                # interpolated precision (monotone from the right)
                pr = pr.tolist()
                for i in range(nd - 1, 0, -1):
                    if pr[i] > pr[i - 1]:
                        pr[i - 1] = pr[i]
                inds = np.searchsorted(rc, REC_THRS, side="left")
                q = np.zeros(len(REC_THRS))
                for ri, pi in enumerate(inds):
                    if pi < nd:
                        q[ri] = pr[pi]
                precision[t, :, ai] = q

        def _ap(t_slice, a_idx):
            p = precision[t_slice, :, a_idx]
            p = p[p > -1]
            return float(np.mean(p)) if p.size else -1.0

        def _ar(t_slice, a_idx):
            r = recall[t_slice, a_idx]
            r = r[r > -1]
            return float(np.mean(r)) if r.size else -1.0

        all_t = slice(None)
        stats = [
            _ap(all_t, 0), _ap(slice(0, 1), 0), _ap(slice(5, 6), 0),
            _ap(all_t, 1), _ap(all_t, 2),
            _ar(all_t, 0), _ar(slice(0, 1), 0), _ar(slice(5, 6), 0),
            _ar(all_t, 1), _ar(all_t, 2),
        ]
        self.stats = np.array(stats)
        self.name_values = dict(zip(STATS_NAMES, stats))
        return self.name_values
