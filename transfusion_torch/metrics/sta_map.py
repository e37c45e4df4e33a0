"""Ego4D STA mean-average-precision suite (host-side; port of
``transfusion_tpu/metrics/sta_map.py``): the greedy matcher runs in C++
(``metrics/native.py``) where the library builds, else in numpy; both give
the same tp arrays.

Re-implements the official Ego4D STA evaluation semantics the reference
vendors (``runner/metrics_losses/ego_metrics.py:376-561``), producing the 8
measures: map_noun, map_verb, ap_box, map_box_noun, map_box_noun_verb,
map_box_noun_ttc, map_box_noun_verb_ttc, ap_ttc.

Exactness notes (each matters for metric parity):
  * IoU uses the legacy +1 pixel convention on integer boxes
    (``ego_metrics.py:17-22``); callers pass boxes already cast to int
    (``ego_nao_trainer.py:118-119``);
  * matching iterates predictions by ``np.argsort(scores)[::-1]`` — for tied
    scores this is *reverse* original order, reproduced verbatim;
  * top-K criterion removes up to ``(K-1) * num_gt`` highest-scored false
    positives per image by NaN-ing them before AP accumulation
    (``ego_metrics.py:176-191``);
  * AP is VOC-style integration over recall change-points with monotone
    precision, averaged over classes present in the ground truth
    (count_all_classes=False default), in percent.

This runs on host between device steps; the measure criteria are expressed
as a table rather than subclass methods, and the per-image matching loop is
the only sequential part (the candidate masks are vectorized).
"""

from __future__ import annotations

import numpy as np

STA_METRIC_NAMES = [
    "map_noun",
    "map_verb",
    "ap_box",
    "map_box_noun",
    "map_box_noun_verb",
    "map_box_noun_ttc",
    "map_box_noun_verb_ttc",
    "ap_ttc",
]

# The TTC-free 5-measure variant (ego_metrics.py:376-413).
STA_METRIC_NAMES_NO_TTC = STA_METRIC_NAMES[:5]


def iou_plus_one(preds: np.ndarray, gts: np.ndarray) -> np.ndarray:
    """[NP, 4] x [NG, 4] -> [NP, NG] with the +1 area convention."""

    def area(w, h):
        return np.clip(w, 0, None) * np.clip(h, 0, None)

    px1, py1, px2, py2 = [preds[:, i : i + 1] for i in range(4)]
    gx1, gy1, gx2, gy2 = [gts[None, :, i] for i in range(4)]
    ix1 = np.maximum(gx1, px1)
    iy1 = np.maximum(gy1, py1)
    ix2 = np.minimum(gx2, px2)
    iy2 = np.minimum(gy2, py2)
    inter = area(ix2 - ix1 + 1, iy2 - iy1 + 1)
    a_p = area(px2 - px1 + 1, py2 - py1 + 1)
    a_g = area(gx2 - gx1 + 1, gy2 - gy1 + 1)
    return inter / (a_p + a_g - inter + 1e-11)


class STAMeanAveragePrecision:
    """Streaming per-image accumulation + final AP evaluation."""

    NUM_MEASURES = 8

    def __init__(self, iou_threshold=0.5, ttc_threshold=0.25, top_k=5, count_all_classes=False):
        self.iou_threshold = iou_threshold
        self.ttc_threshold = ttc_threshold
        self.top_k = top_k
        self.count_all_classes = count_all_classes
        self.reset()

    def reset(self):
        self._tp: list[np.ndarray] = []
        self._scores: list[np.ndarray] = []
        self._pred_classes: list[np.ndarray] = []
        self._gt_classes: list[np.ndarray] = []

    def get_short_names(self):
        return list(STA_METRIC_NAMES)

    def _measure_classes(self, entry: dict) -> np.ndarray:
        """Per-measure class id for each prediction/label [N, 8]."""
        nouns = np.asarray(entry["nouns"])
        n = len(nouns)
        ones = np.ones(n)
        verbs = np.asarray(entry["verbs"]) if "verbs" in entry else ones
        cols = [nouns, verbs, ones, nouns, nouns, nouns, nouns, ones]
        return np.stack(cols, axis=1)

    def _candidate_matches(self, pred_i: dict, labels: dict, overlaps: np.ndarray) -> np.ndarray:
        """[NG, 8] bool: whether prediction i may match each gt per measure."""
        nouns = pred_i["nouns"] == np.asarray(labels["nouns"])
        boxes = overlaps > self.iou_threshold
        verbs = (
            (pred_i["verbs"] == np.asarray(labels["verbs"]))
            if "verbs" in pred_i
            else np.zeros_like(nouns)
        )
        if "ttcs" in pred_i and pred_i["ttcs"] is not None:
            ttcs = np.abs(pred_i["ttcs"] - np.asarray(labels["ttcs"])) <= self.ttc_threshold
        else:
            ttcs = np.zeros_like(nouns)
        return np.stack(
            [
                nouns,
                verbs,
                boxes,
                boxes & nouns,
                boxes & nouns & verbs,
                boxes & nouns & ttcs,
                boxes & nouns & verbs & ttcs,
                ttcs,
            ],
            axis=1,
        )

    def add(self, preds: dict, labels: dict):
        """Accumulate one image. preds: boxes [NP,4], scores [NP], nouns,
        verbs, ttcs; labels: boxes [NG,4], nouns, verbs, ttcs."""
        pred_boxes = np.asarray(preds["boxes"])
        scores = np.asarray(preds["scores"], dtype=np.float64)
        if pred_boxes.size == 0 and len(pred_boxes) == 0:
            pred_boxes = pred_boxes.reshape(0, 4)
        np_preds = len(pred_boxes)
        pred_classes = self._measure_classes(preds)
        tp = np.zeros((np_preds, self.NUM_MEASURES))

        gt_boxes = np.asarray(labels["boxes"]).reshape(-1, 4)
        ng = len(gt_boxes)
        if ng > 0:
            native_tp = self._try_native(preds, labels, np_preds)
            if native_tp is not None:
                tp = native_tp
            else:
                ious = iou_plus_one(pred_boxes.reshape(-1, 4), gt_boxes)
                gt_taken = np.zeros((ng, self.NUM_MEASURES), dtype=bool)

                # Highest score first; ties in reverse input order (argsort[::-1]).
                for i in np.argsort(scores, kind="stable")[::-1]:
                    pred_i = {
                        k: (v[i] if not (k == "ttcs" and (v is None or len(v) <= i)) else -1.0)
                        for k, v in preds.items()
                    }
                    cand = self._candidate_matches(pred_i, labels, ious[i])  # [NG, 8]
                    cand = cand & ~gt_taken
                    ov = np.where(cand, ious[i][:, None], -1.0)
                    best_gt = ov.argmax(axis=0)
                    hit = cand[best_gt, np.arange(self.NUM_MEASURES)]
                    tp[i, hit] = 1.0
                    gt_taken[best_gt, np.arange(self.NUM_MEASURES)] |= hit

            if self.top_k is not None and self.top_k > 1:
                budget = (self.top_k - 1) * ng
                order = np.argsort(scores, kind="stable")[::-1]
                tp_sorted = tp[order].astype(float)
                fp_sorted = 1.0 - tp_sorted
                tp_sorted[(np.cumsum(fp_sorted, axis=0) <= budget) & (fp_sorted == 1)] = np.nan
                tp = tp_sorted
                scores = scores[order]
                pred_classes = pred_classes[order]

            self._gt_classes.append(self._measure_classes(labels))

        self._tp.append(tp)
        self._scores.append(scores)
        self._pred_classes.append(pred_classes)

    def _try_native(self, preds: dict, labels: dict, np_preds: int):
        """The C++ matcher (``metrics/native.py``) where the inputs are in the
        standard array form (every key full length) and the library builds;
        returns tp [N, 8] or None."""
        if preds.get("ttcs") is None or len(np.atleast_1d(preds["ttcs"])) != np_preds:
            return None
        if "verbs" not in preds or "verbs" not in labels:
            return None
        from transfusion_torch.metrics.native import sta_match_native

        return sta_match_native(
            preds["boxes"], preds["scores"], preds["nouns"], preds["verbs"], preds["ttcs"],
            labels["boxes"], labels["nouns"], labels["verbs"], labels["ttcs"],
            self.iou_threshold, self.ttc_threshold,
        )

    @staticmethod
    def _voc_ap(prec: np.ndarray, rec: np.ndarray) -> float:
        mrec = np.concatenate(([0.0], rec, [1.0]))
        mpre = np.concatenate(([0.0], prec, [0.0]))
        mpre = np.maximum.accumulate(mpre[::-1])[::-1]
        change = np.nonzero(mrec[1:] != mrec[:-1])[0] + 1
        return float(np.sum((mrec[change] - mrec[change - 1]) * mpre[change]))

    def evaluate(self):
        gt_classes = np.concatenate(self._gt_classes) if self._gt_classes else np.zeros((0, 8))
        pred_classes = np.concatenate(self._pred_classes) if self._pred_classes else np.zeros((0, 8))
        tps = np.concatenate(self._tp) if self._tp else np.zeros((0, 8))
        scores = np.concatenate(self._scores) if self._scores else np.zeros((0,))

        values = []
        for m in range(self.NUM_MEASURES):
            gcls = gt_classes[:, m]
            pcls = pred_classes[:, m]
            tpm = tps[:, m]
            classes = (
                np.unique(np.concatenate([gcls, pcls])) if self.count_all_classes else np.unique(gcls)
            )
            aps = []
            for c in classes:
                sel = pcls == c
                tp_c = tpm[sel]
                sc_c = scores[sel]
                ngt = int(np.sum(gcls == c))
                ok = ~np.isnan(tp_c)
                tp_c, sc_c = tp_c[ok], sc_c[ok]
                if len(tp_c) > 0 and ngt > 0:
                    order = np.argsort(sc_c, kind="stable")[::-1]
                    tp_sorted = tp_c[order]
                    cum_tp = np.cumsum(tp_sorted)
                    cum_fp = np.cumsum(1.0 - tp_sorted)
                    denom = cum_tp + cum_fp
                    prec = np.divide(cum_tp, denom, out=np.zeros_like(cum_tp), where=denom > 0)
                    rec = cum_tp / ngt
                    aps.append(self._voc_ap(prec, rec) * 100.0)
                elif not (len(tp_c) == 0 and ngt == 0):
                    aps.append(0.0)
            values.append(float(np.mean(aps)) if aps else float("nan"))
        return tuple(values)


class STAMeanAveragePrecisionNoTTC(STAMeanAveragePrecision):
    """5-measure variant without TTC (ego_metrics.py:376-413): the full
    matcher runs and the TTC-dependent measures are dropped at report time,
    which is equivalent because measures are computed independently."""

    def get_short_names(self):
        return list(STA_METRIC_NAMES_NO_TTC)

    def evaluate(self):
        return super().evaluate()[: len(STA_METRIC_NAMES_NO_TTC)]
