"""Evaluation (the port's own copy of ``deeplearning4j_tpu/eval``,
which is plain numpy): ``Evaluation`` (confusion-matrix accuracy,
precision, recall, F1, top-N), ``EvaluationBinary``, ``ROC``,
``ROCBinary``, ``ROCMultiClass``, ``RegressionEvaluation`` and
``EvaluationCalibration``.

Aggregation runs on the host over numpy arrays; a network's forward
runs on its device and only its outputs arrive here.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np


class Evaluation:
    """Multi-class classification evaluation (ref: Evaluation.java)."""

    def __init__(self, num_classes: Optional[int] = None,
                 labels: Optional[List[str]] = None, top_n: int = 1):
        self.num_classes = num_classes
        self.label_names = labels
        self._conf: Optional[np.ndarray] = None  # [actual, predicted]
        # ref: Evaluation(int topN) — count a sample correct when the
        # true class lands in the N highest-probability predictions
        self.top_n = int(top_n)
        self._topn_correct = 0
        self._topn_total = 0

    def _ensure(self, n: int):
        if self._conf is None:
            self.num_classes = self.num_classes or n
            self._conf = np.zeros((self.num_classes, self.num_classes), np.int64)

    def eval(self, labels: np.ndarray, predictions: np.ndarray,
             mask: Optional[np.ndarray] = None):
        """labels/predictions: one-hot or prob arrays [N, C] (or [N, T, C]
        with optional [N, T] mask — time-series flattened, ref
        evalTimeSeries)."""
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        if labels.ndim == 3:
            if mask is not None:
                keep = np.asarray(mask).reshape(-1).astype(bool)
            else:
                keep = np.ones(labels.shape[0] * labels.shape[1], bool)
            labels = labels.reshape(-1, labels.shape[-1])[keep]
            predictions = predictions.reshape(-1, predictions.shape[-1])[keep]
        elif mask is not None:
            keep = np.asarray(mask).reshape(-1).astype(bool)
            labels = labels[keep]
            predictions = predictions[keep]
        self._ensure(labels.shape[-1])
        actual = labels.argmax(-1)
        pred = predictions.argmax(-1)
        np.add.at(self._conf, (actual, pred), 1)
        if self.top_n > 1:
            k = min(self.top_n, predictions.shape[-1])
            topk = np.argpartition(predictions, -k, axis=-1)[..., -k:]
            self._topn_correct += int((topk == actual[..., None]).any(-1)
                                      .sum())
            self._topn_total += int(actual.size)

    # -- metrics (names mirror the reference methods) -------------------
    def accuracy(self) -> float:
        c = self._conf
        return float(np.trace(c)) / max(c.sum(), 1)

    def precision(self, cls: Optional[int] = None) -> float:
        c = self._conf
        if cls is not None:
            denom = c[:, cls].sum()
            return float(c[cls, cls]) / denom if denom else 0.0
        vals = [self.precision(i) for i in range(self.num_classes)
                if c[:, i].sum() + c[i, :].sum() > 0]
        return float(np.mean(vals)) if vals else 0.0

    def recall(self, cls: Optional[int] = None) -> float:
        c = self._conf
        if cls is not None:
            denom = c[cls, :].sum()
            return float(c[cls, cls]) / denom if denom else 0.0
        vals = [self.recall(i) for i in range(self.num_classes)
                if c[:, i].sum() + c[i, :].sum() > 0]
        return float(np.mean(vals)) if vals else 0.0

    def f1(self, cls: Optional[int] = None) -> float:
        p, r = self.precision(cls), self.recall(cls)
        return 2 * p * r / (p + r) if (p + r) else 0.0

    def false_positive_rate(self, cls: int) -> float:
        c = self._conf
        fp = c[:, cls].sum() - c[cls, cls]
        tn = c.sum() - c[cls, :].sum() - c[:, cls].sum() + c[cls, cls]
        return float(fp) / (fp + tn) if (fp + tn) else 0.0

    def top_n_accuracy(self) -> float:
        """Ref: Evaluation.topNAccuracy — fraction of samples whose true
        class is among the top_n predictions (== accuracy for top_n=1)."""
        if self.top_n <= 1:
            return self.accuracy()
        return self._topn_correct / max(self._topn_total, 1)

    def matthews_correlation(self, cls: int) -> float:
        """Ref: Evaluation.matthewsCorrelation(int) — binary MCC of
        one-vs-rest for the class."""
        c = self._conf
        tp = float(c[cls, cls])
        fp = float(c[:, cls].sum() - tp)
        fn = float(c[cls, :].sum() - tp)
        tn = float(c.sum() - tp - fp - fn)
        denom = math.sqrt((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
        return (tp * tn - fp * fn) / denom if denom else 0.0

    def gmeasure(self, cls: Optional[int] = None) -> float:
        """Ref: Evaluation.gMeasure — sqrt(precision * recall)."""
        return math.sqrt(self.precision(cls) * self.recall(cls))

    def confusion_matrix(self) -> np.ndarray:
        return self._conf.copy()

    def stats(self) -> str:
        lines = [
            "========================Evaluation Metrics========================",
            f" # of classes:    {self.num_classes}",
            f" Accuracy:        {self.accuracy():.4f}",
            f" Precision:       {self.precision():.4f}",
            f" Recall:          {self.recall():.4f}",
            f" F1 Score:        {self.f1():.4f}",
        ]
        if self.top_n > 1:
            lines.append(f" Top-{self.top_n} Accuracy:  "
                         f"{self.top_n_accuracy():.4f}")
        lines.append(
            "=================================================================")
        return "\n".join(lines)


class EvaluationBinary:
    """Per-output binary evaluation (ref: EvaluationBinary.java)."""

    def __init__(self, threshold: float = 0.5):
        self.threshold = threshold
        self.tp = self.fp = self.tn = self.fn = None

    def eval(self, labels, predictions, mask=None):
        labels = np.asarray(labels) > 0.5
        pred = np.asarray(predictions) > self.threshold
        if self.tp is None:
            n = labels.shape[-1]
            self.tp = np.zeros(n, np.int64)
            self.fp = np.zeros(n, np.int64)
            self.tn = np.zeros(n, np.int64)
            self.fn = np.zeros(n, np.int64)
        w = np.ones(labels.shape) if mask is None else np.asarray(mask)
        if w.ndim == labels.ndim - 1:
            w = w[..., None] * np.ones(labels.shape)
        axis = tuple(range(labels.ndim - 1))
        self.tp += (w * (labels & pred)).sum(axis).astype(np.int64)
        self.fp += (w * (~labels & pred)).sum(axis).astype(np.int64)
        self.tn += (w * (~labels & ~pred)).sum(axis).astype(np.int64)
        self.fn += (w * (labels & ~pred)).sum(axis).astype(np.int64)

    def accuracy(self, i: int) -> float:
        tot = self.tp[i] + self.fp[i] + self.tn[i] + self.fn[i]
        return float(self.tp[i] + self.tn[i]) / tot if tot else 0.0

    def precision(self, i: int) -> float:
        d = self.tp[i] + self.fp[i]
        return float(self.tp[i]) / d if d else 0.0

    def recall(self, i: int) -> float:
        d = self.tp[i] + self.fn[i]
        return float(self.tp[i]) / d if d else 0.0

    def f1(self, i: int) -> float:
        p, r = self.precision(i), self.recall(i)
        return 2 * p * r / (p + r) if (p + r) else 0.0


class ROC:
    """Binary ROC/AUC with exact thresholding (ref: ROC.java with
    thresholdSteps=0 → exact mode)."""

    def __init__(self):
        self._scores: List[np.ndarray] = []
        self._labels: List[np.ndarray] = []

    def eval(self, labels, predictions, mask=None):
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        if labels.ndim > 1 and labels.shape[-1] == 2:
            labels = labels[..., 1]
            predictions = predictions[..., 1]
        self._labels.append(labels.reshape(-1))
        self._scores.append(predictions.reshape(-1))

    def _curve_points(self):
        """Cumulative (tps, fps) sampled only at distinct-threshold
        boundaries, so tied scores form one ROC point (order-independent)."""
        y = np.concatenate(self._labels)
        s = np.concatenate(self._scores)
        order = np.argsort(-s, kind="stable")
        s_sorted = s[order]
        y = y[order] > 0.5
        tps = np.cumsum(y)
        fps = np.cumsum(~y)
        # last index of each tie group
        boundary = np.r_[np.where(np.diff(s_sorted))[0], len(y) - 1]
        return y, tps[boundary], fps[boundary]

    def auc(self) -> float:
        y, tps, fps = self._curve_points()
        P, N = y.sum(), (~y).sum()
        if P == 0 or N == 0:
            return 0.5
        tpr = np.concatenate([[0], tps / P])
        fpr = np.concatenate([[0], fps / N])
        return float(np.trapezoid(tpr, fpr))

    def auprc(self) -> float:
        y, tps, fps = self._curve_points()
        P = y.sum()
        if P == 0:
            return 0.0
        precision = tps / (tps + fps)
        recall = tps / P
        return float(np.trapezoid(np.r_[precision[:1], precision],
                                  np.r_[0, recall]))


class ROCMultiClass:
    """One-vs-all ROC per class (ref: ROCMultiClass.java)."""

    def __init__(self):
        self._rocs: Dict[int, ROC] = {}

    def eval(self, labels, predictions, mask=None):
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        for c in range(labels.shape[-1]):
            self._rocs.setdefault(c, ROC()).eval(labels[..., c], predictions[..., c])

    def auc(self, cls: int) -> float:
        return self._rocs[cls].auc()

    def average_auc(self) -> float:
        return float(np.mean([r.auc() for r in self._rocs.values()]))


class RegressionEvaluation:
    """Column-wise regression metrics (ref: RegressionEvaluation.java:
    MSE, MAE, RMSE, RSE, PC, R^2)."""

    def __init__(self):
        self._sum_sq = None

    def eval(self, labels, predictions, mask=None):
        labels = np.asarray(labels, np.float64)
        pred = np.asarray(predictions, np.float64)
        labels = labels.reshape(-1, labels.shape[-1])
        pred = pred.reshape(-1, pred.shape[-1])
        if self._sum_sq is None:
            n = labels.shape[-1]
            self._n = np.zeros(n)
            self._sum_sq = np.zeros(n)
            self._sum_abs = np.zeros(n)
            self._sum_lab = np.zeros(n)
            self._sum_lab_sq = np.zeros(n)
            self._sum_pred = np.zeros(n)
            self._sum_pred_sq = np.zeros(n)
            self._sum_labpred = np.zeros(n)
        d = labels - pred
        self._n += labels.shape[0]
        self._sum_sq += (d ** 2).sum(0)
        self._sum_abs += np.abs(d).sum(0)
        self._sum_lab += labels.sum(0)
        self._sum_lab_sq += (labels ** 2).sum(0)
        self._sum_pred += pred.sum(0)
        self._sum_pred_sq += (pred ** 2).sum(0)
        self._sum_labpred += (labels * pred).sum(0)

    def mean_squared_error(self, col: int) -> float:
        return float(self._sum_sq[col] / self._n[col])

    def mean_absolute_error(self, col: int) -> float:
        return float(self._sum_abs[col] / self._n[col])

    def root_mean_squared_error(self, col: int) -> float:
        return float(np.sqrt(self.mean_squared_error(col)))

    def r_squared(self, col: int) -> float:
        n = self._n[col]
        ss_tot = self._sum_lab_sq[col] - self._sum_lab[col] ** 2 / n
        return float(1.0 - self._sum_sq[col] / ss_tot) if ss_tot else 0.0

    def pearson_correlation(self, col: int) -> float:
        n = self._n[col]
        cov = self._sum_labpred[col] - self._sum_lab[col] * self._sum_pred[col] / n
        vl = self._sum_lab_sq[col] - self._sum_lab[col] ** 2 / n
        vp = self._sum_pred_sq[col] - self._sum_pred[col] ** 2 / n
        d = np.sqrt(vl * vp)
        return float(cov / d) if d else 0.0

    def average_mean_squared_error(self) -> float:
        return float(np.mean(self._sum_sq / self._n))


class ROCBinary:
    """Per-output binary ROC for multi-label sigmoid outputs (ref:
    ROCBinary.java)."""

    def __init__(self):
        self._rocs: Dict[int, ROC] = {}

    def eval(self, labels, predictions, mask=None):
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        if labels.ndim == 1:
            labels = labels[:, None]
            predictions = predictions[:, None]
        for c in range(labels.shape[-1]):
            self._rocs.setdefault(c, ROC()).eval(labels[..., c],
                                                 predictions[..., c])

    def auc(self, output: int = 0) -> float:
        return self._rocs[output].auc()

    def auprc(self, output: int = 0) -> float:
        return self._rocs[output].auprc()

    def num_outputs(self) -> int:
        return len(self._rocs)


class EvaluationCalibration:
    """Reliability diagram + probability histograms (ref:
    EvaluationCalibration.java — reliability bins, residual plot,
    probability histogram; expected calibration error added as the
    summary scalar)."""

    def __init__(self, num_bins: int = 10, residual_bins: int = 20,
                 histogram_bins: int = 20):
        self.num_bins = num_bins
        self.residual_bins = int(residual_bins)
        self.histogram_bins = int(histogram_bins)
        self._counts = np.zeros(num_bins)
        self._pos = np.zeros(num_bins)
        self._prob_sum = np.zeros(num_bins)
        # residual/probability histograms are per-class, allocated when
        # the class count is first seen (ref: EvaluationCalibration's
        # residualPlot + predictionCounts structures)
        self._n_classes: int = 0
        self._residual_all = np.zeros(self.residual_bins)
        self._residual_by_class = None   # [C, residual_bins]
        self._prob_all = None            # [C, histogram_bins]
        self._prob_when_true = None      # [C, histogram_bins]

    def _ensure_classes(self, c: int):
        if self._residual_by_class is None:
            self._n_classes = c
            self._residual_by_class = np.zeros((c, self.residual_bins))
            self._prob_all = np.zeros((c, self.histogram_bins))
            self._prob_when_true = np.zeros((c, self.histogram_bins))
        elif c != self._n_classes:
            raise ValueError(
                f"EvaluationCalibration was built with {self._n_classes} "
                f"classes; got a batch with {c}")

    def eval(self, labels, predictions, mask=None):
        labels = np.asarray(labels)
        pred = np.asarray(predictions)
        if labels.ndim > 1:
            # multiclass: calibration over the predicted-class probability
            cls = pred.argmax(-1)
            p = np.take_along_axis(pred, cls[..., None], -1)[..., 0]
            hit = (labels.argmax(-1) == cls).astype(np.float64)
            lab2 = labels.reshape(-1, labels.shape[-1])
            pred2 = pred.reshape(-1, pred.shape[-1])
        else:
            p = pred
            hit = (labels > 0.5).astype(np.float64)
            lab1 = labels.reshape(-1)
            lab2 = np.stack([1.0 - lab1, lab1], -1)
            pr1 = np.clip(pred.reshape(-1), 0.0, 1.0)
            pred2 = np.stack([1.0 - pr1, pr1], -1)
        # honor the (per-sample or per-timestep) mask everywhere: rows
        # with mask==0 contribute to NO statistic
        keep = None
        if mask is not None:
            keep = np.asarray(mask).reshape(-1) > 0
            lab2, pred2 = lab2[keep], pred2[keep]
        bins = np.clip((p * self.num_bins).astype(int), 0,
                       self.num_bins - 1)
        flat = zip(bins.reshape(-1), hit.reshape(-1),
                   np.asarray(p).reshape(-1),
                   keep if keep is not None else np.ones(bins.size, bool))
        for b, h, pr, k in flat:
            if not k:
                continue
            self._counts[b] += 1
            self._pos[b] += h
            self._prob_sum[b] += pr
        # residual plot: |label - predicted prob| over every
        # (sample, class) cell, aggregate + per class (ref:
        # EvaluationCalibration.getResidualPlotAllClasses / :classIdx)
        self._ensure_classes(lab2.shape[-1])
        resid = np.abs(lab2 - pred2)
        rb = np.clip((resid * self.residual_bins).astype(int), 0,
                     self.residual_bins - 1)
        pb = np.clip((np.clip(pred2, 0, 1)
                      * self.histogram_bins).astype(int), 0,
                     self.histogram_bins - 1)
        true_cls = lab2.argmax(-1)
        for c in range(self._n_classes):
            self._residual_by_class[c] += np.bincount(
                rb[:, c], minlength=self.residual_bins)
            self._residual_all += np.bincount(
                rb[:, c], minlength=self.residual_bins)
            self._prob_all[c] += np.bincount(
                pb[:, c], minlength=self.histogram_bins)
            sel = true_cls == c
            if sel.any():
                self._prob_when_true[c] += np.bincount(
                    pb[sel, c], minlength=self.histogram_bins)

    # -- residual / probability histograms (ref: getResidualPlot,
    # getProbabilityHistogram in EvaluationCalibration.java) -----------
    def residual_plot(self, class_idx=None):
        """Histogram counts of |label - p| over [0, 1]; aggregated over
        all classes when class_idx is None."""
        if self._residual_by_class is None:
            return np.zeros(self.residual_bins)
        if class_idx is None:
            return self._residual_all.copy()
        return self._residual_by_class[class_idx].copy()

    def probability_histogram(self, class_idx: int, when_true: bool = False):
        """Distribution of predicted probabilities for class_idx over
        [0, 1] — all samples, or only samples whose TRUE label is that
        class (when_true)."""
        if self._prob_all is None:
            return np.zeros(self.histogram_bins)
        src = self._prob_when_true if when_true else self._prob_all
        return src[class_idx].copy()

    def reliability_curve(self):
        """Returns (mean predicted prob per bin, empirical accuracy per
        bin, counts)."""
        with np.errstate(invalid="ignore"):
            mean_p = np.where(self._counts > 0,
                              self._prob_sum / np.maximum(self._counts, 1),
                              np.nan)
            acc = np.where(self._counts > 0,
                           self._pos / np.maximum(self._counts, 1), np.nan)
        return mean_p, acc, self._counts.copy()

    def expected_calibration_error(self) -> float:
        mean_p, acc, counts = self.reliability_curve()
        total = counts.sum()
        if total == 0:
            return 0.0
        valid = counts > 0
        return float(np.sum(counts[valid] * np.abs(mean_p[valid]
                                                   - acc[valid])) / total)
