"""Metrics of the port (counterpart of paddle_tpu/metric/__init__.py;
reference python/paddle/metric/metrics.py): ``Metric``, ``Accuracy``
(top-k), ``Precision``, ``Recall``, ``Auc`` and ``accuracy``.

They count on the host in numpy, as the JAX package's do: a torch tensor
argument is copied to the host first (``hapi.Model`` hands them numpy
already). ``accuracy`` returns an f32 scalar tensor on its input's device.
"""
from __future__ import annotations

import numpy as np
import torch


def _np(x):
    """``x`` as a numpy array (a torch tensor copied to the host)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class Metric:
    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        return self.__class__.__name__.lower()

    def compute(self, *args):
        return args


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None):
        self.topk = topk if isinstance(topk, (list, tuple)) else (topk,)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def compute(self, pred, label, *args):
        pred_np = _np(pred)
        label_np = _np(label)
        if label_np.ndim == pred_np.ndim:
            label_np = label_np.squeeze(-1)
        top = np.argsort(-pred_np, axis=-1)[..., : self.maxk]
        correct = top == label_np[..., None]
        return correct

    def update(self, correct, *args):
        correct = _np(correct)
        n = correct.shape[0] if correct.ndim else 1
        accs = []
        for i, k in enumerate(self.topk):
            c = correct[..., :k].any(-1).sum()
            self.total[i] += float(c)
            self.count[i] += n
            accs.append(float(c) / n)
        return accs[0] if len(accs) == 1 else accs

    def accumulate(self):
        res = [t / c if c else 0.0 for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        return self._name


class Precision(Metric):
    def __init__(self, name="precision"):
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds = _np(preds)
        labels = _np(labels)
        pred_pos = (preds.round() if preds.dtype.kind == "f" else preds) == 1
        self.tp += int(((pred_pos) & (labels == 1)).sum())
        self.fp += int(((pred_pos) & (labels == 0)).sum())

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name="recall"):
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds = _np(preds)
        labels = _np(labels)
        pred_pos = (preds.round() if preds.dtype.kind == "f" else preds) == 1
        self.tp += int((pred_pos & (labels == 1)).sum())
        self.fn += int((~pred_pos & (labels == 1)).sum())

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    def __init__(self, curve="ROC", num_thresholds=4095, name="auc"):
        self._name = name
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        preds = _np(preds)
        labels = _np(labels).reshape(-1)
        pos_prob = preds[:, 1] if preds.ndim == 2 and preds.shape[1] == 2 else preds.reshape(-1)
        bins = np.minimum((pos_prob * self.num_thresholds).astype(int), self.num_thresholds)
        for b, l in zip(bins, labels):
            if l:
                self._stat_pos[b] += 1
            else:
                self._stat_neg[b] += 1

    def accumulate(self):
        tot_pos = 0.0
        tot_neg = 0.0
        auc = 0.0
        for i in range(self.num_thresholds, -1, -1):
            new_pos = tot_pos + self._stat_pos[i]
            new_neg = tot_neg + self._stat_neg[i]
            auc += (new_pos + tot_pos) * (new_neg - tot_neg) / 2.0
            tot_pos, tot_neg = new_pos, new_neg
        denom = tot_pos * tot_neg
        return auc / denom if denom else 0.0

    def name(self):
        return self._name


def accuracy(input, label, k=1):
    """The share of rows whose label is among the top ``k`` of ``input``, as
    an f32 scalar tensor on ``input``'s device."""
    pred = _np(input)
    lab = _np(label)
    if lab.ndim == pred.ndim:
        lab = lab.squeeze(-1)
    top = np.argsort(-pred, axis=-1)[..., :k]
    correct = (top == lab[..., None]).any(-1).mean()
    return torch.tensor(np.float32(correct), device=input.device
                        if isinstance(input, torch.Tensor) else "cpu")


__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]
