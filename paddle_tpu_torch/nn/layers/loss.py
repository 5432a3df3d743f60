"""Loss layers (counterpart of paddle_tpu/nn/layers/loss.py):
``CrossEntropyLoss``, ``MSELoss``, ``L1Loss``, ``NLLLoss``, ``BCELoss``,
``BCEWithLogitsLoss``, ``KLDivLoss``, ``SmoothL1Loss``,
``MarginRankingLoss``, ``CosineEmbeddingLoss``, ``CTCLoss``,
``HingeEmbeddingLoss`` and ``HSigmoidLoss``; each calls its op of
ops/nn_functional.py."""
from __future__ import annotations

import math

from ...ops import nn_functional as F
from ..layer import Layer
from .common import init_const_, init_uniform_, make_param, place


class CrossEntropyLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean", soft_label=False,
                 axis=-1, use_softmax=True, label_smoothing=0.0, name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.soft_label = soft_label
        self.axis = axis
        self.use_softmax = use_softmax
        self.label_smoothing = label_smoothing

    def forward(self, input, label):
        return F.cross_entropy(input, label, weight=self.weight,
                               ignore_index=self.ignore_index, reduction=self.reduction,
                               soft_label=self.soft_label, axis=self.axis,
                               use_softmax=self.use_softmax,
                               label_smoothing=self.label_smoothing)


class MSELoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.mse_loss(input, label, self.reduction)


class L1Loss(Layer):
    def __init__(self, reduction="mean", name=None):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.l1_loss(input, label, self.reduction)


class NLLLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean", name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction

    def forward(self, input, label):
        return F.nll_loss(input, label, self.weight, self.ignore_index, self.reduction)


class BCELoss(Layer):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction

    def forward(self, input, label):
        return F.binary_cross_entropy(input, label, self.weight, self.reduction)


class BCEWithLogitsLoss(Layer):
    def __init__(self, weight=None, reduction="mean", pos_weight=None, name=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction
        self.pos_weight = pos_weight

    def forward(self, logit, label):
        return F.binary_cross_entropy_with_logits(logit, label, self.weight,
                                                  self.reduction, self.pos_weight)


class KLDivLoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.kl_div(input, label, self.reduction)


class SmoothL1Loss(Layer):
    def __init__(self, reduction="mean", delta=1.0, name=None):
        super().__init__()
        self.reduction = reduction
        self.delta = delta

    def forward(self, input, label):
        return F.smooth_l1_loss(input, label, self.reduction, self.delta)


class MarginRankingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self.margin, self.reduction = margin, reduction

    def forward(self, input, other, label):
        return F.margin_ranking_loss(input, other, label, self.margin, self.reduction)


class CosineEmbeddingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self.margin, self.reduction = margin, reduction

    def forward(self, input1, input2, label):
        return F.cosine_embedding_loss(input1, input2, label, self.margin, self.reduction)


class CTCLoss(Layer):
    def __init__(self, blank=0, reduction="mean"):
        super().__init__()
        self.blank, self.reduction = blank, reduction

    def forward(self, logits, labels, input_lengths, label_lengths, norm_by_times=False):
        return F.ctc_loss(logits, labels, input_lengths, label_lengths, self.blank,
                          self.reduction, norm_by_times)


class HingeEmbeddingLoss(Layer):
    def __init__(self, margin=1.0, reduction="mean", name=None):
        super().__init__()
        self.margin, self.reduction = margin, reduction

    def forward(self, input, label):
        return F.hinge_embedding_loss(input, label, self.margin, self.reduction)


class HSigmoidLoss(Layer):
    """Hierarchical sigmoid head: weight ``[C, feature_size]`` drawn from
    U(-1/sqrt(feature_size), 1/sqrt(feature_size)), bias ``[C, 1]``, with C
    = ``num_classes - 1`` internal nodes of the default tree (``num_classes``
    with a custom one)."""

    def __init__(self, feature_size, num_classes, weight_attr=None, bias_attr=None,
                 is_custom=False, is_sparse=False, name=None, device=None):
        super().__init__()
        if num_classes < 2 and not is_custom:
            raise ValueError("num_classes must not be less than 2 with default tree")
        self.feature_size, self.num_classes, self.is_custom = feature_size, num_classes, \
            is_custom
        c = num_classes if is_custom else num_classes - 1
        self.weight = make_param((c, feature_size), weight_attr)
        self.bias = make_param((c, 1), bias_attr, is_bias=True)
        self.reset_parameters()
        place(self, device)

    def reset_parameters(self, generator=None):
        bound = 1.0 / math.sqrt(self.feature_size)
        init_uniform_(self.weight, -bound, bound, generator)
        init_const_(self.bias, 0.0)

    def forward(self, input, label, path_table=None, path_code=None):
        return F.hsigmoid_loss(input, label, self.num_classes, self.weight, self.bias,
                               path_table, path_code)
