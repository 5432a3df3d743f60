"""Coverage audit of the reference's phi API surface against the port's
namespace (counterpart of tools/op_coverage.py).

Reads the port's copy of the reference's generated-API lists
(``api_surface.json`` beside this file: api.yaml's 235 forward entries and
backward.yaml's 182 grads) and sorts every entry into exactly one bucket
against ``paddle_tpu_torch``:

  implemented  resolvable to a public callable (the alias map translates a
               legacy op name to the public path, e.g. ``reduce_prod`` ->
               ``prod``, ``where_index`` -> ``nonzero``)
  waived       intentionally absent, with the reason
  missing      not ported yet, with the ROADMAP item that will port it

A backward entry is implemented when its forward is: torch.autograd
differentiates every op of the port.

Run:  python -m paddle_tpu_torch.tools.op_coverage [--json]
"""
from __future__ import annotations

import argparse
import json
import os
import re
import sys

_SURFACE = os.path.join(os.path.dirname(__file__), "api_surface.json")

# legacy / phi op name -> where it lives in the port (dotted under paddle_tpu_torch)
ALIASES = {
    "accuracy": "metric.accuracy", "auc": "metric.Auc",
    "batch_norm": "ops.nn_functional.batch_norm",
    "bce_loss": "ops.nn_functional.binary_cross_entropy", "brelu": "hardtanh",
    "cholesky": "linalg.cholesky", "cholesky_solve": "linalg.cholesky_solve",
    "conv2d": "ops.nn_functional.conv2d",
    "conv2d_transpose": "ops.nn_functional.conv2d_transpose",
    "conv3d_transpose": "ops.nn_functional.conv3d_transpose",
    "copy_to": "Tensor.cuda",
    "cross_entropy_with_softmax": "ops.nn_functional.cross_entropy",
    "deformable_conv": "vision.ops.deform_conv2d",
    "depthwise_conv2d_transpose": "ops.nn_functional.conv2d_transpose",
    "det": "linalg.det", "dropout": "ops.nn_functional.dropout", "eigh": "linalg.eigh",
    "elementwise_pow": "pow", "frobenius_norm": "linalg.norm",
    "full_batch_size_like": "full_like", "gather_tree": "nn.functional.gather_tree",
    "gaussian_random": "normal", "graph_send_recv": "geometric.send_u_recv",
    "hard_shrink": "hardshrink", "hard_sigmoid": "hardsigmoid", "hard_swish": "hardswish",
    "huber_loss": "ops.nn_functional.smooth_l1_loss",
    "kldiv_loss": "ops.nn_functional.kl_div", "label_smooth": "ops.nn_functional.label_smooth",
    "layer_norm": "ops.nn_functional.layer_norm", "log_loss": "ops.nn_functional.log_loss",
    "logsigmoid": "log_sigmoid", "matrix_power": "linalg.matrix_power",
    "matrix_rank": "linalg.matrix_rank", "matrix_rank_tol": "linalg.matrix_rank",
    "max_pool2d_with_index": "ops.nn_functional.max_pool2d",
    "max_pool3d_with_index": "ops.nn_functional.max_pool3d", "mean_all": "mean",
    "modulo": "remainder", "nll_loss": "ops.nn_functional.nll_loss", "norm": "linalg.norm",
    "one_hot": "ops.nn_functional.one_hot", "p_norm": "linalg.norm",
    "pad3d": "pad", "pixel_shuffle": "ops.nn_functional.pixel_shuffle",
    "pool2d": "ops.nn_functional.avg_pool2d", "pool3d": "ops.nn_functional.avg_pool3d",
    "psroi_pool": "vision.ops.psroi_pool", "qr": "linalg.qr", "reduce_prod": "prod",
    "roi_align": "vision.ops.roi_align", "roi_pool": "vision.ops.roi_pool",
    "segment_pool": "incubate.segment_sum", "sgd": "optimizer.SGD", "adam": "optimizer.Adam",
    "adamw": "optimizer.AdamW", "adamax": "optimizer.Adamax",
    "adadelta": "optimizer.Adadelta", "momentum": "optimizer.Momentum",
    "sigmoid_cross_entropy_with_logits": "ops.nn_functional.binary_cross_entropy_with_logits",
    "size": "numel", "soft_shrink": "softshrink", "tanh_shrink": "tanhshrink", "top_k": "topk",
    "triangular_solve": "linalg.triangular_solve", "tril_triu": "tril",
    "truncated_gaussian_random": "nn.initializer.TruncatedNormal",
    "unfold": "ops.nn_functional.unfold", "uniform_random": "uniform",
    "viterbi_decode": "text.viterbi_decode", "where_index": "nonzero",
    "yolo_box": "vision.ops.yolo_box",
}

# intentionally absent entries: name -> reason
WAIVED = {}

# entries not ported yet: name -> the ROADMAP item that ports them
_ITEM11_VISION = "Queue 1 item 11 (vision/ops.py)"
_ITEM11_INCUBATE = "Queue 1 item 11 (the rest of incubate/)"
_ITEM11_GEOMETRIC = "Queue 1 item 11 (geometric/)"
MISSING_ITEMS = {
    **{n: _ITEM11_VISION for n in ("deformable_conv", "psroi_pool", "roi_align", "roi_pool",
                                   "yolo_box")},
    "segment_pool": _ITEM11_INCUBATE,
    "graph_send_recv": _ITEM11_GEOMETRIC,
}


def load_surface(path=_SURFACE):
    with open(path) as f:
        snap = json.load(f)
    return snap["apis"], snap["backward_apis"]


def resolve(paddle, name):
    """The dotted path under ``paddle`` that implements ``name``, or None."""
    for dotted in (ALIASES.get(name), name, f"ops.nn_functional.{name}", f"linalg.{name}"):
        if not dotted:
            continue
        obj = paddle
        for part in dotted.split("."):
            try:
                obj = getattr(obj, part)
            except (AttributeError, ImportError):
                obj = None
                break
        if obj is not None and callable(obj):
            return dotted
    return None


def forward_of(backward_name):
    """The forward entry of a grad entry: foo_grad, foo_double_grad,
    foo_triple_grad -> foo."""
    return re.sub(r"(_(?:double|triple))?(_grad)+$", "", backward_name)


def audit():
    import paddle_tpu_torch as paddle

    apis, bwds = load_surface()
    rep = {"implemented": {}, "waived": {}, "missing": {},
           "backward": {"implemented": [], "waived": {}, "missing": {}}}
    for name in apis:
        path = resolve(paddle, name)
        if path is not None:
            rep["implemented"][name] = path
        elif name in WAIVED:
            rep["waived"][name] = WAIVED[name]
        else:
            rep["missing"][name] = MISSING_ITEMS.get(name)
    for bname in bwds:
        fwd = forward_of(bname)
        if fwd in rep["implemented"] or resolve(paddle, fwd) is not None:
            rep["backward"]["implemented"].append(bname)
        elif fwd in WAIVED:
            rep["backward"]["waived"][bname] = WAIVED[fwd]
        else:
            rep["backward"]["missing"][bname] = MISSING_ITEMS.get(fwd)
    rep["counts"] = {
        "apis": len(apis), "implemented": len(rep["implemented"]),
        "waived": len(rep["waived"]), "missing": len(rep["missing"]),
        "backward_apis": len(bwds), "backward_implemented": len(rep["backward"]["implemented"]),
        "backward_waived": len(rep["backward"]["waived"]),
        "backward_missing": len(rep["backward"]["missing"])}
    return rep


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", action="store_true", help="print the whole report as JSON")
    args = ap.parse_args(argv)
    rep = audit()
    if args.json:
        json.dump(rep, sys.stdout, indent=1)
        return
    c = rep["counts"]
    print(f"forward APIs: {c['apis']}  implemented {c['implemented']}  "
          f"waived {c['waived']}  missing {c['missing']}")
    print(f"backward APIs: {c['backward_apis']}  implemented {c['backward_implemented']}  "
          f"waived {c['backward_waived']}  missing {c['backward_missing']}")
    for name, item in sorted(rep["missing"].items()):
        print(f"MISSING {name}: {item}")


if __name__ == "__main__":
    main()
