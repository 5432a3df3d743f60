"""Pipeline-parallel layer description and segmentation (counterpart of
paddle_tpu/distributed/meta_parallel/pp_layers.py; reference
fleet/meta_parallel/parallel_layers/pp_layers.py:159).

A ``PipelineLayer`` is a list of ``LayerDesc`` (a module class and its
arguments, built here), ``SharedLayerDesc`` (one module under a key, shared
by every entry with that key, e.g. tied embeddings), modules and callables;
``segment_parts`` cuts the list into ``num_stages`` contiguous stages by
``seg_method``: "uniform" (equal counts, the first ones one longer),
"layer:<Class>" (cut at the entries of that module class, evenly over
them) or "param_size" (cumulative parameter counts). Eagerly it is the
plain sequential stack, as in the JAX package: the stacked SPMD pipeline
is distributed/pipeline_schedule.py, which ``GPTForPretrainingPipe``
runs.
"""
from __future__ import annotations

from typing import List

from torch import nn

from ..mesh import get_hybrid_communicate_group


class LayerDesc:
    def __init__(self, layer_cls, *inputs, **kwargs):
        self.layer_cls = layer_cls
        self.inputs = inputs
        self.kwargs = kwargs
        if not (isinstance(layer_cls, type) and issubclass(layer_cls, nn.Module)):
            raise TypeError(f"LayerDesc expects an nn.Module subclass, got {layer_cls}")

    def build_layer(self):
        return self.layer_cls(*self.inputs, **self.kwargs)

    def __repr__(self):
        return f"LayerDesc({self.layer_cls.__name__})"


class SharedLayerDesc(LayerDesc):
    def __init__(self, key, layer_cls, forward_func=None, shared_weight_attr="weight",
                 *inputs, **kwargs):
        super().__init__(layer_cls, *inputs, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


class PipelineLayer(nn.Module):
    def __init__(self, layers, num_stages=None, topology=None, loss_fn=None,
                 seg_method="uniform", recompute_interval=0, recompute_ctx=None,
                 num_virtual_pipeline_stages=None):
        super().__init__()
        hcg = topology or get_hybrid_communicate_group()
        self._num_stages = num_stages or (hcg.get_pipe_parallel_world_size() if hcg else 1)
        self._loss_fn = loss_fn
        self._seg_method = seg_method
        self._recompute_interval = recompute_interval

        self._descs: List = list(layers)
        self._shared = {}
        built = []
        for i, d in enumerate(self._descs):
            if isinstance(d, SharedLayerDesc):
                if d.layer_name in self._shared:
                    built.append(("shared", d.layer_name, d.forward_func))
                else:
                    layer = d.build_layer()
                    self._shared[d.layer_name] = layer
                    self.add_module(f"shared_{d.layer_name}", layer)
                    built.append(("shared_first", d.layer_name, d.forward_func))
            elif isinstance(d, LayerDesc):
                layer = d.build_layer()
                self.add_module(str(i), layer)
                built.append(("layer", layer, None))
            elif isinstance(d, nn.Module):
                self.add_module(str(i), d)
                built.append(("layer", d, None))
            elif callable(d):
                built.append(("func", d, None))
            else:
                raise TypeError(f"unsupported pipeline entry {d!r}")
        self._built = built
        self.segment_parts = self._segment_network(self._num_stages)

    # reference pp_layers.py:314
    def _segment_network(self, num_stages) -> List[int]:
        n = len(self._built)
        if self._seg_method == "uniform" or not self._seg_method:
            base = n // num_stages
            extra = n % num_stages
            bounds = [0]
            for s in range(num_stages):
                bounds.append(bounds[-1] + base + (1 if s < extra else 0))
            return bounds
        if self._seg_method.startswith("layer:"):
            cls_name = self._seg_method.split(":", 1)[1]
            marks = [i for i, (kind, l, _) in enumerate(self._built)
                     if kind == "layer" and type(l).__name__ == cls_name]
            if not marks:
                raise ValueError(f"seg_method {self._seg_method!r}: no layer matches")
            per = len(marks) / num_stages
            bounds = [0]
            for s in range(1, num_stages):
                bounds.append(marks[min(int(per * s), len(marks) - 1)])
            bounds.append(len(self._built))
            return bounds
        if self._seg_method == "param_size":
            sizes = []
            for kind, l, _ in self._built:
                if kind == "layer":
                    sizes.append(sum(p.numel() for p in l.parameters()))
                elif kind.startswith("shared"):
                    sizes.append(sum(p.numel() for p in self._shared_for(l).parameters()))
                else:
                    sizes.append(0)
            total = sum(sizes) or 1
            target = total / num_stages
            bounds = [0]
            acc = 0
            for i, s in enumerate(sizes):
                acc += s
                if acc >= target * len(bounds) and len(bounds) < num_stages:
                    bounds.append(i + 1)
            while len(bounds) < num_stages:
                bounds.append(len(self._built))
            bounds.append(len(self._built))
            return bounds[: num_stages + 1]
        raise ValueError(f"unknown seg_method {self._seg_method!r}")

    def _shared_for(self, name):
        return self._shared[name]

    def get_stage_layers(self, stage: int):
        lo, hi = self.segment_parts[stage], self.segment_parts[stage + 1]
        return self._built[lo:hi]

    def forward(self, x):
        for kind, item, ffn in self._built:
            if kind in ("layer", "func"):
                x = item(x)
            else:  # shared / shared_first
                layer = self._shared[item]
                x = ffn(layer, x) if ffn is not None else layer(x)
        return x

    def loss(self, out, label):
        return self._loss_fn(out, label) if self._loss_fn else out
