"""``Layer``, ``Parameter``, ``ParamAttr`` and ``create_parameter``
(counterpart of paddle_tpu/nn/layer.py).

``Layer`` is a subclass of ``torch.nn.Module`` (torch's module is left
untouched) that adds the reference's methods torch lacks:
``create_parameter``, ``create_tensor``, ``add_parameter``,
``add_sublayer``, ``sublayers``, ``named_sublayers``, ``set_state_dict``,
``register_forward_post_hook`` (torch's forward hook; both hooks return
torch's handle, which ``HookRemoveHelper`` names), ``full_name`` and
``astype``. Every layer of ``nn/layers/`` is one.

``Parameter`` is a ``torch.nn.Parameter`` carrying the reference's
attributes: ``trainable`` (``requires_grad``), ``optimize_attr``
``{"learning_rate": ...}``, ``regularizer`` (which the optimizers read),
``need_clip`` and ``name``. A parameter keeps the initializer of its
``ParamAttr``, so a layer's ``reset_parameters`` draws it again
(``nn/layers/common.py``).

An initializer is called with the JAX package's shape of the parameter
(nn/initializer.py); ``create_parameter`` has no layout of its own and
gives that shape as it is.
"""
from __future__ import annotations

import copy

import numpy as np
import torch
from torch import nn
from torch.utils.hooks import RemovableHandle

from ..core import dtype as dtypes
from ..device import resolve_device

__all__ = ["Layer", "Parameter", "ParamAttr", "create_parameter", "HookRemoveHelper"]


class Parameter(nn.Parameter):
    """A trainable tensor (``trainable`` is ``requires_grad``) with the
    reference's optimizer attributes."""

    def __new__(cls, data=None, trainable=True, name=""):
        if data is None:
            data = torch.empty(0)
        return super().__new__(cls, data, requires_grad=trainable)

    def __init__(self, data=None, trainable=True, name=""):
        self._param_name = name or ""
        self.persistable = True
        self.is_distributed = False
        self.optimize_attr = {"learning_rate": 1.0}
        self.regularizer = None
        self.need_clip = True

    @property
    def name(self):
        return self._param_name

    @name.setter
    def name(self, value):
        self._param_name = value

    @property
    def trainable(self):
        return self.requires_grad

    @trainable.setter
    def trainable(self, value):
        self.requires_grad_(bool(value))

    @property
    def stop_gradient(self):
        return not self.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value):
        self.requires_grad_(not value)

    def __deepcopy__(self, memo):
        if id(self) in memo:
            return memo[id(self)]
        result = type(self)(self.data.clone(memory_format=torch.preserve_format),
                            self.requires_grad)
        memo[id(self)] = result
        result.__dict__.update(copy.deepcopy(self.__dict__, memo))
        return result

    def rewrap(self, data):
        """A Parameter of ``data`` with this one's attributes (for a module
        whose parameters torch replaced by plain ones, e.g. ``to_empty``)."""
        out = Parameter(data, self.requires_grad)
        out.__dict__.update(self.__dict__)
        return out


class ParamAttr:
    """A parameter's name, initializer, learning rate, regularizer,
    trainability and clipping."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0, regularizer=None,
                 trainable=True, do_model_average=True, need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        """None -> the defaults, False -> False (no parameter), a string ->
        its name, a bare initializer -> its initializer."""
        if attr is None:
            return ParamAttr()
        if attr is False:
            return False
        if isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        return ParamAttr(initializer=attr)


def parameter_of(data, attr):
    """A ``Parameter`` of ``data`` with ``attr``'s name, trainability and
    optimizer attributes."""
    p = Parameter(data, trainable=attr.trainable, name=attr.name or "")
    p.optimize_attr["learning_rate"] = attr.learning_rate
    p.regularizer = attr.regularizer
    p.need_clip = attr.need_clip
    return p


def _place():
    return torch.device("meta") if torch.get_default_device().type == "meta" \
        else resolve_device(None)


def create_parameter(shape, dtype="float32", name=None, attr=None, is_bias=False,
                     default_initializer=None):
    """A ``Parameter`` of ``shape`` on the current place. Its initializer is
    the attr's, else ``default_initializer``, else ``set_global_initializer``'s,
    else ``Constant(0)`` for a bias and ``XavierNormal`` otherwise."""
    from . import initializer as I

    attr = ParamAttr._to_attr(attr)
    if attr is False:
        return None
    if name is not None and attr.name is None:
        attr.name = name
    dtype = dtypes.convert_dtype(dtype)
    init = attr.initializer or default_initializer
    if init is None:
        init = I._global_default(is_bias)
    if init is None:
        init = I.Constant(0.0) if is_bias else I.XavierNormal()
    shape = tuple(int(s) for s in shape)
    dev = _place()
    data = torch.empty(shape, dtype=dtype, device=dev) if dev.type == "meta" \
        else init(shape, dtype).to(dev)
    return parameter_of(data, attr)


# ``remove()`` takes a hook off its layer: torch's handle, under the
# reference's name.
HookRemoveHelper = RemovableHandle


class Layer(nn.Module):
    def __init__(self, name_scope=None, dtype="float32"):
        super().__init__()
        self._dtype = dtypes.convert_dtype(dtype)
        self._name_scope = name_scope or type(self).__name__.lower()

    # ---- parameters and tensors ----
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None):
        return create_parameter(shape, dtype or self._dtype, attr=attr, is_bias=is_bias,
                                default_initializer=default_initializer)

    def create_tensor(self, name=None, persistable=None, dtype=None):
        return torch.zeros((), dtype=dtypes.convert_dtype(dtype or self._dtype),
                           device=_place())

    def add_parameter(self, name, parameter):
        if parameter is not None and not isinstance(parameter, nn.Parameter):
            raise TypeError("add_parameter expects a Parameter")
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name, sublayer):
        self.add_module(str(name), sublayer)
        return sublayer

    # ---- traversal ----
    def sublayers(self, include_self=False):
        return [m for _, m in self.named_sublayers(include_self=include_self)]

    def named_sublayers(self, prefix="", include_self=False):
        for name, m in self.named_modules(prefix=prefix):
            if m is not self or include_self:
                yield name, m

    # ---- state ----
    @torch.no_grad()
    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copies every entry whose name this layer has into it (numpy
        arrays or tensors); returns (missing, unexpected) names."""
        own = self.state_dict(keep_vars=True)
        missing = [k for k in own if k not in state_dict]
        unexpected = []
        for k, v in state_dict.items():
            if k not in own:
                unexpected.append(k)
                continue
            v = v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))
            own[k].copy_(v.reshape(own[k].shape))
        return missing, unexpected

    set_dict = set_state_dict
    load_dict = set_state_dict

    # ---- hooks ----
    def register_forward_post_hook(self, hook):
        """``hook(layer, inputs, outputs)`` after forward (torch's forward
        hook)."""
        return self.register_forward_hook(hook)

    # ---- the rest ----
    def full_name(self):
        return self._name_scope

    def astype(self, dtype):
        self._dtype = dtypes.convert_dtype(dtype)
        return self.to(dtype=self._dtype)
