"""A helper of the tests that build JAX package models to hold the port
against (a helper module: pytest does not collect it).

``numpy_init(seed)`` draws the JAX layers' random initial weights from a
numpy ``RandomState(seed)`` instead of jax.random: the same distributions
(each initializer's mean, std, bounds and fans), without compiling a
random kernel for every parameter shape, which makes a JAX ResNet take
~20 s to build on the CPU. The models and their arithmetic are untouched.
"""
import contextlib
import math

import jax.numpy as jnp
import numpy as np

from paddle_tpu.core import dtype as dtypes
from paddle_tpu.nn import initializer as I


@contextlib.contextmanager
def numpy_init(seed=0):
    rng = np.random.RandomState(seed)

    def normal(shape, std, mean, dtype):
        a = rng.standard_normal(shape) * std + mean
        return jnp.asarray(a.astype(np.float32)).astype(dtypes.convert_dtype(dtype))

    def uniform(shape, low, high, dtype):
        a = rng.uniform(low, high, shape)
        return jnp.asarray(a.astype(np.float32)).astype(dtypes.convert_dtype(dtype))

    def xavier_std(self, shape):
        fi, fo = I._fan_in_out(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        return fi, fo

    patches = {
        I.Normal: lambda self, shape, dtype: normal(shape, self.std, self.mean, dtype),
        I.TruncatedNormal: lambda self, shape, dtype: normal(
            shape, 1.0, 0.0, dtype).clip(-2.0, 2.0) * self.std + self.mean,
        I.Uniform: lambda self, shape, dtype: uniform(shape, self.low, self.high, dtype),
        I.XavierNormal: lambda self, shape, dtype: normal(
            shape, self.gain * math.sqrt(2.0 / sum(xavier_std(self, shape))), 0.0, dtype),
        I.XavierUniform: lambda self, shape, dtype: uniform(
            shape, *(lambda lim: (-lim, lim))(
                self.gain * math.sqrt(6.0 / sum(xavier_std(self, shape)))), dtype),
    }
    saved = {cls: cls.__call__ for cls in patches}
    try:
        for cls, fn in patches.items():
            cls.__call__ = fn
        yield
    finally:
        for cls, fn in saved.items():
            cls.__call__ = fn
