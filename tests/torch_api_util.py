"""A helper of the tensor-API tests (a helper module: pytest does not collect
it): the same numpy inputs through ``paddle_tpu.<op>`` and
``paddle_tpu_torch.<op>``, compared in dtype, shape and value, and each
differentiable op's gradients by ``paddle_tpu.grad`` against
``paddle_tpu_torch.grad``.

An op's arguments are built by a function of a seeded ``Inputs``: a numpy
array becomes a tensor in each package (bf16 through ml_dtypes), ``L([...])``
a list of tensors, anything else passes as it is.
"""
import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp

BF16 = np.dtype(ml_dtypes.bfloat16)


class L(list):
    """An argument that is a list of tensors."""


class Inputs:
    def __init__(self, seed=0):
        self.rng = np.random.RandomState(seed)

    def arr(self, shape, kind="f32"):
        r = self.rng
        if kind in ("f32", "f64", "bf16"):
            a = r.standard_normal(shape)
        elif kind == "pos":                  # (0.5, 2.5): logs, roots, gammas
            a = r.uniform(0.5, 2.5, shape)
        elif kind == "unit":                 # (-0.9, 0.9): asin, atanh, erfinv
            a = r.uniform(-0.9, 0.9, shape)
        elif kind == "gt1":                  # (1.2, 3): acosh
            a = r.uniform(1.2, 3.0, shape)
        elif kind == "prob":                 # (0.05, 0.95): logit
            a = r.uniform(0.05, 0.95, shape)
        elif kind in ("i64", "i32"):
            return r.randint(-5, 6, shape).astype(np.int64 if kind == "i64" else np.int32)
        elif kind == "nat":                  # [1, 9]: gcd, shifts, bincount
            return r.randint(1, 10, shape).astype(np.int64)
        elif kind == "bool":
            return r.rand(*shape) > 0.5
        elif kind == "c64":
            return (r.standard_normal(shape) + 1j * r.standard_normal(shape)).astype(
                np.complex64)
        else:
            raise ValueError(kind)
        if kind == "f64":
            return a.astype(np.float64)
        if kind == "bf16":
            return a.astype(np.float32).astype(BF16)
        return a.astype(np.float32)

    def spd(self, n, kind="f64"):
        """A symmetric positive definite n x n matrix."""
        a = self.rng.standard_normal((n, n))
        return (a @ a.T + n * np.eye(n)).astype(np.float64 if kind == "f64" else np.float32)


def to_jax(a, grad=False):
    if isinstance(a, L):
        return [to_jax(x, grad) for x in a]
    if isinstance(a, np.ndarray):
        t = jp.to_tensor(a, dtype=str(a.dtype))
        if grad and np.issubdtype(a.dtype, np.floating):
            t.stop_gradient = False
        return t
    return a


def to_torch(a, grad=False):
    if isinstance(a, L):
        return [to_torch(x, grad) for x in a]
    if isinstance(a, np.ndarray):
        if a.dtype == BF16:
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(a.copy())
        if grad and t.is_floating_point():
            t.requires_grad_(True)
        return t
    return a


def leaves(args):
    out = []
    for a in args:
        if isinstance(a, list):
            out.extend(leaves(a))
        elif a is not None and hasattr(a, "shape") and hasattr(a, "dtype"):
            out.append(a)
    return out


def np_of(x):
    """A numpy array of a result of either package."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.float().numpy().astype(BF16)
        return x.resolve_conj().numpy()
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


def dtype_name(x):
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return str(np.dtype(x.dtype))


def assert_same(got, want, tol, what="out", check_dtype=True):
    """``got`` (port) against ``want`` (JAX package): same structure, dtype
    and shape; integer and bool values equal, float within
    ``tol`` = (rtol, atol)."""
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), (what, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, tol, f"{what}[{i}]", check_dtype)
        return
    if isinstance(want, (bool, int, float, np.bool_)):
        assert got == want, (what, got, want)
        return
    g, w = np_of(got), np_of(want)
    if check_dtype:
        assert dtype_name(got) == dtype_name(want), (what, dtype_name(got), dtype_name(want))
    assert g.shape == w.shape, (what, g.shape, w.shape)
    if w.dtype.kind in "biu":
        np.testing.assert_array_equal(g, w, err_msg=what)
    else:
        rtol, atol = tol
        np.testing.assert_allclose(g.astype(w.dtype if w.dtype != BF16 else np.float32),
                                   w.astype(np.float32) if w.dtype == BF16 else w,
                                   rtol=rtol, atol=atol, equal_nan=True, err_msg=what)


def first_float(out):
    if isinstance(out, (list, tuple)):
        for o in out:
            f = first_float(o)
            if f is not None:
                return f
        return None
    d = dtype_name(out)
    return out if d.startswith(("float", "bfloat", "complex")) else None


def run_case(op, build, kwargs=None, tol=(1e-5, 1e-6), grad=False, grad_tol=(1e-4, 1e-5),
             seed=0, jop=None):
    """``op`` (a name, or a pair of callables (jax_fn, torch_fn)) on the
    inputs of ``build(Inputs(seed))`` in both packages; values, dtypes and
    shapes compared, and with ``grad`` the gradients of sum(out * w) for a
    random cotangent w, w.r.t. every float input."""
    kwargs = kwargs or {}
    args = build(Inputs(seed))
    jf, tf = (getattr(jp, op), getattr(tp, op)) if isinstance(op, str) else op
    want = jf(*[to_jax(a) for a in args], **kwargs)
    got = tf(*[to_torch(a) for a in args], **kwargs)
    assert_same(got, want, tol)
    if not grad:
        return
    jargs = [to_jax(a, True) for a in args]
    targs = [to_torch(a, True) for a in args]
    jout = first_float(jf(*jargs, **kwargs))
    tout = first_float(tf(*targs, **kwargs))
    w = np.random.RandomState(seed + 1).standard_normal(tuple(jout.shape)).astype(np.float32)
    jl = jp.sum(jp.multiply(jp.cast(jout, "float32"), jp.to_tensor(w)))
    tl = tp.sum(tp.multiply(tp.cast(tout, "float32"), torch.from_numpy(w)))
    jin = [t for t in leaves(jargs) if not t.stop_gradient]
    tin = [t for t in leaves(targs) if t.requires_grad]
    assert len(jin) == len(tin) and jin
    jg = jp.grad(jl, jin, allow_unused=True)
    tg = tp.grad(tl, tin, allow_unused=True)
    for i, (g, want_g) in enumerate(zip(tg, jg)):
        if want_g is None:
            assert g is None or not np.any(np_of(g)), f"grad[{i}]"
            continue
        assert_same(g, want_g, grad_tol, f"grad[{i}]")


@pytest.fixture
def on_cpu():
    """The port on the CPU for the test, the place and default dtype restored after."""
    place, default = tp.get_place(), tp.get_default_dtype()
    tp.set_device("cpu")
    yield
    tp.set_device(place)
    tp.set_default_dtype(default)


@pytest.fixture
def jax_flags_restored():
    """The JAX package's flags (and which were set) as they were before the
    test: its set_flags would reach every later test in the process."""
    from paddle_tpu.core import flags

    saved, was_set = dict(flags._REGISTRY), set(flags._explicitly_set)
    yield
    flags.set_flags({k: v for k, v in saved.items() if flags._REGISTRY[k] != v})
    flags._explicitly_set.clear()
    flags._explicitly_set.update(was_set)
