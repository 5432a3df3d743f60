"""The port's tensor API against the JAX package: dtypes, places, the RNG,
attribute, creation, math, reduction and activation ops.

Every case draws its inputs from a seeded numpy RandomState, runs them
through ``paddle_tpu.<op>`` and ``paddle_tpu_torch.<op>`` (on the CPU) and
compares dtype (``str`` of it), shape and value; each differentiable case
also compares the gradients of sum(out * w), w a random cotangent, by
``paddle_tpu.grad`` against ``paddle_tpu_torch.grad``. Tolerances (rtol,
atol): f32 values 2e-5 / 2e-6 (XLA's and torch's f32 elementwise
approximations differ by a few ulps), special functions (gamma, Bessel,
erfinv) 1e-4 / 1e-5, f64 1e-10 / 1e-12, bf16 1e-2 / 1e-2 (one bf16 ulp
apart where a scalar rounds in one package and not the other); gradients
1e-4 / 1e-5 at f32. Integer, bool and index results are held equal.

Random ops draw from other streams than JAX's by design: they are held to
dtype, shape, device, range and moments, and to determinism under ``seed``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch.core import random as trandom
from torch_api_util import L, on_cpu, run_case  # noqa: F401

torch.set_num_threads(1)

pytestmark = pytest.mark.usefixtures("on_cpu")

F32 = (2e-5, 2e-6)
F64 = (1e-10, 1e-12)
SPECIAL = (1e-4, 1e-5)
BF16 = (1e-2, 1e-2)

SHAPE = (3, 4)


def one(kind, shape=SHAPE):
    return lambda r: [r.arr(shape, kind)]


def two(k1, k2, s1=SHAPE, s2=SHAPE):
    return lambda r: [r.arr(s1, k1), r.arr(s2, k2)]


# ---- unary math and activations: name -> (float domain, int domain or None,
#      differentiable, tol) ----
UNARY = {
    "exp": ("f32", "i64", True, F32), "expm1": ("f32", "i64", True, F32),
    "log": ("pos", "nat", True, F32), "log2": ("pos", "nat", True, F32),
    "log10": ("pos", "nat", True, F32), "log1p": ("pos", "nat", True, F32),
    "sqrt": ("pos", "nat", True, F32), "rsqrt": ("pos", None, True, F32),
    "square": ("f32", "i64", True, F32), "reciprocal": ("pos", "nat", True, F32),
    "abs": ("f32", "i64", True, F32), "neg": ("f32", "i64", True, F32),
    "sin": ("f32", "i64", True, F32), "cos": ("f32", "i64", True, F32),
    "tan": ("unit", "i64", True, F32), "asin": ("unit", "nat", True, F32),
    "acos": ("unit", "nat", True, F32), "atan": ("f32", "i64", True, F32),
    "sinh": ("f32", "i64", True, F32), "cosh": ("f32", "i64", True, F32),
    "tanh": ("f32", "i64", True, F32), "asinh": ("f32", "i64", True, F32),
    "acosh": ("gt1", "nat", True, F32), "atanh": ("unit", "nat", True, F32),
    "erf": ("f32", "i64", True, F32), "erfinv": ("unit", "nat", True, SPECIAL),
    "floor": ("f32", "i64", True, F32), "ceil": ("f32", "i64", True, F32),
    "round": ("f32", "i64", True, F32), "trunc": ("f32", "i64", True, F32),
    "frac": ("f32", "i64", True, F32), "sign": ("f32", "i64", True, F32),
    "sgn": ("f32", "i64", True, F32), "digamma": ("pos", "nat", True, SPECIAL),
    "lgamma": ("pos", "nat", True, SPECIAL), "sigmoid": ("f32", None, True, F32),
    "logit": ("prob", "nat", True, F32), "i0": ("f32", "i64", True, SPECIAL),
    "i1": ("f32", "i64", True, SPECIAL), "isnan": ("f32", "i64", False, F32),
    "isinf": ("f32", "i64", False, F32), "isfinite": ("f32", "i64", False, F32),
    "conj": ("f32", "i64", True, F32), "real": ("f32", "i64", True, F32),
    "imag": ("f32", "i64", False, F32), "angle": ("f32", "i64", False, F32),
    "deg2rad": ("f32", "i64", True, F32), "rad2deg": ("f32", "i64", True, F32),
    "exponent": ("f32", "i64", False, F32),
    # activations of the top level
    "relu": ("f32", None, True, F32), "relu6": ("f32", None, True, F32),
    "silu": ("f32", None, True, F32), "swish": ("f32", None, True, F32),
    "softsign": ("f32", None, True, F32), "tanhshrink": ("f32", None, True, F32),
    "mish": ("f32", None, True, F32), "hardswish": ("f32", None, True, F32),
    "hardsigmoid": ("f32", None, True, F32), "log_sigmoid": ("f32", None, True, F32),
    "gelu": ("f32", None, True, F32), "leaky_relu": ("f32", None, True, F32),
    "elu": ("f32", None, True, F32), "selu": ("f32", None, True, F32),
    "celu": ("f32", None, True, F32), "hardtanh": ("f32", None, True, F32),
    "hardshrink": ("f32", None, True, F32), "softshrink": ("f32", None, True, F32),
    "thresholded_relu": ("f32", None, True, F32), "softplus": ("f32", None, True, F32),
    "softmax": ("f32", None, True, F32), "log_softmax": ("f32", None, True, F32),
    "glu": ("f32", None, True, F32), "swiglu": ("f32", None, True, F32),
}


def _unary_cases():
    for name, (fdom, idom, diff, tol) in UNARY.items():
        yield pytest.param(name, one(fdom), tol, diff, id=f"{name}-f32")
        yield pytest.param(name, lambda r, d=fdom: [r.arr(SHAPE, d).astype(np.float64)],
                           F64 if tol is F32 else SPECIAL, False, id=f"{name}-f64")
        if idom is not None:
            yield pytest.param(name, one(idom), tol, False, id=f"{name}-i64")
            yield pytest.param(name, lambda r, d=idom: [r.arr(SHAPE, d).astype(np.int32)],
                               tol, False, id=f"{name}-i32")


@pytest.mark.parametrize("name,build,tol,grad", list(_unary_cases()))
def test_unary(name, build, tol, grad):
    run_case(name, build, tol=tol, grad=grad)


@pytest.mark.parametrize("name", ["logical_not", "bitwise_not", "isnan", "abs", "exp"])
def test_unary_of_bool(name):
    run_case(name, one("bool"))


@pytest.mark.parametrize("name,kwargs", [
    ("gelu", {"approximate": True}), ("leaky_relu", {"negative_slope": 0.2}),
    ("elu", {"alpha": 0.5}), ("celu", {"alpha": 2.0}), ("softplus", {"beta": 2.0}),
    ("softmax", {"axis": 0}), ("log_softmax", {"axis": 0}), ("hardtanh", {"min": -0.5}),
    ("maxout", {"groups": 2, "axis": 1}), ("glu", {"axis": 0}),
])
def test_activation_options(name, kwargs):
    shape = {"maxout": (4, 4, 2), "glu": (4, 4)}.get(name, SHAPE)
    run_case(name, one("f32", shape), kwargs, tol=F32, grad=True)


def test_prelu_and_rrelu():
    run_case("prelu", lambda r: [r.arr((2, 3, 4), "f32"), r.arr((3,), "pos")], tol=F32,
             grad=True)
    run_case("rrelu", one("f32"), tol=F32, grad=True)       # eval: the mean slope


@pytest.mark.parametrize("name", ["add", "multiply", "exp", "relu", "gelu", "sum", "mean",
                                  "softmax"])
def test_bf16(name):
    args = two("bf16", "bf16") if name in ("add", "multiply") else one("bf16")
    run_case(name, args, tol=BF16)


# ---- binary: name -> (lhs domain, rhs domain, differentiable, ints?) ----
BINARY = {
    "add": ("f32", "f32", True, True), "subtract": ("f32", "f32", True, True),
    "multiply": ("f32", "f32", True, True), "divide": ("f32", "pos", True, True),
    "floor_divide": ("f32", "pos", False, True), "remainder": ("f32", "pos", True, True),
    "mod": ("f32", "pos", True, True), "floor_mod": ("f32", "pos", True, True),
    "pow": ("pos", "f32", True, True), "maximum": ("f32", "f32", True, True),
    "minimum": ("f32", "f32", True, True), "fmax": ("f32", "f32", True, True),
    "fmin": ("f32", "f32", True, True), "atan2": ("f32", "f32", True, True),
    "hypot": ("f32", "f32", True, True), "copysign": ("f32", "f32", True, True),
    "nextafter": ("f32", "f32", False, True), "logaddexp": ("f32", "f32", True, True),
    "heaviside": ("f32", "f32", False, True), "kron": ("f32", "f32", True, True),
    "inner": ("f32", "f32", True, True), "outer": ("f32", "f32", True, True),
    "equal": ("i64", "i64", False, True), "not_equal": ("i64", "i64", False, True),
    "less_than": ("f32", "f32", False, True), "less_equal": ("i64", "i64", False, True),
    "greater_than": ("f32", "f32", False, True), "greater_equal": ("i64", "i64", False, True),
    "logical_and": ("bool", "bool", False, False), "logical_or": ("bool", "bool", False, False),
    "logical_xor": ("bool", "bool", False, False),
    "bitwise_and": ("nat", "nat", False, False), "bitwise_or": ("nat", "nat", False, False),
    "bitwise_xor": ("bool", "bool", False, False),
    "bitwise_left_shift": ("nat", "nat", False, False),
    "bitwise_right_shift": ("nat", "nat", False, False),
    "gcd": ("nat", "nat", False, False), "lcm": ("nat", "nat", False, False),
}


def _binary_cases():
    for name, (a, b, diff, ints) in BINARY.items():
        shape2 = (4,) if name == "inner" else SHAPE
        s2 = (4, 3) if name == "kron" else shape2
        yield pytest.param(name, lambda r, a=a, b=b, s2=s2: [r.arr(SHAPE, a), r.arr(s2, b)],
                           diff, id=f"{name}-tensors")
        if a in ("f32", "pos"):
            yield pytest.param(name, lambda r, a=a: [r.arr(SHAPE, a), 1.5], False,
                               id=f"{name}-float-scalar")
            yield pytest.param(name, lambda r, a=a, s2=s2: [
                r.arr(SHAPE, a).astype(np.float64), r.arr(s2, b).astype(np.float32)],
                False, id=f"{name}-f64-f32")
        if ints:
            nb = "nat" if b == "pos" or name == "pow" else "i64"
            yield pytest.param(name, lambda r, s2=s2, nb=nb: [r.arr(SHAPE, "nat"),
                                                              r.arr(s2, nb)], False,
                               id=f"{name}-ints")
            if name not in ("kron", "inner", "outer"):
                yield pytest.param(name, lambda r: [r.arr(SHAPE, "nat"), 2.5], False,
                                   id=f"{name}-int-float-scalar")
                yield pytest.param(name, lambda r: [r.arr(SHAPE, "nat").astype(np.int32), 2],
                                   False, id=f"{name}-i32-int-scalar")
                if name != "pow":   # jnp.power(bool, 3) takes lax.integer_pow's int32
                    yield pytest.param(name, lambda r: [r.arr(SHAPE, "bool"), 3], False,
                                       id=f"{name}-bool-int-scalar")
                yield pytest.param(name, lambda r, s2=s2: [
                    r.arr(SHAPE, "nat").astype(np.int32), r.arr(s2, "pos")], False,
                    id=f"{name}-i32-f32")


@pytest.mark.parametrize("name,build,grad", list(_binary_cases()))
def test_binary(name, build, grad):
    run_case(name, build, tol=F32, grad=grad)


@pytest.mark.parametrize("name", ["add", "multiply", "maximum", "equal", "divide"])
def test_binary_promotes_a_0d_tensor_by_dtype(name):
    """An f64 0-d tensor beside an f32 tensor: JAX promotes by dtype alone."""
    run_case(name, lambda r: [r.arr(SHAPE, "f32"), np.array(1.5)], tol=F32)


def test_binary_scalar_first_and_complex_scalar():
    run_case("subtract", lambda r: [2.0, r.arr(SHAPE, "f32")], tol=F32, grad=True)
    run_case("add", lambda r: [r.arr(SHAPE, "f32"), 1j], tol=F32)
    run_case("add", lambda r: [r.arr(SHAPE, "i64"), 1j], tol=F32)
    run_case("ldexp", lambda r: [r.arr(SHAPE, "f32"), r.arr(SHAPE, "nat")], tol=F32,
             grad=True)
    run_case("ldexp", lambda r: [r.arr(SHAPE, "i64"), 2], tol=F32)


# ---- the cases the port would get wrong as a thin wrapper over torch ----

def test_int_tensor_times_float_is_float64():
    a = tp.multiply(tp.to_tensor([1, 2, 3]), 2.5)
    b = jp.multiply(jp.to_tensor([1, 2, 3]), 2.5)
    assert str(a.dtype) == "torch.float64" and str(b.dtype) == "float64"
    np.testing.assert_array_equal(a.numpy(), np.asarray(b.numpy()))


def test_divide_of_int64_tensors_is_float64():
    run_case("divide", lambda r: [r.arr(SHAPE, "i64"), r.arr(SHAPE, "nat")], tol=F64)
    assert tp.divide(tp.to_tensor([1, 2]), tp.to_tensor([2, 4])).dtype == torch.float64


def test_mean_of_int64_is_float64():
    run_case("mean", one("i64"), tol=F64)
    assert tp.mean(tp.to_tensor([1, 2])).dtype == torch.float64


def test_median_averages_the_middle_pair():
    x = [1.0, 2.0, 3.0, 4.0]
    assert tp.median(tp.to_tensor(x)).item() == 2.5 == float(jp.median(jp.to_tensor(x)))


def test_to_tensor_of_a_float64_array_is_float32():
    run_case("to_tensor", lambda r: [np.ones(2)])
    assert tp.to_tensor(np.ones(2)).dtype == torch.float32


def test_shape_is_int32_and_arange_int64():
    run_case("shape", one("f32", (2, 3, 4)))
    run_case("arange", lambda r: [5])
    assert tp.shape(tp.ones([2, 3])).dtype == torch.int32
    assert tp.arange(5).dtype == torch.int64


# ---- math with options ----
MATH_CASES = [
    ("scale", one("f32"), {"scale": 2.0, "bias": 1.0}, True),
    ("scale", one("f32"), {"scale": 2.0, "bias": 1.0, "bias_after_scale": False}, True),
    ("scale", one("i64"), {"scale": 3}, False),
    ("scale", one("f32"), {"scale": 2.0, "act": "relu"}, True),
    ("clip", one("f32"), {"min": -0.5, "max": 0.5}, True),
    ("clip", one("i64"), {"min": 0.5, "max": 2.5}, False),
    ("clip", one("i64"), {"min": 0, "max": 2}, False),
    ("clip", one("f32"), {"min": -0.5}, True),
    ("lerp", lambda r: [r.arr(SHAPE), r.arr(SHAPE), 0.3], {}, True),
    ("lerp", lambda r: [r.arr(SHAPE), r.arr(SHAPE), r.arr(SHAPE, "prob")], {}, True),
    ("nan_to_num", lambda r: [np.array([np.nan, np.inf, -np.inf, 1.0], np.float32)],
     {"nan": 2.0}, True),
    ("nan_to_num", lambda r: [np.array([np.nan, np.inf, -np.inf, 1.0], np.float32)],
     {"posinf": 9.0, "neginf": -9.0}, False),
    ("stanh", one("f32"), {}, True),
    ("multiplex", lambda r: [L([r.arr(SHAPE), r.arr(SHAPE)]),
                             np.array([[0], [1], [1]], np.int64)], {}, False),
    ("allclose", lambda r: [r.arr(SHAPE), r.arr(SHAPE)], {}, False),
    ("isclose", lambda r: [np.arange(4, dtype=np.float32),
                           np.arange(4, dtype=np.float32) + 1e-7], {}, False),
    ("equal_all", lambda r: [np.arange(4), np.arange(4)], {}, False),
    ("equal_all", lambda r: [np.arange(4), np.arange(4) + 1], {}, False),
    ("addmm", lambda r: [r.arr((3, 5)), r.arr((3, 4)), r.arr((4, 5))],
     {"beta": 0.5, "alpha": 2.0}, True),
    ("trace", one("f32", (4, 5)), {"offset": 1}, True),
    ("trace", one("i64", (3, 4, 4)), {"axis1": 1, "axis2": 2}, False),
    ("trace", lambda r: [r.arr((4, 4), "nat").astype(np.int32)], {}, False),
    ("diagonal", one("f32", (3, 4, 5)), {"offset": -1, "axis1": 1, "axis2": 2}, True),
    ("cumsum", one("f32", (3, 4)), {"axis": 1}, True),
    ("cumsum", one("f32", (3, 4)), {}, True),
    ("cumsum", lambda r: [r.arr((3, 4), "i64").astype(np.int32)], {"axis": 0}, False),
    ("cumsum", one("bool", (3, 4)), {"axis": 1}, False),
    ("cumsum", one("i64", (3, 4)), {"axis": 0, "dtype": "float64"}, False),
    ("cumprod", one("pos", (3, 4)), {"dim": 1}, True),
    ("cumprod", lambda r: [r.arr((3, 4), "nat").astype(np.int32)], {"dim": 0}, False),
    ("cummax", lambda r: [np.array([[1, 3, 3, 2], [5, 1, 5, 5]], np.float32)], {"axis": 1},
     False),
    ("cummin", lambda r: [np.array([[4, 1, 1, 2], [5, 1, 5, 0]], np.int64)], {"axis": 1},
     False),
    ("cummax", one("f32", (3, 4)), {}, False),    # the reference records no graph
    ("logcumsumexp", one("f32", (3, 4)), {"axis": 1}, True),
    ("logcumsumexp", one("f32", (3, 4)), {}, True),
    ("add_n", lambda r: [L([r.arr(SHAPE), r.arr(SHAPE), r.arr(SHAPE)])], {}, True),
    ("add_n", lambda r: [r.arr(SHAPE)], {}, True),
    ("renorm", one("f32", (3, 4, 2)), {"p": 2, "axis": 1, "max_norm": 1.0}, True),
    ("complex", lambda r: [r.arr(SHAPE), r.arr(SHAPE)], {}, False),
]


@pytest.mark.parametrize("name,build,kwargs,grad", MATH_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(MATH_CASES)])
def test_math_option(name, build, kwargs, grad):
    run_case(name, build, kwargs, tol=F32, grad=grad)


def test_increment_and_rsqrt_write_in_place():
    for pkg in (jp, tp):
        x = pkg.to_tensor([1.0, 4.0])
        y = pkg.increment(x, 2.0)
        assert y is x and np.allclose(np.asarray(x.numpy()), [3.0, 6.0])
    x = tp.to_tensor([4.0, 16.0])
    assert tp.rsqrt_(x) is x and np.allclose(x.numpy(), [0.5, 0.25])


# ---- reductions: (name, build, kwargs, grad) ----
R3 = (3, 4, 5)
RED_CASES = []
for _name in ("sum", "mean", "max", "min", "amax", "amin", "prod", "std", "var", "logsumexp",
              "nansum", "nanmean"):
    _grad = _name not in ("nansum", "nanmean")
    for _kw in ({}, {"axis": 1}, {"axis": [0, 2], "keepdim": True}, {"axis": -1}):
        RED_CASES.append((_name, one("pos" if _name == "prod" else "f32", R3), _kw, _grad))
    if _name not in ("logsumexp",):
        RED_CASES.append((_name, one("nat", R3), {"axis": 1}, False))
        RED_CASES.append((_name, lambda r: [r.arr(R3, "nat").astype(np.int32)], {}, False))
RED_CASES += [
    ("sum", one("bool", R3), {"axis": 0}, False),
    ("sum", one("f32", R3), {"dtype": "float64"}, False),
    ("prod", one("bool", R3), {}, False),
    ("std", one("f32", R3), {"unbiased": False, "axis": 2}, True),
    ("var", one("f32", R3), {"unbiased": False}, True),
    ("all", one("bool", R3), {"axis": 1}, False), ("any", one("bool", R3), {}, False),
    ("all", one("f32", R3), {"axis": [0, 1], "keepdim": True}, False),
    ("argmax", one("f32", R3), {}, False), ("argmin", one("f32", R3), {"axis": 1}, False),
    ("argmax", lambda r: [np.array([[1, 3, 3], [2, 2, 1]], np.int64)], {"axis": 1,
                                                                        "keepdim": True},
     False),
    ("argmin", one("f32", R3), {"axis": 0, "dtype": "int32"}, False),
    ("median", one("f32", R3), {}, True), ("median", one("f32", R3), {"axis": 1}, True),
    ("median", one("f32", (3, 5)), {"axis": 1, "keepdim": True}, True),
    ("median", one("nat", (3, 4)), {"axis": 0}, False),
    ("median", one("f32", (3, 5)), {"axis": 1, "mode": "min"}, True),
    ("median", one("f32", (4, 4)), {"mode": "min"}, True),
    ("nanmedian", lambda r: [np.array([[1, np.nan, 3, 4], [np.nan] * 4, [2, 1, 5, np.nan]],
                                      np.float32)], {"axis": 1}, False),
    ("nanmedian", one("f32", R3), {}, False),
    ("nansum", lambda r: [np.array([[1, np.nan], [2, 3]], np.float32)], {"axis": 0}, False),
    ("count_nonzero", one("i64", R3), {"axis": 1}, False),
    ("count_nonzero", one("f32", R3), {}, False),
    ("count_nonzero", one("bool", R3), {"axis": [0, 2], "keepdim": True}, False),
    ("quantile", one("f32", R3), {"q": 0.3}, True),
    ("quantile", one("f32", R3), {"q": [0.2, 0.5], "axis": 1}, True),
    ("quantile", one("f32", R3), {"q": 0.7, "axis": [0, 2], "keepdim": True}, True),
    ("quantile", one("f32", R3), {"q": 0.5, "axis": 2, "interpolation": "lower"}, False),
    ("nanquantile", lambda r: [np.array([[1, np.nan, 3, 4], [2, 1, 5, np.nan]], np.float32)],
     {"q": 0.5, "axis": 1}, False),
    ("kthvalue", one("f32", R3), {"k": 2}, True),
    ("kthvalue", lambda r: [np.array([[3, 1, 1, 2], [2, 2, 2, 0]], np.float32)],
     {"k": 2, "axis": 1, "keepdim": True}, True),
    ("mode", lambda r: [np.array([[3, 1, 1, 2, 2], [0, 0, 4, 4, 1]], np.float32)], {}, True),
    ("mode", lambda r: [np.array([[3, 1, 1], [1, 2, 2], [3, 2, 2]], np.int64)],
     {"axis": 0, "keepdim": True}, False),
]


@pytest.mark.parametrize("name,build,kwargs,grad", RED_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(RED_CASES)])
def test_reduction(name, build, kwargs, grad):
    run_case(name, build, kwargs, tol=(1e-5, 2e-6), grad=grad)


def test_reduction_bf16_and_f64():
    run_case("sum", one("bf16", R3), {"axis": 1}, tol=BF16)
    run_case("var", lambda r: [r.arr(R3, "f64")], {"axis": 2}, tol=F64)


# ---- creation ----
CREATION_CASES = [
    ("to_tensor", lambda r: [[1, 2, 3]], {}), ("to_tensor", lambda r: [[1.5, 2.0]], {}),
    ("to_tensor", lambda r: [[True, False]], {}), ("to_tensor", lambda r: [3], {}),
    ("to_tensor", lambda r: [2.5], {}), ("to_tensor", lambda r: [[1, 2]], {"dtype": "float64"}),
    ("to_tensor", lambda r: [np.arange(3, dtype=np.int32)], {}),
    ("to_tensor", lambda r: [[1.0, 2.0]], {"dtype": "bfloat16"}),
    ("to_tensor", lambda r: [[1 + 2j]], {}),
    ("zeros", lambda r: [[2, 3]], {}), ("zeros", lambda r: [(2, 3)], {"dtype": "int32"}),
    ("ones", lambda r: [[2, 3]], {"dtype": "float64"}), ("ones", lambda r: [4], {}),
    ("full", lambda r: [[2, 2], 3], {}), ("full", lambda r: [[2, 2], 1.5], {}),
    ("full", lambda r: [[2, 2], True], {}), ("full", lambda r: [[2], 3], {"dtype": "float32"}),
    ("empty", lambda r: [[2, 3]], {}),
    ("zeros_like", one("i64"), {}), ("ones_like", one("f32"), {"dtype": "int32"}),
    ("full_like", one("f32"), {"fill_value": 2}), ("full_like", one("i64"), {"fill_value": 7}),
    ("empty_like", one("f32"), {}),
    ("arange", lambda r: [2, 10, 3], {}), ("arange", lambda r: [0.5, 3.0, 0.5], {}),
    ("arange", lambda r: [5], {"dtype": "float32"}), ("arange", lambda r: [1, 4.0], {}),
    ("linspace", lambda r: [0.0, 1.0, 5], {}), ("linspace", lambda r: [-2, 3, 7],
                                                {"dtype": "float64"}),
    ("logspace", lambda r: [0.0, 2.0, 5], {}), ("logspace", lambda r: [0, 3, 4],
                                                {"base": 2.0}),
    ("eye", lambda r: [3], {}), ("eye", lambda r: [2, 4], {"dtype": "int64"}),
    ("tril", one("f32", (4, 5)), {}), ("tril", one("i64", (2, 4, 4)), {"diagonal": -1}),
    ("triu", one("f32", (4, 5)), {"diagonal": 1}),
    ("diag", one("f32", (4,)), {}), ("diag", one("f32", (4,)), {"offset": 1,
                                                                "padding_value": 2.0}),
    ("diag", one("f32", (3, 4)), {"offset": -1}), ("diag", one("i64", (3,)), {"offset": -2}),
    ("diagflat", one("f32", (2, 2)), {"offset": 1}),
    ("diag_embed", one("f32", (2, 3)), {}),
    ("diag_embed", one("f32", (2, 3)), {"offset": 1, "dim1": 0, "dim2": 2}),
    ("fill_diagonal_tensor", lambda r: [r.arr((3, 4)), r.arr((3,))], {}),
    ("fill_diagonal_tensor", lambda r: [r.arr((2, 4, 3)), r.arr((2, 2))],
     {"offset": 1, "dim1": 1, "dim2": 2}),
    ("meshgrid", lambda r: [r.arr((3,)), r.arr((4,))], {}),
    ("meshgrid", lambda r: [L([r.arr((2,)), r.arr((3,), "i64")])], {}),
    ("assign", one("f32"), {}), ("assign", lambda r: [np.arange(3)], {}),
    ("clone", one("f32"), {}), ("numel", one("f32", (2, 3, 4)), {}),
    ("tril_indices", lambda r: [4, 3], {}), ("tril_indices", lambda r: [4, 5, 1], {}),
    ("triu_indices", lambda r: [3], {}), ("triu_indices", lambda r: [4, 3, -1], {}),
    ("clone_detached", one("f32"), {}),
]
_CREATION_GRAD = {"tril", "triu", "diag", "diagflat", "diag_embed", "fill_diagonal_tensor",
                  "assign", "clone"}


@pytest.mark.parametrize("name,build,kwargs", CREATION_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CREATION_CASES)])
def test_creation(name, build, kwargs):
    args = build(__import__("torch_api_util").Inputs(0))
    grad = name in _CREATION_GRAD and isinstance(args[0], np.ndarray) and \
        args[0].dtype.kind == "f"
    run_case(name, build, kwargs, tol=F32, grad=grad)


def test_creation_takes_place_and_the_current_device(monkeypatch):
    assert tp.zeros([2]).device.type == "cpu"
    assert tp.ones([2], place=tp.CPUPlace()).device.type == "cpu"
    assert tp.arange(3, place="cpu").device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: tp.zeros([2], place="gpu"), lambda: tp.rand([2], place=tp.CUDAPlace(0)),
                 lambda: tp.to_tensor([1.0], place="cuda")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


def test_creation_without_set_device_raises_without_a_card(monkeypatch):
    """Nothing falls back: the current place starts as the card, and without
    one a creation op that is not asked for the CPU raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tp.set_device(tp.CUDAPlace(0))
    for make in (lambda: tp.zeros([2]), lambda: tp.to_tensor([1, 2]), lambda: tp.arange(3),
                 lambda: tp.randn([2]), lambda: tp.eye(2), lambda: tp.full([1], 1.0),
                 lambda: tp.add([1.0], 2.0)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    with pytest.raises(RuntimeError):
        tp.resolve_device()
    tp.set_device("cpu")
    assert tp.zeros([2]).device.type == "cpu"


def test_a_fresh_process_starts_on_the_card():
    import subprocess
    import sys

    code = ("import torch, paddle_tpu_torch as P\n"
            "torch.cuda.is_available = lambda: False\n"
            "assert P.get_device() == 'gpu:0', P.get_device()\n"
            "try:\n    P.zeros([1])\nexcept RuntimeError:\n    print('RAISED')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=str(__import__("pathlib").Path(__file__).parents[1]))
    assert "RAISED" in res.stdout, res.stdout + res.stderr


# ---- dtypes ----

@pytest.mark.parametrize("alias", ["float16", "fp16", "half", "bfloat16", "bf16", "float32",
                                   "fp32", "float", "float64", "fp64", "double", "int8",
                                   "int16", "int32", "int64", "int", "uint8", "bool",
                                   "complex64", "complex128"])
def test_convert_dtype_aliases(alias):
    from paddle_tpu.core import dtype as jd
    from paddle_tpu_torch.core import dtype as td

    assert str(td.convert_dtype(alias)).replace("torch.", "") == str(jd.convert_dtype(alias))


def test_dtype_names_defaults_and_info():
    from paddle_tpu.core import dtype as jd
    from paddle_tpu_torch.core import dtype as td

    for n in ("bfloat16", "float16", "float32", "float64", "int8", "int16", "int32", "int64",
              "uint8", "complex64", "complex128"):
        assert str(getattr(tp, n)).replace("torch.", "") == str(getattr(jp, n)), n
    assert tp.bool is torch.bool and tp.bool_ is torch.bool
    for py, name in ((float, "float32"), (int, "int64"), (bool, "bool")):
        assert str(td.convert_dtype(py)) == "torch." + name == "torch." + str(jd.convert_dtype(py))
    assert td.convert_dtype(np.float16) == torch.float16
    assert td.convert_dtype(torch.int8) is torch.int8
    with pytest.raises(TypeError):
        tp.convert_dtype("float7")
    tp.set_default_dtype("float64")
    assert tp.get_default_dtype() == torch.float64
    assert tp.zeros([2]).dtype == torch.float64 and tp.to_tensor([1.5]).dtype == torch.float64
    assert tp.arange(0.0, 1.0, 0.5).dtype == torch.float64
    with pytest.raises(TypeError):
        tp.set_default_dtype("int32")
    tp.set_default_dtype("float32")
    for d in ("float16", "bfloat16", "float32", "float64"):
        a, b = tp.finfo(d), jp.finfo(d)
        assert (a.bits, a.eps, a.max, a.min, a.tiny) == (
            b.bits, float(b.eps), float(b.max), float(b.min), float(b.tiny)), d
    for d in ("int8", "int16", "int32", "int64", "uint8"):
        a, b = tp.iinfo(d), jp.iinfo(d)
        assert (a.bits, a.max, a.min) == (b.bits, int(b.max), int(b.min)), d
    assert td.is_floating("bf16") and td.is_integer("int32") and td.is_complex("complex64")
    assert td.is_bool("bool") and not td.is_integer("bool")


# ---- places ----

def test_places_and_set_device():
    assert tp.CPUPlace() == tp.CPUPlace(0) and tp.CUDAPlace(1) != tp.CUDAPlace(0)
    assert repr(tp.CUDAPlace(1)) == "Place(gpu:1)" and repr(tp.CPUPlace()) == repr(jp.CPUPlace())
    assert tp.CUDAPinnedPlace() == tp.CPUPlace() and tp.TPUPlace() == tp.CUDAPlace()
    assert repr(tp.CustomPlace("npu", 2)) == "Place(gpu/npu:2)"
    assert len({tp.CPUPlace(), tp.CPUPlace(0), tp.CUDAPlace()}) == 2
    assert tp.set_device("cpu") == tp.CPUPlace() and tp.get_device() == "cpu:0"
    assert tp.resolve_device(None) == torch.device("cpu")
    assert tp.set_device("gpu:1") == tp.CUDAPlace(1) and tp.get_device() == "gpu:1"
    assert tp.get_place().torch_device() == torch.device("cuda", 1)
    for name in ("cuda", "tpu", "gpu", "xpu:0"):
        assert tp.set_device(name) == tp.CUDAPlace(0)
    assert tp.CUDAPlace(0).torch_device() == torch.device("cuda")
    tp.set_device(torch.device("cpu"))
    assert tp.get_place() == tp.CPUPlace()
    with pytest.raises(ValueError):
        tp.set_device("abacus")
    for fn in ("is_compiled_with_cuda", "is_compiled_with_rocm", "is_compiled_with_npu",
               "is_compiled_with_xpu", "is_compiled_with_mlu", "is_compiled_with_ipu",
               "is_compiled_with_cinn", "is_compiled_with_distribute", "is_compiled_with_tpu"):
        assert isinstance(getattr(tp, fn)(), bool)
    assert tp.device_count() == torch.cuda.device_count()


def test_set_device_moves_the_entry_points():
    """resolve_device(None), which the models and engines use, follows set_device."""
    from paddle_tpu_torch.models import GPTForPretraining, gpt_tiny

    model = GPTForPretraining(gpt_tiny())
    assert model.device == torch.device("cpu")


# ---- the RNG ----

def test_seed_makes_draws_repeat_on_each_device_generator():
    tp.seed(123)
    a = [tp.rand([4]), tp.randn([3]), tp.randint(0, 9, [5]), tp.randperm(6),
         tp.uniform([3], min=2.0, max=3.0), tp.normal(1.0, 2.0, [3])]
    tp.seed(123)
    b = [tp.rand([4]), tp.randn([3]), tp.randint(0, 9, [5]), tp.randperm(6),
         tp.uniform([3], min=2.0, max=3.0), tp.normal(1.0, 2.0, [3])]
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    tp.seed(124)
    assert not torch.equal(tp.rand([4]), a[0])
    assert isinstance(tp.seed(5), torch.Generator)
    assert trandom.generator("cpu") is trandom.generator(torch.device("cpu"))


def test_rng_state_round_trips_every_generator():
    tp.seed(7)
    g = trandom.named_generator("local_seed")
    tp.rand([3])
    torch.rand(2, generator=g)
    state = tp.get_rng_state()
    want = (tp.rand([5]), torch.rand(4, generator=g))
    tp.rand([9])
    torch.rand(4, generator=g)
    tp.set_rng_state(state)
    got = (tp.rand([5]), torch.rand(4, generator=g))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert tp.get_cuda_rng_state is tp.get_rng_state
    assert tp.set_cuda_rng_state is tp.set_rng_state


def test_named_generators_reseed_apart_and_stably():
    tp.seed(11)
    a = torch.rand(4, generator=trandom.named_generator("global_seed"))
    b = torch.rand(4, generator=trandom.named_generator("local_seed"))
    assert not torch.equal(a, b)
    tp.seed(11)
    assert torch.equal(torch.rand(4, generator=trandom.named_generator("global_seed")), a)
    assert trandom._name_offset("local_seed") == __import__(
        "paddle_tpu.core.random", fromlist=["x"])._name_offset("local_seed")


RANDOM_CASES = [
    ("rand", lambda: ([2000], {}), "float32", (0.0, 1.0), 0.5, 1 / 12),
    ("rand", lambda: ([2000], {"dtype": "float64"}), "float64", (0.0, 1.0), 0.5, 1 / 12),
    ("randn", lambda: ([2000], {}), "float32", None, 0.0, 1.0),
    ("standard_normal", lambda: ([2000], {}), "float32", None, 0.0, 1.0),
    ("normal", lambda: ([2.0, 0.5, [2000]], {}), "float32", None, 2.0, 0.25),
    ("uniform", lambda: ([[2000]], {"min": -2.0, "max": 2.0}), "float32", (-2.0, 2.0), 0.0,
     16 / 12),
    ("randint", lambda: ([0, 10, [2000]], {}), "int64", (0, 9), 4.5, 99 / 12),
    ("randint", lambda: ([5, None, [2000]], {"dtype": "int32"}), "int32", (0, 4), 2.0, 2.0),
    ("randperm", lambda: ([50], {}), "int64", (0, 49), 24.5, None),
]


@pytest.mark.parametrize("name,args,dtype,rng,mean,var", RANDOM_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(RANDOM_CASES)])
def test_random_creation_shapes_dtypes_and_moments(name, args, dtype, rng, mean, var):
    """dtype and shape as the JAX op's; range and the first two moments
    within 5 standard errors of the distribution's."""
    a, kw = args()
    tp.seed(3)
    got = getattr(tp, name)(*a, **kw)
    want = getattr(jp, name)(*a, **kw)
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    assert list(got.shape) == list(want.shape) and got.device.type == "cpu"
    x = got.double()
    if rng is not None:
        assert x.min() >= rng[0] and x.max() <= rng[1]
    n = x.numel()
    if var is not None:
        assert abs(x.mean().item() - mean) < 5 * (var / n) ** 0.5
        assert abs(x.var().item() - var) < 5 * var * (2 / n) ** 0.5 * 1.5
    else:
        assert sorted(x.tolist()) == list(range(n))


def test_random_ops_of_a_tensor():
    tp.seed(0)
    p = tp.full([4000], 0.3)
    b = tp.bernoulli(p)
    assert str(b.dtype) == "torch." + str(jp.bernoulli(jp.full([4], 0.3)).dtype)
    assert b.dtype == torch.float32 and set(b.unique().tolist()) <= {0.0, 1.0}
    assert abs(b.mean().item() - 0.3) < 5 * (0.21 / 4000) ** 0.5
    lam = tp.full([4000], 3.0)
    s = tp.poisson(lam)
    assert s.dtype == torch.float32 and abs(s.mean().item() - 3.0) < 5 * (3 / 4000) ** 0.5
    w = tp.to_tensor([[0.1, 0.0, 0.9], [0.5, 0.5, 0.0]])
    m = tp.multinomial(w, 2000, replacement=True)
    jm = jp.multinomial(jp.to_tensor([[0.1, 0.0, 0.9], [0.5, 0.5, 0.0]]), 5, replacement=True)
    assert str(m.dtype) == "torch." + str(jm.dtype) and m.shape == (2, 2000)
    assert (m[0] != 1).all() and (m[1] != 2).all()
    assert abs((m[0] == 2).double().mean().item() - 0.9) < 5 * (0.09 / 2000) ** 0.5
    assert sorted(tp.multinomial(tp.ones([5]), 5).tolist()) == [0, 1, 2, 3, 4]
    r = tp.randint_like(tp.zeros([100], dtype="int32"), 0, 3)
    assert r.dtype == torch.int32 and r.min() >= 0 and r.max() <= 2
    g = tp.gumbel_softmax(tp.to_tensor([[1.0, 2.0, 3.0]] * 400), temperature=0.5)
    assert torch.allclose(g.sum(-1), torch.ones(400)) and g.dtype == torch.float32
    h = tp.gumbel_softmax(tp.zeros([8, 5]), hard=True)
    assert torch.equal(h.sum(-1), torch.ones(8)) and set(h.unique().tolist()) <= {0.0, 1.0}
    tp.seed(9)
    u1 = tp.uniform([4], seed=17)
    u2 = tp.uniform([4], seed=17)
    assert torch.equal(u1, u2)


# ---- attribute ----

ATTR_CASES = [("rank", one("f32", (2, 3, 4))), ("shape", one("i64", (5,))),
              ("is_empty", lambda r: [np.zeros((0, 3), np.float32)]),
              ("is_empty", one("f32")), ("is_complex", one("c64")), ("is_complex", one("f32")),
              ("is_integer", one("i64")), ("is_integer", one("f32")),
              ("is_floating_point", one("f32")), ("is_floating_point", one("i64")),
              ("is_tensor", one("f32")), ("is_tensor", lambda r: [[1, 2]])]


@pytest.mark.parametrize("name,build", ATTR_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(ATTR_CASES)])
def test_attribute(name, build):
    run_case(name, build)


def test_check_shape():
    tp.check_shape([2, 3])
    tp.check_shape(tp.to_tensor([2, 3]))
    with pytest.raises(ValueError):
        tp.check_shape([2, -1])
    with pytest.raises(TypeError):
        tp.check_shape([2.5])
