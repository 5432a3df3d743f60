"""The port's shape, layout and indexing ops against the JAX package's
(``paddle_tpu/ops/manipulation.py``), on the same seeded numpy inputs:
dtype, shape and value, and the gradients of the differentiable cases.

Tolerances: f32 values 2e-5 / 2e-6 (rtol / atol; these ops move values,
so only the promoting ones and ``tensordot`` compute), gradients 1e-4 /
1e-5. Indices are held equal, ties included: ``sort`` / ``argsort`` /
``topk`` order, ``unique``'s index, inverse and counts. Scatters with
duplicate indices are held only where the result is defined
(``overwrite=False`` sums, ``scatter_nd_add`` and ``put_along_axis(reduce=
"add")``): with ``overwrite=True`` the order of duplicate writes is
undefined in both packages.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from torch_api_util import L, on_cpu, run_case  # noqa: F401

torch.set_num_threads(1)

pytestmark = pytest.mark.usefixtures("on_cpu")

F32 = (2e-5, 2e-6)


def one(kind="f32", shape=(3, 4)):
    return lambda r: [r.arr(shape, kind)]


I64 = np.int64
TIES = np.array([[1.0, 2.0, 2.0, 3.0, 2.0], [5.0, 5.0, 1.0, 1.0, 0.0]], np.float32)

CASES = [
    # (name, build, kwargs, grad)
    ("cast", one(), {"dtype": "int32"}, False), ("cast", one(), {"dtype": "float64"}, True),
    ("cast", one("i64"), {"dtype": "float32"}, False),
    ("cast", one(), {"dtype": "bfloat16"}, False), ("cast", one("bool"), {"dtype": "float32"},
                                                    False),
    ("astype", one(), {"dtype": "float16"}, False),
    ("reshape", one(), {"shape": [2, 6]}, True), ("reshape", one("i64"), {"shape": [-1, 3]},
                                                  False),
    ("flatten", one("f32", (2, 3, 4)), {}, True),
    ("flatten", one("f32", (2, 3, 4, 2)), {"start_axis": 1, "stop_axis": -2}, True),
    ("flatten", lambda r: [np.full((), 2.0, np.float32)], {}, False),
    ("transpose", one("f32", (2, 3, 4)), {"perm": [2, 0, 1]}, True),
    ("t", one("f32", (3,)), {}, False), ("t", one(), {}, True),
    ("t", one("f32", (2, 3, 4)), {}, True),
    ("moveaxis", one("f32", (2, 3, 4)), {"source": 0, "destination": -1}, True),
    ("swapaxes", one("f32", (2, 3, 4)), {"axis0": 0, "axis1": 2}, True),
    ("concat", lambda r: [L([r.arr((2, 3)), r.arr((1, 3))])], {}, True),
    ("concat", lambda r: [L([r.arr((2, 3)), r.arr((2, 2), "i64")])], {"axis": 1}, True),
    ("stack", lambda r: [L([r.arr((2, 3)), r.arr((2, 3))])], {"axis": 1}, True),
    ("stack", lambda r: [L([r.arr((2,), "i64"), r.arr((2,), "i64")])], {"axis": -1}, False),
    ("vstack", lambda r: [L([r.arr((3,)), r.arr((3,))])], {}, True),
    ("hstack", lambda r: [L([r.arr((2, 3)), r.arr((2, 1))])], {}, True),
    ("dstack", lambda r: [L([r.arr((2, 3)), r.arr((2, 3))])], {}, True),
    ("split", one("f32", (3, 6)), {"num_or_sections": 3, "axis": 1}, True),
    ("split", one("f32", (6, 2)), {"num_or_sections": [2, -1, 1]}, True),
    ("split", one("i64", (2, 7)), {"num_or_sections": [3, 4], "axis": -1}, False),
    ("chunk", one("f32", (4, 2)), {"chunks": 2}, True),
    ("unbind", one("f32", (2, 3)), {"axis": 1}, True),
    ("unstack", one("f32", (3, 2)), {}, True),
    ("squeeze", one("f32", (3, 1, 4, 1)), {}, True),
    ("squeeze", one("f32", (3, 1, 4, 1)), {"axis": 1}, True),
    ("squeeze", one("f32", (3, 1, 4, 1)), {"axis": [0, -1]}, True),
    ("unsqueeze", one(), {"axis": 1}, True), ("unsqueeze", one(), {"axis": [0, 2]}, True),
    ("unsqueeze", one(), {"axis": -1}, True), ("unsqueeze", one(), {"axis": [-1, 0]}, True),
    ("expand", one("f32", (3, 1)), {"shape": [3, 4]}, True),
    ("expand", one("f32", (3, 1)), {"shape": [2, -1, 4]}, True),
    ("broadcast_to", one("i64", (1, 4)), {"shape": [3, 4]}, False),
    ("expand_as", lambda r: [r.arr((1, 4)), r.arr((3, 4))], {}, False),
    ("broadcast_tensors", lambda r: [L([r.arr((3, 1)), r.arr((1, 4), "i64")])], {}, False),
    ("tile", one(), {"repeat_times": [2, 1]}, True),
    ("tile", one(), {"repeat_times": [2]}, True),
    ("tile", one("f32", (3,)), {"repeat_times": [2, 2]}, True),
    ("repeat_interleave", one(), {"repeats": 2, "axis": 1}, True),
    ("repeat_interleave", one(), {"repeats": 3}, True),
    ("repeat_interleave", lambda r: [r.arr((3, 2)), np.array([1, 0, 2])], {"axis": 0}, True),
    ("flip", one("f32", (2, 3, 4)), {"axis": [0, 2]}, True), ("flip", one(), {"axis": 1}, True),
    ("reverse", one(), {"axis": 0}, True),
    ("rot90", one("f32", (2, 3, 4)), {}, True),
    ("rot90", one("f32", (2, 3, 4)), {"k": -1, "axes": (1, 2)}, True),
    ("rot90", one(), {"k": 2}, True),
    ("roll", one(), {"shifts": 2}, True),
    ("roll", one(), {"shifts": (1, -2), "axis": (0, 1)}, True),
    ("where", lambda r: [r.arr((3, 4), "bool"), r.arr((3, 4)), r.arr((3, 4))], {}, True),
    ("where", lambda r: [r.arr((3, 4), "bool"), r.arr((3, 4), "i64"), 2.5], {}, False),
    ("where", lambda r: [r.arr((3, 1), "bool"), r.arr((3, 4)), 0.0], {}, True),
    ("where", lambda r: [r.arr((3, 4), "bool")], {}, False),
    ("nonzero", one("i64"), {}, False), ("nonzero", one("bool"), {"as_tuple": True}, False),
    ("masked_select", lambda r: [r.arr((3, 4)), r.arr((3, 4), "bool")], {}, True),
    ("masked_select", lambda r: [r.arr((3, 4)), r.arr((1, 4), "bool")], {}, True),
    ("masked_fill", lambda r: [r.arr((3, 4)), r.arr((3, 4), "bool"), 2.0], {}, True),
    ("masked_fill", lambda r: [r.arr((3, 4), "i64"), r.arr((3, 4), "bool"), 2.5], {}, False),
    ("masked_fill", lambda r: [r.arr((3, 4)), r.arr((3, 4), "bool"),
                               np.full((), -1.0, np.float32)], {}, True),
    ("gather", lambda r: [r.arr((4, 3)), np.array([3, 0, 0], I64)], {}, True),
    ("gather", lambda r: [r.arr((4, 3)), np.array([2, 1], I64)], {"axis": 1}, True),
    ("gather", lambda r: [r.arr((4, 3)), np.array(2, I64)], {}, True),
    ("gather", lambda r: [r.arr((4, 3)), np.array([[1], [3]], I64)], {}, True),
    ("gather_nd", lambda r: [r.arr((3, 4, 2)), np.array([[0, 1], [2, 3]], I64)], {}, True),
    ("gather_nd", lambda r: [r.arr((3, 4)), np.array([[2], [0]], I64)], {}, True),
    ("take_along_axis", lambda r: [r.arr((3, 4)), np.array([[0, 3], [1, 1], [2, 0]], I64),
                                   1], {}, True),
    ("take_along_axis", lambda r: [r.arr((3, 4)), np.array([[2, 0, 1, 1]], I64), 0], {}, True),
    ("put_along_axis", lambda r: [r.arr((3, 4)), np.array([[0], [3], [1]], I64), 9.0, 1], {},
     True),
    ("put_along_axis", lambda r: [r.arr((3, 4)), np.array([[0, 0], [3, 3], [1, 2]], I64),
                                  r.arr((3, 2)), 1], {"reduce": "add"}, True),
    ("put_along_axis", lambda r: [r.arr((3, 4), "pos"), np.array([[0, 1], [3, 2], [1, 2]], I64),
                                  r.arr((3, 2), "pos"), 1], {"reduce": "multiply"}, False),
    ("scatter", lambda r: [r.arr((4, 3)), np.array([2, 0], I64), r.arr((2, 3))], {}, True),
    # duplicate indices only with overwrite=False: with True the write order is undefined
    ("scatter", lambda r: [r.arr((4, 3)), np.array([2, 0, 2], I64), r.arr((3, 3))],
     {"overwrite": False}, True),
    ("scatter_nd_add", lambda r: [r.arr((3, 4)), np.array([[0, 1], [2, 2], [0, 1]], I64),
                                  r.arr((3,))], {}, True),
    ("scatter_nd_add", lambda r: [r.arr((3, 4)), np.array([[1], [1]], I64), r.arr((2, 4))], {},
     True),
    ("scatter_nd", lambda r: [np.array([[1], [0], [1]], I64), r.arr((3, 4)), [2, 4]], {}, True),
    ("index_select", lambda r: [r.arr((3, 4)), np.array([3, 1], I64), 1], {}, True),
    ("index_sample", lambda r: [r.arr((3, 4)), np.array([[0, 3], [1, 1], [2, 0]], I64)], {},
     True),
    ("index_add", lambda r: [r.arr((3, 4)), np.array([0, 2, 0], I64), 0, r.arr((3, 4))], {},
     True),
    ("index_add", lambda r: [r.arr((3, 4)), np.array([3, 1], I64), 1, r.arr((3, 2))], {}, True),
    ("index_put", lambda r: [r.arr((3, 4)), L([np.array([0, 2], I64), np.array([1, 3], I64)]),
                             r.arr((2,))], {}, True),
    ("index_put", lambda r: [r.arr((3, 4)), L([np.array([0, 0], I64), np.array([1, 1], I64)]),
                             r.arr((2,))], {"accumulate": True}, True),
    ("sort", one(), {}, True), ("sort", one("f32", (3, 4)), {"axis": 0, "descending": True},
                                True),
    ("sort", lambda r: [TIES], {"descending": True}, True),
    ("argsort", lambda r: [TIES], {}, False),
    ("argsort", lambda r: [TIES], {"descending": True}, False),
    ("argsort", one("i64", (4, 5)), {"axis": 0, "descending": True}, False),
    ("topk", lambda r: [TIES, 3], {}, True),
    ("topk", lambda r: [TIES, 2], {"largest": False}, True),
    ("topk", one("f32", (5, 3)), {"k": 2, "axis": 0}, True),
    ("unique", lambda r: [np.array([3, 1, 2, 1, 3, 3], I64)],
     {"return_index": True, "return_inverse": True, "return_counts": True}, False),
    ("unique", lambda r: [np.array([[3, 1], [1, 2]], I64)],
     {"return_inverse": True, "return_counts": True}, False),
    ("unique", lambda r: [np.array([[1, 2], [0, 5], [1, 2], [0, 4]], np.float32)],
     {"return_index": True, "return_inverse": True, "axis": 0}, False),
    ("unique", lambda r: [np.array([2.0, 1.0, 2.0], np.float32)], {}, False),
    ("searchsorted", lambda r: [np.array([1.0, 2.0, 2.0, 4.0], np.float32),
                                np.array([[0.5, 2.0], [2.5, 9.0]], np.float32)], {}, False),
    ("searchsorted", lambda r: [np.array([1.0, 2.0, 2.0, 4.0], np.float32),
                                np.array([2.0, 4.0], np.float32)], {"right": True,
                                                                    "out_int32": True}, False),
    ("searchsorted", lambda r: [np.array([[1, 3, 5], [2, 4, 6]], I64),
                                np.array([[3, 6], [1, 5]], I64)], {}, False),
    ("bucketize", lambda r: [np.array([0.5, 2.0, 3.0], np.float32),
                             np.array([1.0, 2.0, 4.0], np.float32)], {"right": True}, False),
    ("pad", one("f32", (1, 2)), {"pad": [1, 0, 0, 2]}, True),
    ("pad", one("f32", (2, 3, 4, 5)), {"pad": [1, 2, 0, 1]}, True),
    ("pad", one("f32", (2, 3, 4, 5)), {"pad": [1, 2], "mode": "reflect"}, True),
    ("pad", one("f32", (2, 3, 4, 5)), {"pad": [2, 1, 1, 3], "mode": "replicate"}, True),
    ("pad", one("f32", (2, 3, 4, 5)), {"pad": [1, 1, 2, 0], "mode": "circular"}, True),
    ("pad", one("f32", (2, 4, 5, 3)), {"pad": [1, 2, 0, 1], "data_format": "NHWC",
                                       "value": 1.5}, True),
    ("pad", one("i64", (2, 3)), {"pad": [0, 1, 2, 0], "value": 7}, False),
    ("pad", one("f32", (1, 2, 5)), {"pad": [3, 4], "mode": "reflect"}, True),
    ("strided_slice", one("f32", (5, 6)), {"axes": [0, 1], "starts": [1, 0], "ends": [5, 6],
                                           "strides": [2, 3]}, True),
    ("strided_slice", one("f32", (5, 6)), {"axes": [1], "starts": [5], "ends": [0],
                                           "strides": [-2]}, True),
    ("slice", one("f32", (5, 6)), {"axes": [0, 1], "starts": [1, -3], "ends": [3, 100]}, True),
    ("shard_index", lambda r: [np.array([[1], [6], [12], [19]], I64), 20, 2, 1], {}, False),
    ("tensordot", lambda r: [r.arr((3, 4, 5)), r.arr((4, 5, 2))], {}, True),
    ("tensordot", lambda r: [r.arr((3, 4)), r.arr((4, 3))], {"axes": [[1, 0], [0, 1]]}, True),
    ("tensordot", lambda r: [r.arr((3, 4)), r.arr((2, 5))], {"axes": 0}, True),
    ("as_real", one("c64"), {}, False), ("as_complex", one("f32", (3, 2)), {}, False),
    ("view", one(), {"shape_or_dtype": [4, 3]}, True),
    ("view", one(), {"shape_or_dtype": "float64"}, True),
    ("atleast_1d", lambda r: [np.full((), 1.0, np.float32)], {}, False),
    ("atleast_2d", one("f32", (3,)), {}, False),
    ("atleast_3d", one("f32", (3, 2)), {}, False),
    ("atleast_3d", lambda r: [r.arr((3,)), r.arr((2, 2))], {}, False),
    ("diff", one(), {}, True), ("diff", one("f32", (4, 3)), {"n": 2, "axis": 0}, True),
    ("diff", one("i64", (5,)), {}, False), ("diff", one("bool", (5,)), {}, False),
]


@pytest.mark.parametrize("name,build,kwargs,grad", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_manipulation(name, build, kwargs, grad):
    run_case(name, build, kwargs, tol=F32, grad=grad)


def test_broadcast_shape():
    assert tp.broadcast_shape([3, 1], [1, 4]) == jp.broadcast_shape([3, 1], [1, 4]) == [3, 4]


GETITEM = [
    1, -1, slice(1, 3), (slice(None), 2), (Ellipsis, None, slice(0, 2)),
    (slice(None, None, 2), slice(3, 0, -1)), [2, 0, 2], np.array([1, 2]),
    (np.array([0, 2]), np.array([3, 1])), (slice(0, 2), [0, 3]),
]


@pytest.mark.parametrize("item", GETITEM, ids=[str(i) for i in range(len(GETITEM))])
def test_getitem(item):
    run_case("getitem", lambda r: [r.arr((3, 4)), item], tol=F32, grad=True)


def test_getitem_with_masks():
    mask = np.array([[True, False, True, False]] * 3)
    run_case("getitem", lambda r: [r.arr((3, 4)), mask], tol=F32, grad=True)
    run_case("getitem", lambda r: [r.arr((3, 4)), (np.array([True, False, True]),
                                                   slice(1, 3))], tol=F32, grad=True)


SETITEM = [(1, 5.0), ((slice(None), 2), "col"), (np.array([0, 2]), "rows"),
           (np.array([[True, False, True, False]] * 3), 0.0)]


@pytest.mark.parametrize("item,value", SETITEM, ids=[str(i) for i in range(len(SETITEM))])
def test_setitem_writes_in_place(item, value):
    rng = np.random.RandomState(0)
    a = rng.standard_normal((3, 4)).astype(np.float32)
    v = {"col": rng.standard_normal(3).astype(np.float32),
         "rows": rng.standard_normal((2, 4)).astype(np.float32)}.get(value, value)
    jx, tx = jp.to_tensor(a), torch.from_numpy(a.copy())
    jv = jp.to_tensor(v) if isinstance(v, np.ndarray) else v
    tv = torch.from_numpy(v) if isinstance(v, np.ndarray) else v
    out = tp.setitem(tx, item, tv)
    jp.setitem(jx, item, jv)
    assert out is tx
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx.numpy()))


def test_setitem_on_a_leaf_that_requires_grad_raises_in_both():
    for pkg, make in ((jp, lambda: jp.to_tensor([1.0, 2.0], stop_gradient=False)),
                      (tp, lambda: tp.to_tensor([1.0, 2.0], stop_gradient=False))):
        with pytest.raises(RuntimeError):
            pkg.setitem(make(), 0, 3.0)
    # through a non-leaf it writes and keeps the graph: d(sum(y))/dx with y[0] replaced
    x = tp.to_tensor([1.0, 2.0], stop_gradient=False)
    y = tp.multiply(x, 2.0)
    tp.setitem(y, 0, 5.0)
    (g,) = tp.grad(tp.sum(y), [x])
    assert g.tolist() == [0.0, 2.0]


def test_setitem_casts_the_value():
    x = tp.zeros([3], dtype="int64")
    tp.setitem(x, 1, tp.to_tensor(2.7))
    tp.setitem(x, [0, 2], [4, 5])
    assert x.dtype == torch.int64 and x.tolist() == [4, 2, 5]


# ---- the cases of the reference's semantics that torch's differ from ----

def test_argsort_descending_flips_the_stable_order():
    x = [1.0, 2.0, 2.0, 3.0]
    assert tp.argsort(tp.to_tensor(x), descending=True).tolist() == [3, 2, 1, 0]
    assert np.asarray(jp.argsort(jp.to_tensor(x), descending=True).numpy()).tolist() == \
        [3, 2, 1, 0]


def test_pad_of_2ndim_goes_first_dim_first():
    out = tp.pad(tp.ones([1, 2]), [1, 0, 0, 2])
    assert list(out.shape) == [2, 4] == jp.pad(jp.ones([1, 2]), [1, 0, 0, 2]).shape


def test_gather_is_take_along_the_axis():
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    got = tp.gather(torch.from_numpy(x), torch.tensor([3, 1]), axis=1)
    np.testing.assert_array_equal(got.numpy(), np.take(x, [3, 1], axis=1))
    run_case("gather", lambda r: [x, np.array([3, 1], I64), 1])


def test_split_with_a_minus_one_section_and_nonzero_int64():
    parts = tp.split(tp.arange(6), [1, -1, 2])
    assert [p.tolist() for p in parts] == [[0], [1, 2, 3], [4, 5]]
    nz = tp.nonzero(tp.to_tensor([[0, 1], [2, 0]]))
    assert nz.dtype == torch.int64 and nz.tolist() == [[0, 1], [1, 0]]
    assert [t.dtype for t in tp.nonzero(tp.to_tensor([0, 3]), as_tuple=True)] == [torch.int64]


def test_scatter_without_overwrite_zeroes_then_accumulates():
    x = tp.ones([3, 2])
    out = tp.scatter(x, tp.to_tensor([1, 1]), tp.to_tensor([[1.0, 2.0], [3.0, 4.0]]),
                     overwrite=False)
    assert out.tolist() == [[1.0, 1.0], [4.0, 6.0], [1.0, 1.0]]


def test_topk_keeps_ties_in_index_order():
    v, i = tp.topk(tp.to_tensor([1.0, 3.0, 3.0, 2.0, 3.0]), 2)
    assert v.tolist() == [3.0, 3.0] and i.tolist() == [1, 2]
    v, i = tp.topk(tp.to_tensor([1.0, 0.0, 0.0, 2.0]), 2, largest=False)
    assert i.tolist() == [1, 2]


def test_in_place_helpers():
    x = tp.ones([2, 1, 3])
    assert tp.squeeze_(x, 1) is x and list(x.shape) == [2, 3]
    assert tp.unsqueeze_(x, [0, 3]) is x and list(x.shape) == [1, 2, 3, 1]
    y = tp.reshape_(tp.arange(6), [2, 3])
    assert list(y.shape) == [2, 3] and y.tolist() == [[0, 1, 2], [3, 4, 5]]
    z = tp.zeros([3, 2])
    assert tp.scatter_(z, tp.to_tensor([2, 0]), tp.ones([2, 2])) is z
    assert z.tolist() == [[1.0, 1.0], [0.0, 0.0], [1.0, 1.0]]
    z = tp.ones([3, 2])
    tp.scatter_(z, tp.to_tensor([1, 1]), tp.ones([2, 2]), overwrite=False)
    assert z.tolist() == [[1.0, 1.0], [2.0, 2.0], [1.0, 1.0]]
    w = tp.to_tensor([0.0, 1.0])
    assert tp.tanh_(w) is w and abs(w[1].item() - np.tanh(1.0)) < 1e-7
    assert tp.tolist(tp.to_tensor([[1, 2]])) == [[1, 2]]


def test_unique_consecutive_and_crop_against_numpy():
    """The JAX package's ``unique_consecutive`` and ``crop`` fail on every
    input (its ``slice`` op shadows the builtin there; ``crop`` calls
    ``strided_slice`` without strides), so these hold the port to numpy's
    semantics of the reference's code."""
    a = np.array([1, 1, 2, 2, 3, 1, 1], I64)
    out, inv, cnt = tp.unique_consecutive(torch.from_numpy(a), return_inverse=True,
                                          return_counts=True)
    assert out.tolist() == [1, 2, 3, 1] and inv.tolist() == [0, 0, 1, 1, 2, 3, 3]
    assert cnt.tolist() == [2, 2, 1, 2] and inv.dtype == cnt.dtype == torch.int64
    m = np.array([[1, 1], [1, 1], [2, 0], [1, 1]], I64)
    out, cnt = tp.unique_consecutive(torch.from_numpy(m), return_counts=True, axis=0)
    assert out.tolist() == [[1, 1], [2, 0], [1, 1]] and cnt.tolist() == [2, 1, 1]
    assert tp.unique_consecutive(tp.to_tensor([[2, 2], [3, 3]])).tolist() == [2, 3]
    x = np.arange(30, dtype=np.float32).reshape(5, 6)
    np.testing.assert_array_equal(
        tp.crop(torch.from_numpy(x), shape=[2, 3], offsets=[1, 2]).numpy(), x[1:3, 2:5])
    np.testing.assert_array_equal(tp.crop(torch.from_numpy(x), shape=[5, 1]).numpy(), x[:, :1])
