"""The port's linear algebra (``paddle_tpu_torch.linalg``, also the top
level) against the JAX package's ``paddle_tpu/ops/linalg.py`` on the same
seeded numpy inputs.

Products, norms, solves and the other functions whose result is unique are
held in dtype, shape and value: f32 2e-5 / 2e-6 (rtol / atol; sums in
other orders), f64 1e-9 / 1e-11; their gradients 1e-4 / 1e-5 at f32. The
decompositions are unique only up to signs, order and phases, so they are
held by what is unique: singular values, and eigenvalues sorted, equal to
JAX's; the factors by reconstruction (within 1e-9 of the input at f64) and
orthogonality; QR's R by the absolute values of its rows; LU by P L U = A
with JAX's pivots. ``norm(p="nuc")``, which the reference's kernel does not
take, is held to numpy's nuclear norm.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from torch_api_util import L, Inputs, np_of, on_cpu, run_case  # noqa: F401

torch.set_num_threads(1)

pytestmark = pytest.mark.usefixtures("on_cpu")

F32 = (2e-5, 2e-6)
F64 = (1e-9, 1e-11)
REC = 1e-9      # reconstructions of f64 decompositions


def spd(n=4, kind="f64"):
    return lambda r: [r.spd(n, kind)]


def tri(upper, kind="f64"):
    def build(r):
        a = r.spd(4, kind)
        a = np.triu(a) if upper else np.tril(a)
        return [a, r.arr((4, 2), kind)]
    return build


CASES = [
    # (name, build, kwargs, tol, grad)
    ("matmul", lambda r: [r.arr((3, 4)), r.arr((4, 5))], {}, F32, True),
    ("matmul", lambda r: [r.arr((2, 3, 4)), r.arr((4, 5))], {}, F32, True),
    ("matmul", lambda r: [r.arr((4,)), r.arr((2, 4, 3))], {}, F32, True),
    ("matmul", lambda r: [r.arr((4, 3)), r.arr((5, 4))],
     {"transpose_x": True, "transpose_y": True}, F32, True),
    ("matmul", lambda r: [r.arr((3, 4), "i64"), r.arr((4, 2), "i64")], {}, F32, False),
    ("matmul", lambda r: [r.arr((3, 4), "f64"), r.arr((4, 2))], {}, F64, True),
    ("mm", lambda r: [r.arr((3, 4)), r.arr((4, 2))], {}, F32, True),
    ("bmm", lambda r: [r.arr((2, 3, 4)), r.arr((2, 4, 5))], {}, F32, True),
    ("mv", lambda r: [r.arr((3, 4)), r.arr((4,))], {}, F32, True),
    ("dot", lambda r: [r.arr((4,)), r.arr((4,))], {}, F32, True),
    ("dot", lambda r: [r.arr((3, 4)), r.arr((3, 4))], {}, F32, True),
    ("dot", lambda r: [r.arr((4,), "i64"), r.arr((4,), "i64")], {}, F32, False),
    ("einsum", lambda r: ["ij,jk->ik", r.arr((3, 4)), r.arr((4, 2))], {}, F32, True),
    ("einsum", lambda r: ["bij,bkj->bik", r.arr((2, 3, 4)), r.arr((2, 5, 4))], {}, F32, True),
    ("einsum", lambda r: ["ii->i", r.arr((3, 3))], {}, F32, True),
    ("norm", lambda r: [r.arr((3, 4))], {}, F32, True),
    ("norm", lambda r: [r.arr((3, 4))], {"axis": 1}, F32, True),
    ("norm", lambda r: [r.arr((3, 4))], {"p": np.inf}, F32, True),
    ("norm", lambda r: [r.arr((3, 4))], {"p": -np.inf, "axis": 0}, F32, True),
    ("norm", lambda r: [r.arr((3, 4))], {"p": 0, "axis": 1}, F32, False),
    ("norm", lambda r: [r.arr((3, 4))], {"p": 1, "axis": 1, "keepdim": True}, F32, True),
    ("norm", lambda r: [r.arr((2, 3, 4))], {"axis": [0, 2], "keepdim": True}, F32, True),
    ("norm", lambda r: [r.arr((3, 4))], {"p": 3}, F32, True),
    ("norm", lambda r: [r.arr((3, 4), "i64")], {}, F64, False),
    ("norm", lambda r: [r.arr((3, 4), "i64")], {"p": np.inf}, F64, False),
    ("vector_norm", lambda r: [r.arr((3, 4))], {}, F32, True),
    ("vector_norm", lambda r: [r.arr((3, 4))], {"p": 1.5, "axis": 0}, F32, True),
    ("dist", lambda r: [r.arr((3, 4)), r.arr((3, 4))], {}, F32, True),
    ("dist", lambda r: [r.arr((3, 4)), r.arr((4,))], {"p": 1}, F32, True),
    ("dist", lambda r: [r.arr((3, 4)), r.arr((3, 4))], {"p": np.inf}, F32, False),
    ("cross", lambda r: [r.arr((4, 3)), r.arr((4, 3))], {}, F32, True),
    ("cross", lambda r: [r.arr((3, 3)), r.arr((3, 3))], {"axis": 0}, F32, True),
    ("cholesky", spd(), {}, F64, True), ("cholesky", spd(), {"upper": True}, F64, True),
    ("inverse", spd(), {}, F64, True), ("inv", spd(4, "f32"), {}, (1e-4, 1e-5), True),
    ("pinv", lambda r: [r.arr((4, 3), "f64")], {}, F64, False),
    ("solve", lambda r: [r.spd(4), r.arr((4,), "f64")], {}, F64, True),
    ("solve", lambda r: [r.spd(4), r.arr((4, 3), "f64")], {}, F64, True),
    ("triangular_solve", tri(True), {}, F64, True),
    ("triangular_solve", tri(False), {"upper": False, "transpose": True}, F64, True),
    ("triangular_solve", tri(True), {"unitriangular": True}, F64, True),
    ("cholesky_solve", lambda r: [r.arr((4, 2), "f64"), np.linalg.cholesky(r.spd(4))], {},
     F64, True),
    ("cholesky_solve", lambda r: [r.arr((4, 2), "f64"), np.linalg.cholesky(r.spd(4)).T],
     {"upper": True}, F64, True),
    ("det", spd(), {}, F64, True), ("det", lambda r: [r.arr((2, 3, 3), "f64")], {}, F64, True),
    ("slogdet", lambda r: [r.arr((3, 3), "f64")], {}, F64, False),
    ("matrix_power", lambda r: [r.arr((3, 3))], {"n": 3}, (1e-4, 1e-5), True),
    ("matrix_power", spd(3), {"n": -2}, F64, True),
    ("matrix_power", lambda r: [r.arr((3, 3))], {"n": 0}, F32, False),
    ("multi_dot", lambda r: [L([r.arr((3, 4)), r.arr((4, 5)), r.arr((5, 2))])], {},
     (1e-4, 1e-5), True),
    ("cond", lambda r: [r.arr((4, 4), "f64")], {}, (1e-8, 1e-10), False),
    ("cond", spd(), {"p": "fro"}, (1e-8, 1e-10), False),
    ("matrix_rank", lambda r: [r.arr((4, 3), "f64")], {}, F64, False),
    ("matrix_rank", lambda r: [np.outer(np.arange(1.0, 5.0), np.arange(1.0, 4.0))], {}, F64,
     False),
    ("matrix_rank", lambda r: [r.arr((2, 3, 3), "f64")], {"tol": 0.5}, F64, False),
    ("eigvalsh", spd(), {}, F64, False), ("eigvalsh", spd(), {"UPLO": "U"}, F64, False),
    ("cov", lambda r: [r.arr((3, 6), "f64")], {}, F64, False),
    ("cov", lambda r: [r.arr((6, 3), "f64")], {"rowvar": False, "ddof": False}, F64, False),
    ("corrcoef", lambda r: [r.arr((3, 6), "f64")], {}, F64, False),
    ("corrcoef", lambda r: [r.arr((6, 3), "f64")], {"rowvar": False}, F64, False),
    ("histogram", lambda r: [r.arr((50,))], {"bins": 7}, F32, False),
    ("histogram", lambda r: [r.arr((50,))], {"bins": 4, "min": -1, "max": 1}, F32, False),
    ("histogram", lambda r: [r.arr((20,), "nat")], {"bins": 9}, F32, False),
    ("bincount", lambda r: [r.arr((20,), "nat")], {}, F32, False),
    ("bincount", lambda r: [r.arr((20,), "nat"), r.arr((20,))], {"minlength": 12}, F32, False),
]


@pytest.mark.parametrize("name,build,kwargs,tol,grad", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_linalg(name, build, kwargs, tol, grad):
    run_case(name, build, kwargs, tol=tol, grad=grad)


def test_linalg_is_a_module_of_the_namespace():
    import importlib

    mod = importlib.import_module("paddle_tpu_torch.linalg")
    assert mod is tp.linalg and tp.linalg.inv is tp.linalg.inverse
    for n in ("norm", "svd", "qr", "eigh", "cholesky", "matrix_rank", "cond", "lstsq", "lu",
              "lu_unpack", "multi_dot", "matmul", "det", "slogdet", "pinv", "solve"):
        assert callable(getattr(mod, n)), n
    run_case((jp.linalg.norm, tp.linalg.norm), lambda r: [r.arr((3, 4))], {"p": 2, "axis": 0},
             tol=F32)


def test_norm_nuc_is_the_sum_of_singular_values():
    a = Inputs(0).arr((2, 3, 4), "f64")
    got = tp.linalg.norm(torch.from_numpy(a), p="nuc", axis=[1, 2])
    want = np.linalg.norm(a, ord="nuc", axis=(1, 2))
    assert got.dtype == torch.float64 and got.shape == (2,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
    m = a[0]
    np.testing.assert_allclose(tp.linalg.norm(torch.from_numpy(m), p="nuc", keepdim=True)
                               .numpy(), np.linalg.norm(m, "nuc", keepdims=True), rtol=1e-12)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("shape,full", [((5, 3), False), ((3, 5), False), ((4, 4), True),
                                        ((2, 5, 3), False)])
def test_svd_by_values_reconstruction_and_orthogonality(shape, full):
    a = Inputs(1).arr(shape, "f64")
    u, s, v = tp.linalg.svd(_t(a), full_matrices=full)
    ju, js, jv = jp.linalg.svd(jp.to_tensor(a, dtype="float64"), full_matrices=full)
    assert [str(t.dtype) for t in (u, s, v)] == ["torch.float64"] * 3
    assert [tuple(t.shape) for t in (u, s, v)] == [tuple(t.shape) for t in (ju, js, jv)]
    np.testing.assert_allclose(s.numpy(), np_of(js), rtol=1e-12)
    k = s.shape[-1]
    rec = u[..., :, :k] @ torch.diag_embed(s) @ v[..., :, :k].transpose(-1, -2)
    np.testing.assert_allclose(rec.numpy(), a, atol=REC)
    eye = np.broadcast_to(np.eye(u.shape[-1]), u.shape[:-2] + (u.shape[-1],) * 2)
    if full or shape[-2] <= shape[-1]:
        np.testing.assert_allclose((u.transpose(-1, -2) @ u).numpy(),
                                   np.broadcast_to(np.eye(u.shape[-1]), eye.shape), atol=REC)
    np.testing.assert_allclose((v.transpose(-1, -2) @ v).numpy(),
                               np.broadcast_to(np.eye(v.shape[-1]),
                                               v.shape[:-2] + (v.shape[-1],) * 2), atol=REC)


@pytest.mark.parametrize("shape,mode", [((5, 3), "reduced"), ((4, 4), "complete"),
                                        ((3, 5), "reduced")])
def test_qr_by_reconstruction_and_r_magnitudes(shape, mode):
    a = Inputs(2).arr(shape, "f64")
    q, r = tp.linalg.qr(_t(a), mode=mode)
    jq, jr = jp.linalg.qr(jp.to_tensor(a, dtype="float64"), mode=mode)
    assert (tuple(q.shape), tuple(r.shape)) == (tuple(jq.shape), tuple(jr.shape))
    np.testing.assert_allclose((q @ r).numpy(), a, atol=REC)
    np.testing.assert_allclose((q.T @ q).numpy(), np.eye(q.shape[1]), atol=REC)
    np.testing.assert_allclose(np.abs(r.numpy()), np.abs(np_of(jr)), atol=1e-9)
    assert np.allclose(np.tril(r.numpy(), -1), 0)


def test_eigh_and_eig_by_values_and_reconstruction():
    a = Inputs(3).spd(5)
    w, v = tp.linalg.eigh(_t(a))
    jw, _ = jp.linalg.eigh(jp.to_tensor(a, dtype="float64"))
    np.testing.assert_allclose(w.numpy(), np_of(jw), rtol=1e-12)
    np.testing.assert_allclose((v @ torch.diag(w) @ v.T).numpy(), a, atol=REC)
    np.testing.assert_allclose((v.T @ v).numpy(), np.eye(5), atol=REC)
    b = Inputs(4).arr((4, 4), "f64")
    w, v = tp.linalg.eig(_t(b))
    jw, _ = jp.linalg.eig(jp.to_tensor(b, dtype="float64"))
    assert str(w.dtype) == "torch.complex128" == "torch." + str(jw.dtype)
    key = lambda z: (np.round(z.real, 9), np.round(z.imag, 9))  # noqa: E731
    np.testing.assert_allclose(sorted(w.numpy(), key=key), sorted(np_of(jw), key=key),
                               atol=1e-10)
    bc = _t(b).to(torch.complex128)
    np.testing.assert_allclose((bc @ v).numpy(), (v @ torch.diag(w)).numpy(), atol=REC)
    ev = tp.linalg.eigvals(_t(b))
    np.testing.assert_allclose(sorted(ev.numpy(), key=key),
                               sorted(np_of(jp.linalg.eigvals(jp.to_tensor(b, dtype="float64"))),
                                      key=key), atol=1e-10)


def test_lu_and_lu_unpack_by_reconstruction_and_pivots():
    a = Inputs(5).arr((4, 4), "f64")
    lu_, piv = tp.linalg.lu(_t(a))
    jlu, jpiv = jp.linalg.lu(jp.to_tensor(a, dtype="float64"))
    assert piv.dtype == torch.int32 and str(jpiv.dtype) == "int32"
    np.testing.assert_array_equal(piv.numpy(), np_of(jpiv))
    np.testing.assert_allclose(lu_.numpy(), np_of(jlu), atol=1e-10)
    P, Lm, U = tp.linalg.lu_unpack(lu_, piv)
    jP, jL, jU = jp.linalg.lu_unpack(jlu, jpiv)
    for got, want in ((P, jP), (Lm, jL), (U, jU)):
        np.testing.assert_allclose(got.numpy(), np_of(want), atol=1e-10)
    np.testing.assert_allclose((P @ Lm @ U).numpy(), a, atol=REC)
    _, _, info = tp.linalg.lu(_t(a), get_infos=True)
    assert info.dtype == torch.int32 and int(info) == 0
    (only_p,) = tp.linalg.lu_unpack(lu_, piv, unpack_ludata=False)
    assert torch.equal(only_p, P)


@pytest.mark.parametrize("shape,bshape", [((6, 3), (6,)), ((6, 3), (6, 2)), ((3, 5), (3,))])
def test_lstsq_like_jnp(shape, bshape):
    r = Inputs(6)
    run_case("lstsq", lambda _: [r.arr(shape, "f64"), r.arr(bshape, "f64")], tol=F64)
