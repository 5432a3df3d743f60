"""Linear algebra ops (counterpart of paddle_tpu/ops/linalg.py); also
``paddle_tpu_torch.linalg``, as the reference's module is ``paddle_tpu.linalg``.

Products take the AMP lookup under their JAX names (``matmul``, ``bmm``,
``mv``, ``einsum``, ``addmm`` are white-listed: bf16 under O1). ``norm``
follows the reference's kernel: ``p`` defaults to "fro" without an axis or
with a list of axes, else 2; "fro" is the square root of the sum of
squares over ``axis`` (every entry without one), ``inf`` / ``-inf`` the max
/ min of absolute values, 0 the count of nonzeros, any other p the vector
p-norm over ``axis``. "nuc" (which the reference's kernel does not take) is
the sum of singular values of the matrices over the last two axes.
``lstsq`` is jnp's SVD solve (its residuals, rank and singular values on
every device); decompositions are LAPACK's / cuSOLVER's, unique up to
signs and phases as the reference's are.
"""
from __future__ import annotations

import numpy as np
import torch

from ._helpers import inputs, operands, public, t_, to_inexact
from .math import _sum_dtype


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    a, b = operands("matmul", x, y, tensors=True)
    if transpose_x and a.dim() > 1:
        a = a.transpose(-1, -2)
    if transpose_y and b.dim() > 1:
        b = b.transpose(-1, -2)
    return torch.matmul(a, b)


def mm(x, y, name=None):
    return matmul(x, y)


def bmm(x, y, name=None):
    return torch.matmul(*operands("bmm", x, y, tensors=True))


def mv(x, vec, name=None):
    return torch.matmul(*operands("mv", x, vec, tensors=True))


def dot(x, y, name=None):
    a, b = operands("dot", x, y, tensors=True)
    prod = a * b
    return prod.sum(-1, dtype=_sum_dtype(prod.dtype))


def einsum(equation, *operands_):
    return torch.einsum(equation, *operands("einsum", *operands_, tensors=True))


def norm(x, p=None, axis=None, keepdim=False, name=None):
    if p is None:
        p = "fro" if axis is None or isinstance(axis, (list, tuple)) else 2
    a = inputs("norm", x)
    dims = (tuple(range(a.dim())) if axis is None
            else tuple(axis) if isinstance(axis, (list, tuple)) else int(axis))
    if p == "fro":
        a = to_inexact(a)
        return torch.sqrt(torch.sum(torch.square(a), dim=dims, keepdim=keepdim))
    if p == "nuc":
        s = torch.linalg.svdvals(to_inexact(a) if axis is None else
                                 torch.movedim(to_inexact(a), dims, (-2, -1)))
        out = s.sum(-1)
        if keepdim:
            d = (a.dim() - 2, a.dim() - 1) if axis is None else tuple(i % a.dim() for i in dims)
            for i in sorted(d):
                out = out.unsqueeze(i)
        return out
    if p == np.inf:
        return torch.amax(torch.abs(a), dim=dims, keepdim=keepdim)
    if p == -np.inf:
        return torch.amin(torch.abs(a), dim=dims, keepdim=keepdim)
    if p == 0:
        return torch.sum((a != 0).to(a.dtype), dim=dims, keepdim=keepdim)
    a = to_inexact(a)
    return torch.pow(torch.sum(torch.pow(torch.abs(a), p), dim=dims, keepdim=keepdim), 1.0 / p)


def vector_norm(x, p=2.0, axis=None, keepdim=False, name=None):
    return norm(x, p, axis, keepdim)


def dist(x, y, p=2, name=None):
    a, b = operands("subtract", x, y, tensors=True)
    return norm(a - b, p)


def cross(x, y, axis=9, name=None):
    a, b = operands("cross", x, y, tensors=True)
    if axis == 9:
        axis = next(i for i, s in enumerate(a.shape) if s == 3)
    return torch.linalg.cross(a, b, dim=axis)


def cholesky(x, upper=False, name=None):
    lo = torch.linalg.cholesky(inputs("cholesky", x))
    return lo.transpose(-1, -2) if upper else lo


def inverse(x, name=None):
    return torch.linalg.inv(to_inexact(inputs("inverse", x)))


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return torch.linalg.pinv(to_inexact(inputs("pinv", x)), rtol=rcond)


def solve(x, y, name=None):
    return torch.linalg.solve(*operands("solve", x, y, tensors=True))


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False, name=None):
    a, b = operands("triangular_solve", x, y, tensors=True)
    if transpose:
        a, upper = a.transpose(-1, -2), not upper
    return torch.linalg.solve_triangular(a, b, upper=upper, left=True,
                                         unitriangular=unitriangular)


def qr(x, mode="reduced", name=None):
    q, r = torch.linalg.qr(to_inexact(inputs("qr", x)), mode=mode)
    return q, r


def svd(x, full_matrices=False, name=None):
    u, s, vh = torch.linalg.svd(to_inexact(inputs("svd", x)), full_matrices=full_matrices)
    return u, s, vh.transpose(-1, -2).conj()


def eig(x, name=None):
    return torch.linalg.eig(to_inexact(inputs("eig", x)))


def eigh(x, UPLO="L", name=None):
    return torch.linalg.eigh(to_inexact(inputs("eigh", x)), UPLO=UPLO)


def eigvals(x, name=None):
    return torch.linalg.eigvals(to_inexact(inputs("eigvals", x)))


def eigvalsh(x, UPLO="L", name=None):
    return torch.linalg.eigvalsh(to_inexact(inputs("eigvalsh", x)), UPLO=UPLO)


def matrix_power(x, n, name=None):
    return torch.linalg.matrix_power(inputs("matrix_power", x), n)


def matrix_rank(x, tol=None, hermitian=False, name=None):
    """The count of singular values above ``tol`` (absolute, as jnp takes
    the reference's ``rtol=tol``; max|s| max(M, N) eps without one), int64."""
    a = to_inexact(inputs("matrix_rank", x))
    if a.dim() < 2:
        return (a != 0).any().to(torch.int64)
    s = torch.linalg.svdvals(a)
    if tol is None:
        tol = s.amax(-1, keepdim=True) * max(a.shape[-2:]) * torch.finfo(s.dtype).eps
    return (s > tol).sum(-1)


def slogdet(x, name=None):
    sign, logabsdet = torch.linalg.slogdet(to_inexact(inputs("slogdet", x)))
    return torch.stack([sign, logabsdet])


def det(x, name=None):
    return torch.linalg.det(to_inexact(inputs("det", x)))


def lu(x, pivot=True, get_infos=False, name=None):
    lu_, piv = torch.linalg.lu_factor(to_inexact(inputs("lu", x)))
    outs = [lu_, piv.to(torch.int32)]
    if get_infos:
        outs.append(torch.zeros((), dtype=torch.int32, device=lu_.device))
    return tuple(outs)


def lstsq(x, y, rcond=None, driver=None, name=None):
    """jnp.linalg.lstsq: the least-squares solution by SVD, with the
    residuals (always, per column of y), the rank and the singular values."""
    a, b = operands("lstsq", x, y, tensors=True)
    a, b = to_inexact(a), to_inexact(b)
    vec = b.dim() == 1
    if vec:
        b = b[:, None]
    m, n = a.shape[-2:]
    eps = torch.finfo(a.dtype).eps
    rcond = eps * max(m, n) if rcond is None else (eps if rcond < 0 else rcond)
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    mask = (s > 0) & (s >= rcond * s[0])
    safe = torch.where(mask, s, torch.ones_like(s))
    s_inv = torch.where(mask, 1 / safe, torch.zeros_like(s))[:, None]
    sol = vh.transpose(-1, -2).conj() @ (s_inv * (u.transpose(-1, -2).conj() @ b))
    resid = torch.linalg.vector_norm(b - a @ sol, dim=0) ** 2
    return (sol.reshape(-1) if vec else sol), resid, mask.sum(), s


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    a = to_inexact(inputs("cov", x))
    return torch.cov(a if rowvar or a.dim() < 2 else a.T, correction=1 if ddof else 0)


def corrcoef(x, rowvar=True, name=None):
    a = to_inexact(inputs("corrcoef", x))
    return torch.corrcoef(a if rowvar or a.dim() < 2 else a.T)


def histogram(input, bins=100, min=0, max=0, name=None):
    """Counts of ``bins`` equal bins over [min, max] (the data's range when
    both are 0; the last bin closed), int64."""
    a = t_(input).detach().to(torch.float64)
    if min == 0 and max == 0:
        min, max = float(a.min()), float(a.max())
    return torch.histc(a, bins=bins, min=min, max=max).to(torch.int64)


def bincount(x, weights=None, minlength=0, name=None):
    x = t_(x)
    w = None if weights is None else t_(weights, x)
    out = torch.bincount(x, weights=w, minlength=minlength)
    return out.to(w.dtype) if w is not None else out


def multi_dot(x, name=None):
    return torch.linalg.multi_dot(operands("multi_dot", *x, tensors=True))


def cholesky_solve(x, y, upper=False, name=None):
    """Solve A out = x given y, the Cholesky factor of A."""
    b, f = operands("cholesky_solve", x, y, tensors=True)
    # only the factor's triangle is read (and gets a gradient), as in the reference
    f = torch.triu(f) if upper else torch.tril(f)
    return torch.cholesky_solve(b, f, upper=upper)


def lu_unpack(x, y, unpack_ludata=True, unpack_pivots=True, name=None):
    """Split the combined LU data and pivots of ``lu`` into P, L, U."""
    a = t_(x)
    P, L, U = torch.lu_unpack(a, t_(y, a).to(torch.int32))
    outs = []
    if unpack_pivots:
        outs.append(P)
    if unpack_ludata:
        outs.extend([L, U])
    return tuple(outs)


def cond(x, p=None, name=None):
    return torch.linalg.cond(to_inexact(inputs("cond", x)), p)


inv = inverse  # paddle.linalg.inv alias

__all__ = public(globals())
