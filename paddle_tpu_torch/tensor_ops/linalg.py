"""Linear algebra — the port of ``paddle_tpu/tensor_ops/linalg.py``
(``paddle.linalg``), over ``torch.linalg``. Conventions kept from the
reference: ``lu`` returns Paddle's 1-based int32 pivots (and pivot=False
is refused: the factorisation always pivots), ``slogdet`` stacks sign and
log-determinant, ``cross``'s default axis is the first of size 3,
``histogram`` counts int64 over ``[min, max]`` (the data's range when
both are 0), ``eigh`` reads the one triangle ``UPLO`` names."""
from __future__ import annotations

import torch

from ..amp import amp_state, maybe_cast_inputs
from ..core.tensor import as_port, as_tensor_arg

__all__ = ["norm", "bmm", "mm", "histogram", "mv", "matrix_power",
           "cholesky", "svd", "pinv", "solve", "triangular_solve", "qr",
           "eig", "eigvals", "matrix_rank", "det", "slogdet", "inv",
           "cross", "dist", "cond", "eigh", "eigvalsh", "lu", "lstsq",
           "cholesky_solve", "cov", "corrcoef", "inverse", "multi_dot",
           "lu_unpack"]

_t = as_tensor_arg


def norm(x, p="fro", axis=None, keepdim=False, name=None):
    a = _t(x)
    if amp_state() is not None:
        (a,) = maybe_cast_inputs("norm", [a])
    if p == "fro" and axis is None:
        return as_port(torch.sqrt(torch.sum(a * a)))
    if axis is None:
        return as_port(torch.linalg.vector_norm(
            a.reshape(-1), ord=p, keepdim=keepdim))
    if isinstance(axis, (list, tuple)) and len(axis) == 2:
        return as_port(torch.linalg.matrix_norm(
            a, ord=p, dim=tuple(axis), keepdim=keepdim))
    ax = axis[0] if isinstance(axis, (list, tuple)) else axis
    return as_port(torch.linalg.vector_norm(
        a, ord=2 if p == "fro" else p, dim=ax, keepdim=keepdim))


def _product(op_name, a, b):
    a, b = _t(a), _t(b)
    if amp_state() is not None:
        a, b = maybe_cast_inputs(op_name, [a, b])
    return as_port(torch.matmul(a, b))


def bmm(x, y, name=None):
    return _product("bmm", x, y)


def mm(input, mat2, name=None):
    return _product("mm", input, mat2)


def mv(x, vec, name=None):
    return as_port(torch.matmul(_t(x), _t(vec)))


def histogram(input, bins=100, min=0, max=0, name=None):
    a = _t(input).detach()
    lo, hi = (min, max) if (min != 0 or max != 0) else (
        a.min().item(), a.max().item())
    counts = torch.histc(a.double(), bins=int(bins), min=float(lo),
                         max=float(hi))
    return as_port(counts.to(torch.int64))


def matrix_power(x, n, name=None):
    return as_port(torch.linalg.matrix_power(_t(x), n))


def cholesky(x, upper=False, name=None):
    return as_port(torch.linalg.cholesky(_t(x), upper=upper))


def svd(x, full_matrices=False, name=None):
    u, s, vh = torch.linalg.svd(_t(x), full_matrices=full_matrices)
    return as_port(u), as_port(s), as_port(vh)


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return as_port(torch.linalg.pinv(_t(x), rtol=rcond, hermitian=hermitian))


def solve(x, y, name=None):
    return as_port(torch.linalg.solve(_t(x), _t(y)))


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    a, b = _t(x), _t(y)
    if transpose:
        a, upper = a.transpose(-1, -2), not upper
    return as_port(torch.linalg.solve_triangular(
        a, b, upper=upper, unitriangular=unitriangular))


def qr(x, mode="reduced", name=None):
    q, r = torch.linalg.qr(_t(x), mode=mode)
    return as_port(r) if mode == "r" else (as_port(q), as_port(r))


def eig(x, name=None):
    w, v = torch.linalg.eig(_t(x).detach())
    return as_port(w), as_port(v)


def eigvals(x, name=None):
    return as_port(torch.linalg.eigvals(_t(x).detach()))


def matrix_rank(x, tol=None, hermitian=False, name=None):
    a = _t(x).detach()
    r = torch.linalg.matrix_rank(a, hermitian=hermitian) if tol is None \
        else torch.linalg.matrix_rank(a, atol=float(tol), rtol=0.0,
                                      hermitian=hermitian)
    return as_port(r.to(torch.int64))


def det(x, name=None):
    return as_port(torch.linalg.det(_t(x)))


def slogdet(x, name=None):
    sign, logdet = torch.linalg.slogdet(_t(x))
    return as_port(torch.stack([sign, logdet]))


def inv(x, name=None):
    return as_port(torch.linalg.inv(_t(x)))


def inverse(x, name=None):
    return inv(x)


def cross(x, y, axis=9, name=None):
    a, b = _t(x), _t(y)
    ax = axis if axis != 9 else next(i for i, s in enumerate(a.shape)
                                     if s == 3)
    return as_port(torch.linalg.cross(a, b, dim=ax))


def dist(x, y, p=2, name=None):
    return as_port(torch.linalg.vector_norm((_t(x) - _t(y)).reshape(-1),
                                            ord=p))


def cond(x, p=None, name=None):
    return as_port(torch.linalg.cond(_t(x).detach(), p=p))


def eigh(x, UPLO="L", name=None):
    w, v = torch.linalg.eigh(_t(x), UPLO=UPLO)
    return as_port(w), as_port(v)


def eigvalsh(x, UPLO="L", name=None):
    return as_port(torch.linalg.eigvalsh(_t(x), UPLO=UPLO))


def lu(x, pivot=True, get_infos=False, name=None):
    """``(LU, pivots[, infos])``: the packed factors and 1-based int32
    row swaps."""
    if not pivot:
        raise NotImplementedError(
            "lu(pivot=False): the factorisation is always partially "
            "pivoted; a pivoted result under the no-pivot contract would "
            "be silently wrong")
    lu_, piv, info = torch.linalg.lu_factor_ex(_t(x))
    out = (as_port(lu_), as_port(piv.to(torch.int32)))
    return out + (as_port(info.to(torch.int32)),) if get_infos else out


def lu_unpack(lu_data, lu_pivots, unpack_ludata=True, unpack_pivots=True,
              name=None):
    """``(P, L, U)`` with ``A = P @ L @ U``; a disabled part is None."""
    p, lo, up = torch.lu_unpack(_t(lu_data), _t(lu_pivots).to(torch.int32),
                                unpack_data=unpack_ludata,
                                unpack_pivots=unpack_pivots)
    return (as_port(p) if unpack_pivots else None,
            as_port(lo) if unpack_ludata else None,
            as_port(up) if unpack_ludata else None)


def lstsq(x, y, rcond=None, driver=None, name=None):
    """``(solution, residuals, rank, singular_values)``: residuals the
    squared column norms of ``y - x @ solution`` when ``x`` is tall and of
    full rank (else empty), rank int32, as the reference."""
    a, b = _t(x), _t(y)
    m, n = a.shape[-2], a.shape[-1]
    sv = torch.linalg.svdvals(a)
    eps = torch.finfo(a.dtype).eps
    cut = (rcond if rcond is not None else eps * max(m, n)) * sv[..., :1]
    rank = (sv > cut).sum(-1).to(torch.int32)
    sol = torch.linalg.pinv(a, rtol=cut[..., 0] / sv[..., 0]) @ b \
        if a.device.type != "cpu" else torch.linalg.lstsq(
            a, b, rcond=rcond, driver="gelsd").solution
    if m > n and int(rank.min()) == n:
        res = torch.sum((b - a @ sol) ** 2, dim=-2)
    else:
        res = torch.zeros((0,), dtype=a.dtype, device=a.device)
    return as_port(sol), as_port(res), as_port(rank), as_port(sv)


def cholesky_solve(x, y, upper=False, name=None):
    """Solve ``A X = x`` given ``y``, the Cholesky factor of ``A``; only
    its triangle is read (and takes a gradient)."""
    c = _t(y)
    c = torch.triu(c) if upper else torch.tril(c)
    return as_port(torch.cholesky_solve(_t(x), c, upper=upper))


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    a = _t(x)
    a = a if rowvar or a.dim() < 2 else a.t()
    fw = None if fweights is None else _t(fweights, like=a).detach()
    aw = None if aweights is None else _t(aweights, like=a).detach()
    return as_port(torch.cov(a, correction=1 if ddof else 0, fweights=fw,
                             aweights=aw))


def corrcoef(x, rowvar=True, name=None):
    a = _t(x)
    return as_port(torch.corrcoef(a if rowvar or a.dim() < 2 else a.t()))


def multi_dot(tensors, name=None):
    return as_port(torch.linalg.multi_dot([_t(t) for t in tensors]))
