"""The extended linalg ops of the port: ``linalg_gemm``, ``trmm``,
``trsm``, ``potri``, ``gelqf``, ``syevd``, ``sumlogdiag``,
``extractdiag`` and ``makediag`` (``mxnet_tpu/ops/linalg_extra.py``;
reference src/operator/tensor/la_op.cc), batched over leading dims.

``gelqf`` (the QR of the transpose) and ``syevd`` have a sign and, for
equal eigenvalues, an order freedom: the card's cuSOLVER may choose
another sign of a row than the CPU's LAPACK. Both factorisations hold
``A = L Q`` and ``A = U^T diag(l) U`` with orthonormal rows on every
device (ROADMAP §C).
"""
from __future__ import annotations

import torch

from ..base import Params, param_field
from .registry import register_op


class GemmParam(Params):
    transpose_a = param_field(bool, default=False)
    transpose_b = param_field(bool, default=False)
    alpha = param_field(float, default=1.0)
    beta = param_field(float, default=1.0)
    axis = param_field(int, default=-2)


def _t(x, do):
    return x.transpose(-1, -2) if do else x


@register_op("linalg_gemm", param_cls=GemmParam, input_names=("A", "B", "C"))
def _linalg_gemm(params, a, b, c):
    """alpha * op(A) op(B) + beta * C; ``axis`` names the rows' axis."""
    axis = params.axis
    if axis != -2:
        a, b, c = (torch.movedim(x, axis, -2) for x in (a, b, c))
    out = params.alpha * torch.matmul(_t(a, params.transpose_a),
                                      _t(b, params.transpose_b))
    out = out + params.beta * c
    if axis != -2:
        out = torch.movedim(out, -2, axis)
    return out


class TriParam(Params):
    transpose = param_field(bool, default=False)
    rightside = param_field(bool, default=False)
    lower = param_field(bool, default=True)
    alpha = param_field(float, default=1.0)


@register_op("linalg_trmm", param_cls=TriParam, input_names=("A", "B"))
def _linalg_trmm(params, a, b):
    tri = torch.tril(a) if params.lower else torch.triu(a)
    tri = _t(tri, params.transpose)
    out = torch.matmul(b, tri) if params.rightside else torch.matmul(tri, b)
    return params.alpha * out


@register_op("linalg_trsm", param_cls=TriParam, input_names=("A", "B"))
def _linalg_trsm(params, a, b):
    """op(A) X = alpha B (or X op(A) = alpha B), A triangular."""
    lower = params.lower != params.transpose
    a_eff = _t(a, params.transpose)
    a_eff = torch.tril(a_eff) if lower else torch.triu(a_eff)
    return torch.linalg.solve_triangular(a_eff, params.alpha * b,
                                         upper=not lower,
                                         left=not params.rightside)


@register_op("linalg_potri", input_names=("A",))
def _linalg_potri(params, a):
    """A^{-1} from its Cholesky factor L (A = L L^T)."""
    eye = torch.eye(a.shape[-1], dtype=a.dtype,
                    device=a.device).expand(a.shape)
    linv = torch.linalg.solve_triangular(torch.tril(a), eye, upper=False)
    return torch.matmul(_t(linv, True), linv)


@register_op("linalg_gelqf", input_names=("A",), num_outputs=2,
             output_names=("Q", "L"))
def _linalg_gelqf(params, a):
    """A = L Q, Q's rows orthonormal, through the QR of A^T; returns (Q,
    L), the reference's order."""
    q, r = torch.linalg.qr(_t(a, True))
    return _t(q, True), _t(r, True)


@register_op("linalg_syevd", input_names=("A",), num_outputs=2)
def _linalg_syevd(params, a):
    """A = U^T diag(l) U for symmetric A: returns (U, l), l ascending."""
    w, v = torch.linalg.eigh(a)
    return _t(v, True), w


@register_op("linalg_sumlogdiag", input_names=("A",))
def _linalg_sumlogdiag(params, a):
    return torch.log(torch.diagonal(a, dim1=-2, dim2=-1)).sum(dim=-1)


class DiagParam(Params):
    offset = param_field(int, default=0)


@register_op("linalg_extractdiag", param_cls=DiagParam, input_names=("A",))
def _linalg_extractdiag(params, a):
    return torch.diagonal(a, offset=params.offset, dim1=-2, dim2=-1)


@register_op("linalg_makediag", param_cls=DiagParam, input_names=("A",))
def _linalg_makediag(params, a):
    return torch.diag_embed(a, offset=params.offset)
