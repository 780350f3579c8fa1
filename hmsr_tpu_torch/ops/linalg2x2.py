"""Closed-form 2x2 linear algebra on component tensors (twin of
:mod:`hmsr_tpu.ops.linalg2x2`)."""

import torch

from ..utils.types import EPSILON_DIV


def invert_2x2(m00, m01, m10, m11, eps=EPSILON_DIV):
    """Analytic 2x2 inverse; the identity where |det| <= eps."""
    det = m00 * m11 - m01 * m10
    ok = torch.abs(det) > eps
    det_i = torch.where(ok, 1.0 / torch.where(ok, det, torch.ones_like(det)),
                        torch.ones_like(det))
    one, zero = torch.ones_like(det), torch.zeros_like(det)
    i00 = torch.where(ok, m11 * det_i, one)
    i01 = torch.where(ok, -m01 * det_i, zero)
    i10 = torch.where(ok, -m10 * det_i, zero)
    i11 = torch.where(ok, m00 * det_i, one)
    return i00, i01, i10, i11


def _real_polyroots_2(b, c):
    """Real roots of ``X^2 + b X + c``, larger magnitude first."""
    delta = torch.clamp(b * b - 4.0 * c, min=0.0)
    sq = torch.sqrt(delta)
    r1 = (-b + sq) / 2.0
    r2 = (-b - sq) / 2.0
    big_first = torch.abs(r1) >= torch.abs(r2)
    return torch.where(big_first, r1, r2), torch.where(big_first, r2, r1)


def eigen_2x2(m00, m01, m10, m11):
    """Eigenvalues (|l1| >= |l2|) and unit eigenvectors of a symmetric 2x2,
    with the reference's axis-aligned and identity special cases."""
    l1, l2 = _real_polyroots_2(-(m00 + m11), m00 * m11 - m01 * m10)

    v0 = m00 + m01 - l2
    v1 = m10 + m11 - l2

    norm = torch.sqrt(v0 * v0 + v1 * v1)
    safe_norm = torch.where(norm > 0, norm, torch.ones_like(norm))
    n0 = v0 / safe_norm
    n1 = v1 / safe_norm
    sign = torch.sign(n0) + (n0 == 0).to(n0.dtype)  # copysign(1, x), +0 -> +1
    e1_0, e1_1 = n0, n1
    e2_0, e2_1 = -n1 * sign, torch.abs(n0)

    one, zero = torch.ones_like(n0), torch.zeros_like(n0)
    zero0 = v0 == 0
    zero1 = ~zero0 & (v1 == 0)
    e1_0 = torch.where(zero0, zero, torch.where(zero1, one, e1_0))
    e1_1 = torch.where(zero0, one, torch.where(zero1, zero, e1_1))
    e2_0 = torch.where(zero0, one, torch.where(zero1, zero, e2_0))
    e2_1 = torch.where(zero0, zero, torch.where(zero1, one, e2_1))

    ident = (m01 == 0) & (m00 == m11)
    e1_0 = torch.where(ident, one, e1_0)
    e1_1 = torch.where(ident, zero, e1_1)
    e2_0 = torch.where(ident, zero, e2_0)
    e2_1 = torch.where(ident, one, e2_1)

    return (l1, l2), (e1_0, e1_1), (e2_0, e2_1)
