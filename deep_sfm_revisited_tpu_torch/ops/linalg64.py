"""Small-matrix linear algebra from elementary ops (port of `ops/linalg64.py`).

The H100 has native float64 and `torch.linalg`, but the five-point
solver's candidates depend on the exact algorithms: the Householder
nullspace basis fixes the coefficients of the degree-10 polynomial, and
the pivot-free equilibrated Gauss-Jordan fixes the float32 fast path. So
these are the JAX package's algorithms, op for op, batched over leading
dims.
"""

from __future__ import annotations

import torch


def gauss_solve(A: torch.Tensor, B: torch.Tensor, pivot: bool = True) -> torch.Tensor:
    """Solve A X = B by Gauss-Jordan. A (..., n, n), B (..., n, m).

    `pivot=True`: partial pivoting (ties to the lower row, as jnp.argmax).
    `pivot=False`: divide each row by its max |entry| once, then eliminate
    without pivoting. A zero pivot is replaced by 1 so the batch stays
    finite (garbage, not inf/nan, for exactly singular systems).
    """
    n = A.shape[-1]
    M = torch.cat([A, B], dim=-1)
    if not pivot:
        scale = torch.amax(torch.abs(A), dim=-1, keepdim=True)
        M = M / torch.clamp(scale, min=1e-30)
        for k in range(n):
            pivval = M[..., k, k]
            safe = torch.where(torch.abs(pivval) > 0, pivval, torch.ones_like(pivval))
            row_k = M[..., k, :] / safe[..., None]
            M = M.clone()
            M[..., k, :] = row_k
            factor = M[..., :, k].clone()
            factor[..., k] = 0.0
            M = M - factor[..., :, None] * row_k[..., None, :]
        return M[..., :, n:]
    rows = torch.arange(n, device=A.device)
    neg_inf = torch.tensor(-float("inf"), dtype=A.dtype, device=A.device)
    for k in range(n):
        col = torch.abs(M[..., :, k])
        col = torch.where(rows >= k, col, neg_inf)
        piv = torch.argmax(col, dim=-1)  # (...,)
        row_k = M[..., k, :]
        row_piv = torch.gather(
            M, -2, piv[..., None, None].expand(*piv.shape, 1, M.shape[-1])
        )[..., 0, :]
        is_piv = rows[:, None] == piv[..., None, None]  # (..., n, 1)
        M = M.clone()
        M[..., k, :] = row_piv
        M = torch.where(is_piv & (rows[:, None] != k), row_k[..., None, :], M)
        pivval = M[..., k, k]
        safe = torch.where(torch.abs(pivval) > 0, pivval, torch.ones_like(pivval))
        M[..., k, :] = M[..., k, :] / safe[..., None]
        factor = M[..., :, k].clone()
        factor[..., k] = 0.0
        M = M - factor[..., :, None] * M[..., k, :][..., None, :]
    return M[..., :, n:]


def nullspace(A: torch.Tensor, null_dim: int) -> torch.Tensor:
    """Orthonormal right-nullspace basis via Householder QR of A^T.

    A (..., r, c) with r + null_dim == c -> (..., null_dim, c).
    """
    M = torch.swapaxes(A, -1, -2)  # (..., c, r)
    c, r = M.shape[-2], M.shape[-1]
    if r + null_dim != c:
        raise ValueError(f"nullspace: {r} rows + {null_dim} != {c} columns")
    idx = torch.arange(c, device=A.device)
    vs = []
    for k in range(r):
        x = M[..., :, k]
        x = torch.where(idx >= k, x, torch.zeros_like(x))
        sigma = torch.linalg.vector_norm(x, dim=-1)
        sign = torch.where(x[..., k] >= 0, 1.0, -1.0).to(A.dtype)
        v = x.clone()
        v[..., k] = v[..., k] + sign * sigma
        vnorm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
        v = v / torch.where(vnorm > 0, vnorm, torch.ones_like(vnorm))
        vs.append(v)
        M = M - 2.0 * v[..., :, None] * torch.einsum("...c,...cr->...r", v, M)[..., None, :]
    N = torch.zeros(A.shape[:-2] + (c, null_dim), dtype=A.dtype, device=A.device)
    N = N + torch.eye(c, dtype=A.dtype, device=A.device)[:, r:]
    for v in reversed(vs):
        N = N - 2.0 * v[..., :, None] * torch.einsum("...c,...cm->...m", v, N)[..., None, :]
    return torch.swapaxes(N, -1, -2)


def eigh3x3(S: torch.Tensor, sweeps: int = 8):
    """Symmetric 3x3 eigendecomposition by cyclic Jacobi rotations.

    S (..., 3, 3) -> (w ascending (..., 3), V (..., 3, 3) columns).
    """
    A = S
    eye = torch.eye(3, dtype=S.dtype, device=S.device)
    V = torch.zeros_like(S) + eye
    for _ in range(sweeps):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            app, aqq, apq = A[..., p, p], A[..., q, q], A[..., p, q]
            nonzero = torch.abs(apq) > 1e-30
            tau = (aqq - app) / (2.0 * torch.where(nonzero, apq, torch.ones_like(apq)))
            big = torch.abs(tau) > 1e8
            tau_safe = torch.where(big, torch.ones_like(tau), tau)
            t_small = torch.where(tau_safe >= 0, 1.0, -1.0).to(S.dtype) / (
                torch.abs(tau_safe) + torch.sqrt(1.0 + tau_safe * tau_safe))
            t = torch.where(big, 1.0 / (2.0 * torch.where(big, tau, torch.ones_like(tau))),
                            t_small)
            c = 1.0 / torch.sqrt(1.0 + t * t)
            s = t * c
            c = torch.where(nonzero, c, torch.ones_like(c))
            s = torch.where(nonzero, s, torch.zeros_like(s))
            G = torch.zeros_like(A) + eye
            G[..., p, p] = c
            G[..., q, q] = c
            G[..., p, q] = s
            G[..., q, p] = -s
            A = torch.swapaxes(G, -1, -2) @ A @ G
            V = V @ G
    w = torch.stack([A[..., 0, 0], A[..., 1, 1], A[..., 2, 2]], dim=-1)
    for i, j in ((0, 1), (1, 2), (0, 1)):
        swap = w[..., i] > w[..., j]
        wi, wj = w[..., i].clone(), w[..., j].clone()
        w = w.clone()
        w[..., i] = torch.where(swap, wj, wi)
        w[..., j] = torch.where(swap, wi, wj)
        vi, vj = V[..., :, i].clone(), V[..., :, j].clone()
        V = V.clone()
        V[..., :, i] = torch.where(swap[..., None], vj, vi)
        V[..., :, j] = torch.where(swap[..., None], vi, vj)
    return w, V


def det3x3(M: torch.Tensor) -> torch.Tensor:
    """Explicit 3x3 determinant."""
    return (
        M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 1])
        - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 0])
        + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1] - M[..., 1, 1] * M[..., 2, 0])
    )
