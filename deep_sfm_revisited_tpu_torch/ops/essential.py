"""Batched essential-matrix engine (port of `ops/essential.py`).

Five-point candidates (Nister, by evaluation-interpolation of the ten cubic
constraints, Gauss-Jordan reduction and a degree-10 root search), Sampson
scoring, the two-stage RANSAC vote, the robust IRLS polish on the (U, V)
manifold, and the cheirality decomposition -- the JAX algorithms op for op,
as batched eager PyTorch in float64 (candidates in float32 on the fast
path), with the random minimal samples injectable.

Conventions as in the JAX package: correspondences are K^-1-normalized
points, x1 in the reference view and x2 in the target view; E = [t]_x R
with X2 = R X1 + t, so x2^T E x1 = 0.

Tie-breaking rule (fixed here, recorded in ROADMAP.md): every selection
takes the lowest index among equals, as `jnp.argmax` and `lax.top_k` do --
`torch.argmax`/`argmin` for the first extremum and a stable descending
sort in place of `top_k`.
"""

from __future__ import annotations

import numpy as np
import torch

from deep_sfm_revisited_tpu_torch.ops.linalg64 import det3x3, gauss_solve, nullspace
from deep_sfm_revisited_tpu_torch.ops.polyroots import real_roots
from deep_sfm_revisited_tpu_torch.ops.rotations import exp_so3, skew

# monomials of degree <= 3 in (x, y, z), in the JAX package's order
_MONOMIALS = [
    (i, j, k)
    for d in range(3, -1, -1)
    for i in range(d, -1, -1)
    for j in range(d - i, -1, -1)
    for k in [d - i - j]
]
_MONO_INDEX = {m: i for i, m in enumerate(_MONOMIALS)}
_COLS_FIRST = [_MONO_INDEX[m] for m in [
    (3, 0, 0), (0, 3, 0), (2, 1, 0), (1, 2, 0), (2, 0, 1),
    (2, 0, 0), (0, 2, 1), (0, 2, 0), (1, 1, 1), (1, 1, 0)]]
_COLS_LAST = [_MONO_INDEX[m] for m in [
    (1, 0, 2), (1, 0, 1), (1, 0, 0), (0, 1, 2), (0, 1, 1),
    (0, 1, 0), (0, 0, 3), (0, 0, 2), (0, 0, 1), (0, 0, 0)]]


def _eval_interp_setup():
    # the same 20 evaluation points (seed 17) as the JAX package
    rng = np.random.RandomState(17)
    pts = rng.randn(20, 3)
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    pts *= np.linspace(0.6, 1.6, 20)[:, None]
    V = np.stack([np.prod(pts ** np.asarray(m), axis=1) for m in _MONOMIALS], axis=1)
    coef = np.concatenate([pts, np.ones((20, 1))], axis=1)
    return coef, np.linalg.inv(V).T


_EVAL_COEF, _VINV_T = _eval_interp_setup()
_W = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
_D = np.diag([1.0, 1.0, 0.0])


def _const(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def _homog(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def _polymul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Coefficient convolution, lowest power first."""
    n, m = a.shape[-1], b.shape[-1]
    shape = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1]) + (n + m - 1,)
    out = torch.zeros(shape, dtype=a.dtype, device=a.device)
    for i in range(n):
        out[..., i:i + m] = out[..., i:i + m] + a[..., i:i + 1] * b
    return out


def _constraint_values(Ep: torch.Tensor) -> torch.Tensor:
    """[det(E), G_00..G_22] at stacked points, Ep (..., 3, 3, P) -> (..., 10, P),
    G = 2 E E^T E - tr(E E^T) E, expanded elementwise as in JAX."""
    e = [[Ep[..., i, j, :] for j in range(3)] for i in range(3)]
    s = [[None] * 3 for _ in range(3)]
    for i in range(3):
        for j in range(i, 3):
            s[i][j] = s[j][i] = e[i][0] * e[j][0] + e[i][1] * e[j][1] + e[i][2] * e[j][2]
    tr = s[0][0] + s[1][1] + s[2][2]
    G = [2.0 * (s[i][0] * e[0][j] + s[i][1] * e[1][j] + s[i][2] * e[2][j]) - tr * e[i][j]
         for i in range(3) for j in range(3)]
    det = (e[0][0] * (e[1][1] * e[2][2] - e[1][2] * e[2][1])
           - e[0][1] * (e[1][0] * e[2][2] - e[1][2] * e[2][0])
           + e[0][2] * (e[1][0] * e[2][1] - e[1][1] * e[2][0]))
    return torch.stack([det] + G, dim=-2)


def _constraint_matrix(EB: torch.Tensor) -> torch.Tensor:
    """The ten cubic constraints as (..., 10, 20) monomial coefficients."""
    coef = _const(_EVAL_COEF, EB)
    vinv_t = _const(_VINV_T, EB)
    Ep = torch.einsum("pa,...aij->...ijp", coef, EB)
    return _constraint_values(Ep) @ vinv_t


def five_point_candidates(x1: torch.Tensor, x2: torch.Tensor, fast: bool = False):
    """E candidates from 5 normalized correspondences x1, x2 (..., 5, 2).

    Returns (E (..., 10, 3, 3) Frobenius-normalized, valid (..., 10)).
    `fast=True`: pivot-free equilibrated Gauss-Jordan and a 12-bisection /
    5-Newton root schedule (the RANSAC candidate path, JAX `:255-371`).
    """
    dtype = x1.dtype
    q1, q2 = _homog(x1), _homog(x2)
    A = torch.einsum("...ni,...nj->...nij", q2, q1).reshape(q1.shape[:-1] + (9,))
    basis = nullspace(A, null_dim=4)                        # (..., 4, 9)
    EB = basis.reshape(basis.shape[:-1] + (3, 3))           # (..., 4, 3, 3)

    M = _constraint_matrix(EB)
    L = M[..., _COLS_FIRST]
    R = M[..., _COLS_LAST]
    Rb = gauss_solve(L, R, pivot=not fast)                  # (..., 10, 10)

    def split(row):
        # row over [xz^2, xz, x, yz^2, yz, y, z^3, z^2, z, 1]
        px = row[..., [2, 1, 0]]
        py = row[..., [5, 4, 3]]
        p1 = row[..., [9, 8, 7, 6]]
        return px, py, p1

    def minus_z(pa, pb):
        n = pa.shape[-1]
        out = torch.zeros(pa.shape[:-1] + (n + 1,), dtype=pa.dtype, device=pa.device)
        out[..., :n] = out[..., :n] + pa
        out[..., 1:n + 1] = out[..., 1:n + 1] - pb
        return out

    ex, ey, e1 = split(Rb[..., 4, :])
    fx, fy, f1 = split(Rb[..., 5, :])
    gx, gy, g1 = split(Rb[..., 6, :])
    hx, hy, h1 = split(Rb[..., 7, :])
    ix, iy, i1 = split(Rb[..., 8, :])
    jx, jy, j1 = split(Rb[..., 9, :])
    kx, ky, k1 = minus_z(ex, fx), minus_z(ey, fy), minus_z(e1, f1)
    lx, ly, l1 = minus_z(gx, hx), minus_z(gy, hy), minus_z(g1, h1)
    mx, my, m1 = minus_z(ix, jx), minus_z(iy, jy), minus_z(i1, j1)

    p_det = (_polymul(kx, _polymul(ly, m1) - _polymul(l1, my))
             - _polymul(ky, _polymul(lx, m1) - _polymul(l1, mx))
             + _polymul(k1, _polymul(lx, my) - _polymul(ly, mx)))
    if fast:
        z, valid = real_roots(p_det, max_roots=10, bisect_iters=12, newton_iters=5)
    else:
        z, valid = real_roots(p_det, max_roots=10)

    def poly_eval(cf, zz):
        out = torch.zeros_like(zz)
        for k in range(cf.shape[-1] - 1, -1, -1):
            out = out * zz + cf[..., k, None]
        return out

    B = torch.stack([
        torch.stack([poly_eval(kx, z), poly_eval(ky, z), poly_eval(k1, z)], -1),
        torch.stack([poly_eval(lx, z), poly_eval(ly, z), poly_eval(l1, z)], -1),
        torch.stack([poly_eval(mx, z), poly_eval(my, z), poly_eval(m1, z)], -1),
    ], dim=-2)                                               # (..., 10, 3, 3)
    crosses = torch.stack([
        torch.linalg.cross(B[..., 0, :], B[..., 1, :]),
        torch.linalg.cross(B[..., 0, :], B[..., 2, :]),
        torch.linalg.cross(B[..., 1, :], B[..., 2, :]),
    ], dim=-2)
    best = torch.argmax(torch.abs(crosses[..., 2]), dim=-1)
    nvec = torch.gather(crosses, -2, best[..., None, None].expand(*best.shape, 1, 3))[..., 0, :]
    w3 = nvec[..., 2]
    ok = torch.abs(w3) > 1e-14
    w3 = torch.where(ok, w3, torch.ones_like(w3))
    x = nvec[..., 0] / w3
    y = nvec[..., 1] / w3
    valid = valid & ok

    coeff = torch.stack([x, y, z, torch.ones_like(z)], dim=-1)      # (..., 10, 4)
    E = torch.einsum("...ra,...aij->...rij", coeff, EB)
    nrm = torch.linalg.vector_norm(E.reshape(E.shape[:-2] + (9,)), dim=-1)
    E = E / torch.clamp(nrm, min=1e-30)[..., None, None]
    return E, valid


def essential_from_rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """E = [t]_x R for X2 = R X1 + t."""
    return skew(t) @ R


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-30)


def _uv_from_essential(E: torch.Tensor):
    """Proper rotations U, V with E ~ U diag(1,1,0) V^T, closed form from
    cross products (JAX `_uv_from_essential`, `:384-434`)."""
    c0, c1, c2 = E[..., :, 0], E[..., :, 1], E[..., :, 2]
    cands = torch.stack([torch.linalg.cross(c0, c1), torch.linalg.cross(c0, c2),
                         torch.linalg.cross(c1, c2)], dim=-2)
    pick = torch.argmax(torch.linalg.vector_norm(cands, dim=-1), dim=-1)
    u3 = torch.gather(cands, -2, pick[..., None, None].expand(*pick.shape, 1, 3))[..., 0, :]
    u3 = _unit(u3)
    axis = torch.argmin(torch.abs(u3), dim=-1)
    e_min = torch.nn.functional.one_hot(axis, 3).to(E.dtype)
    u1 = _unit(torch.linalg.cross(u3, e_min))
    u2 = torch.linalg.cross(u3, u1)
    Et = torch.swapaxes(E, -1, -2)
    v1 = _unit(torch.einsum("...ij,...j->...i", Et, u1))
    v2 = torch.einsum("...ij,...j->...i", Et, u2)
    v2 = _unit(v2 - torch.sum(v1 * v2, dim=-1, keepdim=True) * v1)
    v3 = torch.linalg.cross(v1, v2)
    return torch.stack([u1, u2, u3], dim=-1), torch.stack([v1, v2, v3], dim=-1)


def _depths_for_config(R, t, q1, q2):
    a = torch.einsum("...ij,...nj->...ni", R, q1)
    cx = q2[..., 0] * a[..., 2] - a[..., 0]
    cy = q2[..., 1] * a[..., 2] - a[..., 1]
    dx = t[..., 0, None] - q2[..., 0] * t[..., 2, None]
    dy = t[..., 1, None] - q2[..., 1] * t[..., 2, None]
    z1 = (cx * dx + cy * dy) / (cx * cx + cy * cy + 1e-30)
    z2 = a[..., 2] * z1 + t[..., 2, None]
    return z1, z2


def decompose_essential(E: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor):
    """E (..., 3, 3) -> (P (..., 3, 4) with unit t, cheirality vote count),
    choosing among the four (R, t) by positive depths over all N points."""
    U, V = _uv_from_essential(E)
    W = _const(_W, E)
    Vt = torch.swapaxes(V, -1, -2)
    Ra = U @ W @ Vt
    Rb = U @ W.T @ Vt
    Ra = Ra * torch.sign(det3x3(Ra))[..., None, None]
    Rb = Rb * torch.sign(det3x3(Rb))[..., None, None]
    tu = U[..., :, 2]
    q1, q2 = _homog(x1), _homog(x2)

    def votes(R, t):
        z1, z2 = _depths_for_config(R, t, q1, q2)
        return torch.sum((z1 > 0) & (z2 > 0), dim=-1)

    configs = [(Ra, tu), (Ra, -tu), (Rb, tu), (Rb, -tu)]
    counts = torch.stack([votes(R, t) for R, t in configs], dim=-1)
    best = torch.argmax(counts, dim=-1)
    Rs = torch.stack([c[0] for c in configs], dim=-3)
    ts = torch.stack([c[1] for c in configs], dim=-2)
    R = torch.gather(Rs, -3, best[..., None, None, None].expand(*best.shape, 1, 3, 3))[..., 0, :, :]
    t = torch.gather(ts, -2, best[..., None, None].expand(*best.shape, 1, 3))[..., 0, :]
    P = torch.cat([R, t[..., None]], dim=-1)
    return P, torch.amax(counts, dim=-1)


def sampson_error(E: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Unsquared first-order Sampson distance, E (..., 3, 3), x (..., N, 2) -> (..., N)."""
    return torch.abs(_signed_sampson(E, _homog(x1), _homog(x2)))


def _signed_sampson(E, q1, q2):
    Eq1 = torch.einsum("...ij,...nj->...ni", E, q1)
    Etq2 = torch.einsum("...ji,...nj->...ni", E, q2)
    num = torch.sum(q2 * Eq1, dim=-1)
    den = torch.sqrt(Eq1[..., 0] ** 2 + Eq1[..., 1] ** 2 + Etq2[..., 0] ** 2
                     + Etq2[..., 1] ** 2 + 1e-30)
    return num / den


def _sampson_jacobian(E, dE, q1, q2):
    """d(signed Sampson)/d(theta) for E (B,3,3) moving along dE (B,6,3,3),
    at q (B,N,3) -> (B,N,6). Analytic form of JAX's `jax.jacfwd(resid)`:
    r = num / den, dr = dnum / den - num * dden / den^2."""
    Eq1 = torch.einsum("bij,bnj->bni", E, q1)
    Etq2 = torch.einsum("bji,bnj->bni", E, q2)
    num = torch.sum(q2 * Eq1, dim=-1)                        # (B,N)
    den = torch.sqrt(Eq1[..., 0] ** 2 + Eq1[..., 1] ** 2 + Etq2[..., 0] ** 2
                     + Etq2[..., 1] ** 2 + 1e-30)
    dEq1 = torch.einsum("bkij,bnj->bnki", dE, q1)            # (B,N,6,3)
    dEtq2 = torch.einsum("bkji,bnj->bnki", dE, q2)
    dnum = torch.sum(q2[:, :, None] * dEq1, dim=-1)          # (B,N,6)
    dden = (Eq1[..., None, 0] * dEq1[..., 0] + Eq1[..., None, 1] * dEq1[..., 1]
            + Etq2[..., None, 0] * dEtq2[..., 0] + Etq2[..., None, 1] * dEtq2[..., 1]
            ) / den[..., None]
    return dnum / den[..., None] - num[..., None] * dden / (den * den)[..., None]


def _huber(r, delta):
    a = torch.abs(r)
    return torch.where(a <= delta, 0.5 * a * a, delta * (a - 0.5 * delta))


def polish_essential(E0, x1, x2, weights=None, iters: int = 10,
                     huber_delta: float = 1e-3, damping: float = 1e-8,
                     coarse_dtype=None):
    """Huber-IRLS Levenberg-damped Gauss-Newton on E's (U, V) manifold.

    Batched: E0 (B, 3, 3), x1/x2 (B, N, 2), weights (B, N) (the JAX
    function is vmapped over B). `coarse_dtype`: run iters-1 steps in that
    dtype, then one in E0's (JAX `:534-669`, Huber loss only). A step is
    kept only if it lowers the IRLS-weighted Huber cost.
    """
    if coarse_dtype is not None and coarse_dtype != E0.dtype and iters > 1:
        Ec = polish_essential(
            E0.to(coarse_dtype), x1.to(coarse_dtype), x2.to(coarse_dtype),
            None if weights is None else weights.to(coarse_dtype),
            iters=iters - 1, huber_delta=huber_delta, damping=damping)
        return polish_essential(Ec.to(E0.dtype), x1, x2, weights, iters=1,
                                huber_delta=huber_delta, damping=damping)
    dtype = E0.dtype
    q1, q2 = _homog(x1), _homog(x2)
    if weights is None:
        weights = torch.ones(q1.shape[:-1], dtype=dtype, device=E0.device)
    D = _const(_D, E0)
    eye6 = torch.eye(6, dtype=dtype, device=E0.device)
    # directions of dE/dtheta at theta = 0: U S_k D V^T and -U D S_k V^T
    S = skew(torch.eye(3, dtype=dtype, device=E0.device))  # (3,3,3)

    U, V = _uv_from_essential(E0)
    for _ in range(iters):
        E = U @ D @ V.transpose(-1, -2)
        r0 = _signed_sampson(E, q1, q2)
        absr = torch.abs(r0)
        w = weights * torch.where(absr <= huber_delta, torch.ones_like(absr),
                                  huber_delta / torch.clamp(absr, min=1e-30))
        dEu = torch.einsum("bij,kjl,lm,bnm->bkin", U, S, D, V)
        dEv = -torch.einsum("bij,jl,klm,bnm->bkin", U, D, S, V)
        J = _sampson_jacobian(E, torch.cat([dEu, dEv], dim=1), q1, q2)  # (B,N,6)
        Jw = J * w[..., None]
        H = J.transpose(-1, -2) @ Jw + damping * eye6
        g = torch.einsum("bnk,bn->bk", Jw, r0)
        delta = -gauss_solve(H, g[..., None], pivot=False)[..., 0]
        Uc = U @ exp_so3(delta[:, :3])
        Vc = V @ exp_so3(delta[:, 3:])
        r1 = _signed_sampson(Uc @ D @ Vc.transpose(-1, -2), q1, q2)
        good = (torch.sum(w * _huber(r1, huber_delta), dim=-1)
                < torch.sum(w * _huber(r0, huber_delta), dim=-1))
        delta = torch.where(good[:, None], delta, torch.zeros_like(delta))
        U = U @ exp_so3(delta[:, :3])
        V = V @ exp_so3(delta[:, 3:])
    E = U @ D @ V.transpose(-1, -2)
    return E / torch.linalg.vector_norm(E, dim=(-2, -1), keepdim=True)


def ransac_pose(x1, x2, num_hypotheses: int = 512, ransac_iter: int = 5,
                threshold: float = 1e-4, polish: bool = True,
                polish_iters: int = 10, huber_delta: float = 1e-3,
                solve_dtype=None, score_subset: int = 0, score_topk: int = 0,
                sample_idx: torch.Tensor | None = None,
                generator: torch.Generator | None = None):
    """Batched five-point RANSAC (JAX `ransac_pose`, `:679-844`).

    x1, x2 (B, N, 2) or (N, 2) normalized correspondences (float64).
    `sample_idx` (B, H, 5) int: the minimal samples, H = num_hypotheses *
    ransac_iter, uniform with replacement over N; drawn from `generator`
    when not given. Candidates are solved in `solve_dtype` (float32: the
    fast path) and scored in float32; with 0 < score_subset < N and
    0 < score_topk < 10 H the vote is two-stage. Returns dict(E, P,
    inliers, inlier_mask).
    """
    unbatched = x1.dim() == 2
    if unbatched:
        x1, x2 = x1[None], x2[None]
    dtype, dev = x1.dtype, x1.device
    B, N = x1.shape[0], x1.shape[1]
    H = num_hypotheses * ransac_iter
    if sample_idx is None:
        sample_idx = torch.randint(0, N, (B, H, 5), generator=generator, device=dev)
    flat = sample_idx.to(dev).long().reshape(B, H * 5, 1).expand(-1, -1, 2)
    s1 = torch.gather(x1, 1, flat).reshape(B, H, 5, 2)
    s2 = torch.gather(x2, 1, flat).reshape(B, H, 5, 2)

    if solve_dtype is not None and solve_dtype != dtype:
        E, valid = five_point_candidates(s1.to(solve_dtype), s2.to(solve_dtype), fast=True)
        E = E.to(dtype)
    else:
        E, valid = five_point_candidates(s1, s2)
    C = H * 10
    Ef = E.reshape(B, C, 3, 3)
    validf = valid.reshape(B, C)
    minus1 = torch.tensor(-1, device=dev)

    x1_32, x2_32 = x1.to(torch.float32), x2.to(torch.float32)
    if 0 < score_subset < N and 0 < score_topk < C:
        sub = torch.round(torch.linspace(0.0, N - 1.0, score_subset,
                                         dtype=torch.float64, device=dev)).long()
        err_sub = sampson_error(Ef.to(torch.float32), x1_32[:, None, sub],
                                x2_32[:, None, sub])
        counts_sub = torch.where(validf, torch.sum(err_sub < threshold, dim=-1), minus1)
        topk = torch.sort(counts_sub, dim=-1, descending=True, stable=True).indices[:, :score_topk]
        Ef = torch.gather(Ef, 1, topk[:, :, None, None].expand(-1, -1, 3, 3))
        validf = torch.gather(validf, 1, topk)

    err = sampson_error(Ef.to(torch.float32), x1_32[:, None], x2_32[:, None])
    inl = err < threshold
    counts = torch.where(validf, torch.sum(inl, dim=-1), minus1)
    best = torch.argmax(counts, dim=-1)
    E_best = torch.gather(Ef, 1, best[:, None, None, None].expand(-1, 1, 3, 3))[:, 0]
    inlier_mask = torch.gather(inl, 1, best[:, None, None].expand(-1, 1, N))[:, 0]
    best_count = torch.gather(counts, 1, best[:, None])[:, 0]
    n_inl = torch.clamp(best_count, min=0)

    # no valid finite hypothesis (e.g. zero parallax): canonical forward-
    # motion E, so depth downstream stays finite
    fallback = skew(torch.tensor([1.0, 0.0, 0.0], dtype=dtype, device=dev))
    ok = ((best_count >= 0) & torch.all(torch.isfinite(E_best), dim=-1).all(dim=-1))
    E_best = torch.where(ok[:, None, None], E_best, fallback)

    if polish:
        w = inlier_mask.to(dtype)
        enough = (n_inl >= 8)[:, None]
        w = torch.where(enough, w, torch.ones_like(w))
        E_pol = polish_essential(E_best, x1, x2, weights=w, iters=polish_iters,
                                 huber_delta=huber_delta, coarse_dtype=solve_dtype)
        thr32 = torch.tensor(threshold, dtype=torch.float32, device=dev)
        cost0 = torch.sum(torch.minimum(sampson_error(E_best.to(torch.float32), x1_32, x2_32),
                                        thr32), dim=-1)
        cost1 = torch.sum(torch.minimum(sampson_error(E_pol.to(torch.float32), x1_32, x2_32),
                                        thr32), dim=-1)
        better = (cost1 <= cost0) & torch.isfinite(E_pol).all(dim=-1).all(dim=-1)
        E_best = torch.where(better[:, None, None], E_pol, E_best)
        inlier_mask = sampson_error(E_best.to(torch.float32), x1_32, x2_32) < thr32
        n_inl = torch.sum(inlier_mask, dim=-1)

    P, _ = decompose_essential(E_best, x1, x2)
    out = {"E": E_best, "P": P, "inliers": n_inl, "inlier_mask": inlier_mask}
    if unbatched:
        out = {k: v[0] for k, v in out.items()}
    return out
