"""Fixed-shape real roots of degree-10 polynomials (port of `ops/polyroots.py`).

Same schedule as the JAX function: a sign sweep over z = tan(theta) on a
512-point theta grid, evaluated on the homogenized polynomial in the input
dtype; bisection of the first `max_roots` brackets in float32 (for float64
input); then Newton steps in z in the input dtype.
"""

from __future__ import annotations

import math

import torch

_GRID = 512
_BISECT_ITERS = 26
_NEWTON_ITERS = 4


def _eval_homogeneous(coeffs: torch.Tensor, s: torch.Tensor, c: torch.Tensor):
    """P(s, c) = sum_i a_i s^i c^(n-i), coeffs (..., n+1) lowest-power-first."""
    n = coeffs.shape[-1] - 1
    out = coeffs[..., n, None] * torch.ones_like(s)
    for i in range(n - 1, -1, -1):
        out = out * s + coeffs[..., i, None] * c ** (n - i)
    return out


def real_roots(coeffs: torch.Tensor, max_roots: int = 10,
               bisect_iters: int | None = None,
               newton_iters: int | None = None):
    """All odd-multiplicity real roots: coeffs (..., n+1) lowest-first ->
    (roots (..., max_roots), valid (..., max_roots) bool)."""
    dtype, dev = coeffs.dtype, coeffs.device
    n_bisect = _BISECT_ITERS if bisect_iters is None else bisect_iters
    n_newton = _NEWTON_ITERS if newton_iters is None else newton_iters
    scale = torch.amax(torch.abs(coeffs), dim=-1, keepdim=True)
    coeffs = coeffs / torch.clamp(scale, min=1e-30)

    bdtype = torch.float32 if dtype == torch.float64 else dtype
    bcoeffs = coeffs.to(bdtype)
    half_pi = torch.tensor(math.pi / 2, dtype=bdtype)
    eps = torch.tensor(1e-7, dtype=bdtype)
    # the grid agrees with jnp.linspace's to an ulp; a root that close to
    # a grid point is the only case where the brackets could differ
    theta = torch.linspace(float(-half_pi + eps), float(half_pi - eps), _GRID,
                           dtype=bdtype, device=dev)
    s, c = torch.sin(theta).to(dtype), torch.cos(theta).to(dtype)
    vals = _eval_homogeneous(coeffs, s, c)  # (..., GRID)

    sign = torch.sign(vals)
    change = (sign[..., :-1] * sign[..., 1:]) < 0
    idx = torch.arange(_GRID - 1, device=dev).expand(change.shape)
    marked = torch.where(change, idx, torch.full_like(idx, _GRID))
    order = torch.sort(marked, dim=-1).values[..., :max_roots]
    valid = order < _GRID
    safe = torch.clamp(order, max=_GRID - 2)

    lo = theta[safe]
    hi = theta[safe + 1]
    f_lo = torch.gather(vals, -1, safe).to(bdtype)
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        f_mid = _eval_homogeneous(bcoeffs, torch.sin(mid), torch.cos(mid))
        go_right = torch.sign(f_mid) == torch.sign(f_lo)
        lo = torch.where(go_right, mid, lo)
        hi = torch.where(go_right, hi, mid)
        f_lo = torch.where(go_right, f_mid, f_lo)
    roots = torch.tan((0.5 * (lo + hi)).to(dtype))

    n = coeffs.shape[-1] - 1
    powers = torch.arange(n + 1, dtype=dtype, device=dev)
    dcoeffs = coeffs[..., 1:] * powers[1:]

    def horner(cf, z):
        out = torch.zeros_like(z)
        for i in range(cf.shape[-1] - 1, -1, -1):
            out = out * z + cf[..., i, None]
        return out

    for _ in range(n_newton):
        p = horner(coeffs, roots)
        dp = horner(dcoeffs, roots)
        step = p / torch.where(torch.abs(dp) > 1e-30, dp, torch.ones_like(dp))
        ok = torch.abs(step) < (torch.abs(roots) + 1.0)
        roots = roots - torch.where(ok, step, torch.zeros_like(step))

    roots = torch.where(valid, roots, torch.zeros_like(roots))
    return roots, valid
