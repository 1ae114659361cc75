"""The port's pose engine against the JAX package: linalg64, polyroots, the
five-point solver, the correspondence sampler, the polish, the cheirality
decomposition and RANSAC.

Inputs and random draws are made once (numpy seeds, and jax.random for the
draws the JAX functions make internally) and handed to both sides. Small
sizes: 128 points, 16 x 1 hypotheses, with the two-stage vote switched on
(0 < score_subset < N, 0 < score_topk < 10 H; guard at essential.py:762).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_sfm_revisited_tpu.ops import essential as jess
from deep_sfm_revisited_tpu.ops import flow_ops as jflow
from deep_sfm_revisited_tpu.ops import linalg64 as jlin
from deep_sfm_revisited_tpu.ops import polyroots as jpr
from deep_sfm_revisited_tpu_torch.ops import essential as tess
from deep_sfm_revisited_tpu_torch.ops import flow_ops as tflow
from deep_sfm_revisited_tpu_torch.ops import linalg64 as tlin
from deep_sfm_revisited_tpu_torch.ops import polyroots as tpr

torch.set_num_threads(1)
T = torch.from_numpy


def _jit(fn, **static):
    """JAX side under jit: one compile beats op-by-op dispatch on the CPU."""
    return jax.jit(functools.partial(fn, **static))


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)


def _rot(a):
    cx, cy, cz = np.cos(a)
    sx, sy, sz = np.sin(a)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def _pairs(seed, b=2, n=128, noise=3e-5, outliers=0.15, truth=False):
    """Normalized correspondences of a rigid scene, (b, n, 2) x2, f64
    (and the true (R, t) stacks with truth=True)."""
    rng = np.random.RandomState(seed)
    x1s, x2s, Rs, ts = [], [], [], []
    for _ in range(b):
        R = _rot(rng.uniform(-0.05, 0.05, 3))
        t = rng.uniform(-1, 1, 3)
        t[2] = abs(t[2]) + 0.5
        t /= np.linalg.norm(t)
        x1 = rng.uniform(-0.6, 0.6, (n, 2))
        z = rng.uniform(3.0, 9.0, n)
        X = np.concatenate([x1, np.ones((n, 1))], 1) * z[:, None]
        X2 = X @ R.T + t
        x2 = X2[:, :2] / X2[:, 2:]
        x2 += rng.randn(n, 2) * noise
        bad = rng.rand(n) < outliers
        x2[bad] = rng.uniform(-0.6, 0.6, (bad.sum(), 2))
        x1s.append(x1)
        x2s.append(x2)
        Rs.append(R)
        ts.append(t)
    if truth:
        return np.stack(x1s), np.stack(x2s), (np.stack(Rs), np.stack(ts))
    return np.stack(x1s), np.stack(x2s)


# ---- linalg64 and polyroots: float64 to 1e-9 relative (same algorithm,
# op for op; only summation order may differ) ------------------------------

@pytest.mark.parametrize("pivot", [True, False])
def test_gauss_solve_matches_jax(pivot):
    rng = np.random.RandomState(1)
    A = rng.randn(7, 10, 10)
    B = rng.randn(7, 10, 3)
    ref = _jit(jlin.gauss_solve, pivot=pivot)(jnp.asarray(A), jnp.asarray(B))
    got = tlin.gauss_solve(T(A), T(B), pivot=pivot)
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("name", ["nullspace", "eigh3x3", "det3x3"])
def test_linalg_matches_jax(name):
    rng = np.random.RandomState(2)
    if name == "nullspace":
        A = rng.randn(6, 5, 9)
        ref = _jit(jlin.nullspace, null_dim=4)(jnp.asarray(A))
        got = tlin.nullspace(T(A), 4)
        np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-9, atol=1e-12)
    elif name == "eigh3x3":
        S = rng.randn(6, 3, 3)
        S = S + np.swapaxes(S, -1, -2)
        (wr, Vr), (wg, Vg) = jax.jit(jlin.eigh3x3)(jnp.asarray(S)), tlin.eigh3x3(T(S))
        np.testing.assert_allclose(_np(wg), np.asarray(wr), rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(_np(Vg), np.asarray(Vr), rtol=1e-9, atol=1e-12)
    else:
        M = rng.randn(6, 3, 3)
        np.testing.assert_allclose(_np(tlin.det3x3(T(M))),
                                   np.asarray(jlin.det3x3(jnp.asarray(M))), rtol=1e-12)


@pytest.mark.parametrize("schedule", ["default", "fast"])
def test_real_roots_matches_jax(schedule):
    rng = np.random.RandomState(3)
    polys = []
    for _ in range(8):  # 6 real roots and 2 complex pairs -> degree 10
        p = np.poly1d([1.0])
        for r in rng.uniform(-4, 4, 6):
            p = p * np.poly1d([1.0, -r])
        for _ in range(2):
            p = p * np.poly1d([1.0, rng.uniform(-1, 1), rng.uniform(1.5, 3)])
        polys.append(p.coeffs[::-1])  # lowest power first
    c = np.stack(polys) * rng.uniform(0.5, 2, (8, 1))
    kw = {} if schedule == "default" else dict(bisect_iters=12, newton_iters=5)
    rr, vr = _jit(jpr.real_roots, max_roots=10, **kw)(jnp.asarray(c))
    rg, vg = tpr.real_roots(T(c), 10, **kw)
    np.testing.assert_array_equal(_np(vg), np.asarray(vr))
    assert int(_np(vg).sum()) == 8 * 6
    np.testing.assert_allclose(_np(rg), np.asarray(rr), rtol=1e-9, atol=1e-12)


# ---- five-point solver ----------------------------------------------------

def _five_point_samples():
    x1, x2 = _pairs(4, b=1, n=64, noise=0.0, outliers=0.0)
    rng = np.random.RandomState(5)  # distinct points: a repeated point
    idx = np.stack([rng.choice(64, 5, replace=False) for _ in range(12)])  # is rank-deficient
    return x1[0][idx], x2[0][idx]


def test_five_point_candidates_matches_jax():
    """float64 (the oracle path, partial pivoting, 26 bisections + 4
    Newton): same candidates in the same order, to 1e-9 relative."""
    s1, s2 = _five_point_samples()
    Er, vr = jax.jit(jess.five_point_candidates)(jnp.asarray(s1), jnp.asarray(s2))
    Eg, vg = tess.five_point_candidates(T(s1), T(s2))
    vr, vg = np.asarray(vr), _np(vg)
    np.testing.assert_array_equal(vg, vr)
    np.testing.assert_allclose(_np(Eg)[vr], np.asarray(Er)[vr], rtol=1e-9, atol=1e-11)


def _recall_error(E32, v32, E64, v64):
    """Per true (f64) candidate: distance to the nearest valid f32 one, up to sign."""
    out = []
    for i in range(E64.shape[0]):
        for r in np.flatnonzero(v64[i]):
            d = [min(np.abs(E32[i, k] - E64[i, r]).max(),
                     np.abs(E32[i, k] + E64[i, r]).max()) for k in np.flatnonzero(v32[i])]
            out.append(min(d) if d else np.inf)
    return np.array(out)


def test_five_point_fast_path_as_accurate_as_jax():
    """The float32 fast path (pivot-free Gauss-Jordan, 12 bisections + 5
    Newton) is ill-conditioned at the 1e-3 level on BOTH sides: an ulp of
    difference in f32 sin/cos or a sum order moves some candidates by
    1e-3..1e-1 and can add or drop a spurious root (measured on these
    samples: the JAX and the port's f32 sets each carry one such root, in
    different samples). So the two are held to the same standard instead
    of to each other: every true (f64) candidate is found to 1e-2 in the
    f32 set, and a sample gains at most 2 extra roots."""
    s1, s2 = _five_point_samples()
    E64, v64 = (_np(a) for a in tess.five_point_candidates(T(s1), T(s2)))
    f1, f2 = s1.astype(np.float32), s2.astype(np.float32)
    Ej, vj = (np.asarray(a) for a in _jit(jess.five_point_candidates, fast=True)(
        jnp.asarray(f1), jnp.asarray(f2)))
    Et, vt = (_np(a) for a in tess.five_point_candidates(T(f1), T(f2), fast=True))
    for E32, v32 in ((Ej, vj), (Et, vt)):
        assert _recall_error(E32, v32, E64, v64).max() < 1e-2
        assert (v32.sum(1) - v64.sum(1)).max() <= 2
        assert (v32.sum(1) >= v64.sum(1)).all()


@pytest.mark.parametrize("name", ["sampson_error", "decompose_essential"])
def test_scoring_and_decomposition_match_jax(name):
    x1, x2 = _pairs(6, b=2, n=128)
    E = np.stack([np.asarray(jess.essential_from_rt(
        jnp.asarray(_rot(np.array([0.02, -0.01, 0.03]) * (i + 1))),
        jnp.asarray(np.array([0.3, 0.1, 0.9]) / np.linalg.norm([0.3, 0.1, 0.9]))))
        for i in range(2)])
    if name == "sampson_error":
        ref = jess.sampson_error(jnp.asarray(E)[:, None], jnp.asarray(x1)[:, None],
                                 jnp.asarray(x2)[:, None])
        got = tess.sampson_error(T(E)[:, None], T(x1)[:, None], T(x2)[:, None])
        np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-12, atol=1e-15)
    else:
        Pr, nr = jess.decompose_essential(jnp.asarray(E), jnp.asarray(x1), jnp.asarray(x2))
        Pg, ng = tess.decompose_essential(T(E), T(x1), T(x2))
        np.testing.assert_array_equal(_np(ng), np.asarray(nr))
        np.testing.assert_allclose(_np(Pg), np.asarray(Pr), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("coarse", [None, "float32"])
def test_polish_matches_jax(coarse):
    """Huber IRLS polish, vmapped on the JAX side, batched in the port. The
    port's Jacobian is analytic where JAX runs jacfwd: same math, other
    rounding. f64: 1e-9; f32 coarse steps (whose iterates differ by f32
    ulps) then one f64 step: 1e-6."""
    x1, x2, (R, t) = _pairs(7, b=2, n=128, outliers=0.0, truth=True)
    rng = np.random.RandomState(8)
    # start where RANSAC leaves it: near the true E
    E0 = np.stack([np.asarray(jess.essential_from_rt(
        jnp.asarray(R[i] @ _rot(rng.uniform(-0.01, 0.01, 3))),
        jnp.asarray(t[i] + rng.uniform(-0.05, 0.05, 3)))) for i in range(2)])
    w = (rng.rand(2, 128) > 0.1).astype(np.float64)
    jc = None if coarse is None else jnp.float32
    ref = jax.jit(jax.vmap(lambda e, a, b, ww: jess.polish_essential(
        e, a, b, weights=ww, iters=6, coarse_dtype=jc)))(
        jnp.asarray(E0), jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(w))
    got = tess.polish_essential(T(E0), T(x1), T(x2), T(w), iters=6,
                                coarse_dtype=None if coarse is None else torch.float32)
    tol = 1e-9 if coarse is None else 1e-6
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=0, atol=tol)


# ---- correspondence sampler -----------------------------------------------

def _flow_scene(seed=11, b=2, h=48, w=64):
    rng = np.random.RandomState(seed)
    flow = rng.uniform(-3, 3, (b, h, w, 2))
    ent = rng.uniform(0.0, 1.0, (b, h, w, 1))
    K = np.array([[50.0, 0, w / 2], [0, 50.0, h / 2], [0, 0, 1]])
    K_inv = np.broadcast_to(np.linalg.inv(K), (b, 3, 3)).copy()
    return flow, ent, K_inv


def test_flow2coord_matches_jax():
    flow = _flow_scene()[0]
    for a, r in zip(tflow.flow2coord(T(flow)), jflow.flow2coord(jnp.asarray(flow))):
        np.testing.assert_array_equal(_np(a), np.asarray(r))


@pytest.mark.parametrize("mode", ["entropy", "fallback", "uniform", "nokey"])
def test_sample_correspondences_matches_jax(mode):
    """With the JAX draws injected the port picks the same candidates:
    identical points (1e-12 in normalized coords, far below one pixel)."""
    flow, ent, K_inv = _flow_scene()
    b, n = flow.shape[0], 64
    if mode == "fallback":
        ent = np.full_like(ent, 0.95)  # nothing confident -> uniform grid
    conf = None if mode in ("uniform", "nokey") else ent
    key = None if mode == "nokey" else jax.random.PRNGKey(9)
    out_j = _jit(jflow.sample_correspondences, num_points=n, margin=10,
                 min_matches=20)(jnp.asarray(flow), jnp.asarray(K_inv), key=key,
                                 conf=None if conf is None else jnp.asarray(conf))
    kw = {}
    if key is not None:
        n_cand = n * (4 if conf is not None else 1)
        k_grid, k_gumbel = jax.random.split(key)
        kw["jitter"] = T(np.array(jax.random.uniform(
            k_grid, (b, n_cand, 2), jnp.float32, -0.5, 0.5)))
        if conf is not None:
            kw["gumbel_u"] = T(np.array(jax.random.uniform(
                k_gumbel, (b, n_cand), jnp.float32, 1e-12, 1.0)))
    out_t = tflow.sample_correspondences(
        T(flow), T(K_inv), n, margin=10, conf=None if conf is None else T(conf),
        min_matches=20, **kw)
    assert len(out_t) == len(out_j)
    for a, r in zip(out_t, out_j):
        np.testing.assert_allclose(_np(a), np.asarray(r), rtol=0, atol=1e-12)


# ---- RANSAC ----------------------------------------------------------------

_RANSAC_CASES = ["float64-two_stage", "float32-two_stage", "float64-single"]


@pytest.fixture(scope="module")
def ransac_runs():
    """Each case once on both sides, the minimal samples shared. Scenes 0-1
    are rigid with noise and 15% outliers; scene 2 has no parallax
    (x2 == x1), the degenerate probe."""
    x1, x2 = _pairs(12, b=3, n=128)
    x2[2] = x1[2]
    H = 16
    key = jax.random.PRNGKey(13)
    idx = np.asarray(jax.random.randint(key, (3, H, 5), 0, 128))
    runs = {}
    for case in _RANSAC_CASES:
        solve, stage = case.split("-")
        kw = dict(num_hypotheses=H, ransac_iter=1, threshold=1e-4, polish=True,
                  polish_iters=5, score_subset=32 if stage == "two_stage" else 0,
                  score_topk=64 if stage == "two_stage" else 0)
        ref = _jit(jess.ransac_pose, solve_dtype=jnp.dtype(solve), **kw)(
            jnp.asarray(x1), jnp.asarray(x2), key)
        got = tess.ransac_pose(T(x1), T(x2), solve_dtype=getattr(torch, solve),
                               sample_idx=T(idx), **kw)
        runs[case] = ({k: np.asarray(v) for k, v in ref.items()},
                      {k: _np(v) for k, v in got.items()})
    return runs


# float64 candidates: the same winner and inlier set, E and P to 1e-8.
# float32 candidates (the shipped fast path) differ from JAX's by f32
# rounding (see the fast-path test above), so the vote may crown another
# near-equal candidate; after the polish both sit at the same optimum:
# inlier counts within 2, E and P to 1e-3.
@pytest.mark.parametrize("case", _RANSAC_CASES)
def test_ransac_inliers_match_jax(ransac_runs, case):
    ref, got = ransac_runs[case]
    assert got["inliers"][:2].min() >= 90
    if case.startswith("float64"):
        np.testing.assert_array_equal(got["inliers"][:2], ref["inliers"][:2])
        np.testing.assert_array_equal(got["inlier_mask"][:2], ref["inlier_mask"][:2])
    else:
        assert np.abs(got["inliers"][:2] - ref["inliers"][:2]).max() <= 2


@pytest.mark.parametrize("case", _RANSAC_CASES)
def test_ransac_pose_matches_jax(ransac_runs, case):
    ref, got = ransac_runs[case]
    tol = 1e-8 if case.startswith("float64") else 1e-3
    for k in ("E", "P"):
        np.testing.assert_allclose(got[k][:2], ref[k][:2], rtol=0, atol=tol)


@pytest.mark.parametrize("case", _RANSAC_CASES)
def test_ransac_zero_parallax_probe(ransac_runs, case):
    """No parallax leaves t undetermined, so the two sides need not agree
    on it; each must return a finite pose with a unit translation."""
    for out in ransac_runs[case]:
        P = out["P"][2]
        assert np.isfinite(P).all() and np.isfinite(out["E"][2]).all()
        np.testing.assert_allclose(np.linalg.norm(P[:, 3]), 1.0, atol=1e-9)
