"""The port's pose helpers of `ops/rotations.py` against the JAX package's.

`matrix_to_angle`, `quat_to_matrix`, `pose_vec2mat`, `pose_to_rt`,
`rt_to_pose`, `invert_pose` and `compose_pose` on the same seeded inputs, in
float64, to 1e-6 (both sides evaluate the same closed forms; the bound
leaves room for the libraries' own trigonometric functions). The gimbal-lock
branch of `matrix_to_angle` is exercised at ay = +-pi/2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_sfm_revisited_tpu.ops import rotations as jrot
from deep_sfm_revisited_tpu_torch.ops import rotations as trot

TOL = dict(rtol=1e-6, atol=1e-6)


def _angles(rng, n=16):
    a = rng.uniform(-np.pi, np.pi, (n, 3))
    a[:, 1] = rng.uniform(-np.pi / 2 + 0.01, np.pi / 2 - 0.01, n)
    return a


def _poses(rng, n=16):
    R = np.asarray(jrot.angle_to_matrix(jnp.asarray(_angles(rng, n))))
    return np.concatenate([R, rng.randn(n, 3, 1)], axis=-1)


def _both(name, *args):
    j = getattr(jrot, name)(*(jnp.asarray(a) for a in args))
    t = getattr(trot, name)(*(torch.from_numpy(np.array(a)) for a in args))
    return np.asarray(j), t.numpy()


@pytest.mark.parametrize("gimbal", [False, True])
def test_matrix_to_angle(gimbal):
    rng = np.random.RandomState(0)
    a = _angles(rng)
    if gimbal:
        a[:, 1] = np.where(np.arange(len(a)) % 2 == 0, np.pi / 2, -np.pi / 2)
    R = np.asarray(jrot.angle_to_matrix(jnp.asarray(a)))
    j, t = _both("matrix_to_angle", R)
    np.testing.assert_allclose(t, j, **TOL)


def test_quat_to_matrix():
    q = np.random.RandomState(1).randn(16, 4) * 3.0      # unnormalized on purpose
    j, t = _both("quat_to_matrix", q)
    np.testing.assert_allclose(t, j, **TOL)


def test_pose_vec2mat():
    rng = np.random.RandomState(2)
    vec = np.concatenate([rng.randn(16, 3), _angles(rng)], axis=-1)
    j, t = _both("pose_vec2mat", vec)
    np.testing.assert_allclose(t, j, **TOL)


def test_pose_to_rt_and_back():
    rng = np.random.RandomState(3)
    P = _poses(rng)
    j, t = _both("pose_to_rt", P)
    np.testing.assert_allclose(t, j, **TOL)
    j2, t2 = _both("rt_to_pose", j)
    np.testing.assert_allclose(t2, j2, **TOL)
    np.testing.assert_allclose(t2, P, rtol=1e-9, atol=1e-9)


def test_invert_and_compose_pose():
    rng = np.random.RandomState(4)
    a, b = _poses(rng), _poses(rng)
    j, t = _both("invert_pose", a)
    np.testing.assert_allclose(t, j, **TOL)
    j, t = _both("compose_pose", a, b)
    np.testing.assert_allclose(t, j, **TOL)
    ident = trot.compose_pose(torch.from_numpy(a), trot.invert_pose(torch.from_numpy(a)))
    np.testing.assert_allclose(ident.numpy(), np.broadcast_to(np.eye(3, 4), a.shape), atol=1e-12)
