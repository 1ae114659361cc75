"""Helpers shared by the tests that hold the PyTorch port against the JAX package."""

import jax
import numpy as np
import torch


def random_variables(init, *args, seed: int):
    """Flax variables of the shapes `init(*args)` makes, filled from a numpy seed.

    `jax.eval_shape` traces `init` without compiling it (a jitted init of the
    whole SFMNet compiles its RANSAC too, for tens of seconds on the CPU).
    Kernels are N(0, 1/fan_in); every BatchNorm statistic and affine
    parameter and every bias is off its init value (at init they are 0/1),
    so each mapping of the weight bridge is exercised.
    """
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            w = rng.randn(*shape) / np.sqrt(max(int(np.prod(shape[:-1])), 1))
        elif name == "scale":
            w = rng.uniform(0.7, 1.3, shape)
        elif name == "var":
            w = rng.uniform(0.6, 1.6, shape)
        elif name in ("bias", "mean"):
            w = 0.1 * rng.randn(*shape)
        else:
            raise KeyError(f"no fill rule for flax leaf {name!r}")
        return np.asarray(w, np.float32)

    return jax.tree_util.tree_map_with_path(fill, jax.eval_shape(init, *args))


def t2n(x):
    return x.detach().cpu().float().numpy()


def load_strict(module: torch.nn.Module, state_dict):
    """load_state_dict(strict=True), asserting nothing is missing or extra."""
    result = module.load_state_dict(state_dict, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    return module
