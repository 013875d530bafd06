"""The threefry layout the test session draws from, in both packages.

JAX's ``jax_threefry_partitionable`` flag picks how ``split`` and the random
bits lay out their counters. It is on by default since JAX 0.5, but the
committed golden traces (``tests/golden/*.json``) and ``BENCH_*.json`` files
were drawn with it off, and ``tests/test_golden_traces.py`` runs the
reference engine in whatever layout JAX is set to. So the session runs in
that original layout: this module sets it when it is imported, in JAX's
config and in the port's default (``JAX_THREEFRY_PARTITIONABLE`` as both
read it). pytest imports every test module while it collects, before any test
runs, so every test and every worker process sees the same layout whatever
order the tests run in. Tests that need the other layout set it in a fixture
and restore it (``tests/test_torch_prng.py``, ``tests/test_torch_init.py``).

The tests below hold the session to that layout and the two packages to the
same draws in it; every comparison is exact."""
import importlib
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro_torch.core import prng  # noqa: E402

os.environ["JAX_THREEFRY_PARTITIONABLE"] = "false"
jax.config.update("jax_threefry_partitionable", False)
importlib.reload(prng)      # the port reads the variable when it is imported


def test_session_draws_from_the_original_layout():
    assert not jax.config.jax_threefry_partitionable
    assert not prng.partitionable()


@pytest.mark.parametrize("seed", [0, 4, 42])
def test_session_default_draws_agree(seed):
    """With no layout set by the test, both packages draw the same keys and
    bits as the golden runs did (``split``, ``fold_in``, ``uniform``)."""
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(prng.split(tk, 6).numpy(),
                                  np.asarray(jax.random.split(jk, 6)))
    np.testing.assert_array_equal(prng.fold_in(tk, 3).numpy(),
                                  np.asarray(jax.random.fold_in(jk, 3)))
    np.testing.assert_array_equal(
        prng.uniform(tk, (5, 7)).numpy(),
        np.asarray(jax.random.uniform(jk, (5, 7))))
