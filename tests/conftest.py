"""Shared fixtures.  NOTE: no XLA_FLAGS here — smoke tests and benches
must see 1 CPU device; only launch/dryrun.py forces 512 placeholders
(and the sharded-solve/dryrun suites re-exec themselves in subprocesses
with 8 forced devices)."""

import os

import jax
import jax.numpy as jnp
import pytest

try:
    # deterministic property tier: the CI profile pins a derandomized
    # (seeded-from-test-name) run with no deadline — hypothesis examples
    # jit/compile, so wall-time-per-example limits only cause flakes.
    # Select another profile with HYPOTHESIS_PROFILE=<name>.
    from hypothesis import settings

    settings.register_profile("ci", derandomize=True, deadline=None,
                              print_blob=True)
    settings.load_profile(os.environ.get("HYPOTHESIS_PROFILE", "ci"))
except ImportError:
    # image without hypothesis: the property suites importorskip
    pass


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: multi-device / subprocess suites (still part "
        "of tier-1; deselect with -m 'not slow' for a quick pass)")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (the port's CUDA kernels "
        "have no CPU mode); skips without one")


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)


def tiny_batch(cfg, B=2, S=16, seed=0):
    if cfg.frontend != "none":
        from repro.models.frontends import frontend_batch_synthetic
        return frontend_batch_synthetic(cfg, B, S, jax.random.PRNGKey(seed))
    key = jax.random.PRNGKey(seed)
    t = jax.random.randint(key, (B, S), 0, cfg.vocab, jnp.int32)
    return {"tokens": t, "labels": jnp.roll(t, -1, axis=1),
            "mask": jnp.ones((B, S), jnp.float32)}
