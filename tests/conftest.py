import os

# Tests run on the single real CPU device — the 512-device override is ONLY
# for the dry-run (repro.launch.dryrun sets it itself, as its own process).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips without one")
