"""A module-scoped fixture for the port's test files: after a module's tests
have run in a process, drop JAX's compilation caches and collect garbage.

Every XLA:CPU executable keeps its memory mappings for as long as it is
cached, and one process may hold at most ``vm.max_map_count`` of them
(65530 here); an xdist worker that runs many JAX tests in a row crashes
past it. Dropping the caches unmaps the executables of every test the
worker has run so far; the next JAX call compiles again (or reads the
persistent compile cache). Tests import the fixture by name:

    from xla_release import release_xla_executables  # noqa: F401

It uses JAX only if something in the process has imported it.
"""

import gc
import sys

import pytest


@pytest.fixture(autouse=True, scope="module")
def release_xla_executables():
    yield
    jax = sys.modules.get("jax")
    if jax is not None:
        jax.clear_caches()
    gc.collect()
