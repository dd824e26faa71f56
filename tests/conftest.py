import os

# Tests run on a virtual 8-device CPU mesh so sharding paths are exercised
# without accelerator hardware. XLA_FLAGS must be set before backend init;
# the platform is pinned through jax.config as well as the environment so
# that it holds even where a plugin registered another backend first.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# Disable the persistent XLA compilation cache for the whole suite (the
# CLI path would otherwise enable it process-wide): jax's executable
# serialization segfaults (put_executable_and_time SIGSEGV) when a cache
# write fires for the virtual-8-device sharded CPU executables, and test
# compiles are local and fast anyway. utils.cache.enable_compilation_cache
# respects this setting.
jax.config.update("jax_enable_compilation_cache", False)


import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Free compiled executables between test modules.

    XLA:CPU's compiler segfaults (backend_compile_and_load SIGSEGV)
    reproducibly once ~80 tests of executables have accumulated in one
    process — independent of the persistent-cache setting and of the
    thunk runtime; every affected compile passes in a fresh process.
    Dropping the executable caches at module boundaries keeps the
    in-process accumulation below the crash threshold at the cost of
    some recompilation (tests share compiles within a module anyway).
    """
    yield
    jax.clear_caches()
