"""Test harness configuration.

Default tier: tests run on a virtual 8-device CPU mesh (no accelerator
needed) — the sharding tests exercise the same shard_map code paths the
multi-device runs use, and CPU keeps the suite hermetic.  Must run before
any other jax import.

GPU tier: ``LDPC_TEST_GPU=1 python -m pytest -m gpu -p no:xdist`` leaves the
platform alone, so the tests marked ``gpu`` run on the card.  One process
only (``-p no:xdist``): a JAX process reserves most of the card's memory
when it starts, so a second one fails.  Tests marked ``gpu`` skip with a
reason when the first device is not a GPU; the decision is made in a
fixture, never at import, so every xdist worker collects the same tests.
"""
import os

if not os.environ.get("LDPC_TEST_GPU"):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    )
    os.environ["JAX_PLATFORMS"] = "cpu"

    import jax

    jax.config.update("jax_platforms", "cpu")

# Persistent compilation cache: the suite is compile-bound (every jitted
# config is a fresh XLA compile) and test configs are stable across runs,
# so warm runs of the quick tier skip almost all compilation.  File-based,
# safely shared by xdist workers; keyed on HLO + compiler version, so
# semantics changes recompile exactly what they touch.
from ldpc_3gpp_tpu.utils.cache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()


import pytest  # noqa: E402


def _skip_unless_gpu():
    import jax

    platform = jax.devices()[0].platform
    if platform != "gpu":
        pytest.skip(
            f"needs an NVIDIA GPU (first device is {platform!r}); run "
            "LDPC_TEST_GPU=1 python -m pytest -m gpu -p no:xdist on the card"
        )


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip a ``gpu``-marked test unless JAX's first device is a GPU."""
    if request.node.get_closest_marker("gpu") is not None:
        _skip_unless_gpu()


@pytest.fixture(scope="module")
def gpu_module():
    """For module fixtures of the GPU tier: skips before they do any work
    (module fixtures are set up before the function-scoped check above)."""
    _skip_unless_gpu()


@pytest.fixture(autouse=True)
def _clear_jax_caches_after_every_test(request):
    """Bound the XLA CPU JIT code arena per worker — green-by-construction.

    Every jitted config is a large fresh compile (or, warm, an AOT load
    from the persistent cache); XLA:CPU maps ALL of them into one finite
    contiguous code arena per process, and a long-lived xdist worker that
    accumulates executables dies — "Unable to allocate section memory!" at
    compile time, or a SIGSEGV inside the compilation-cache READ path at
    AOT-load time.  Releasing executable references after EVERY test bounds
    arena pressure to a single test's programs, so no test module can
    reintroduce the crash by forgetting a module-local fixture.

    Cost: in-memory executable reuse across tests is lost, but tests jit
    through fresh closures/partials (no cross-test pjit cache hits anyway)
    and the persistent .jax_cache turns any repeat into a disk read.
    The GPU tier keeps its executables: its module fixture compiles every
    gate up front, and its process holds no CPU code arena of that size.
    """
    yield
    if request.node.get_closest_marker("gpu") is not None:
        return
    import jax

    jax.clear_caches()
