"""Persistent XLA compilation cache.

The fast decoders unroll the base graph into the while-loop body (by design:
zero gathers), which makes the first compile of a configuration expensive.
The persistent cache lets every later process reuse the serialized
executable, so sweeps and benches pay compile once per (config, batch).

Where the cache lives: ``JAX_COMPILATION_CACHE_DIR`` when the environment
sets it (JAX reads that variable itself, and nothing here overrides it);
otherwise ``<checkout>/.jax_cache``, one fixed path whatever the working
directory — the path is part of the cache key, so a moving directory never
hits.
"""
import os

CHECKOUT_CACHE_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", ".jax_cache")
)


def cache_dir() -> str:
    """The directory the persistent cache uses (see module docstring)."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or CHECKOUT_CACHE_DIR


def enable_compilation_cache() -> str:
    """Turn the persistent cache on; returns its directory."""
    import jax

    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
