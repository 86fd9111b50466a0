"""The compile-cache location and chip_smoke.py's CPU-checkable parts."""
import os
import subprocess
import sys

import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

_PROBE = (
    "import jax; from ldpc_3gpp_tpu.utils.cache import enable_compilation_cache;"
    "d = enable_compilation_cache();"
    "print(d); print(jax.config.jax_compilation_cache_dir)"
)


def _probe(env_dir, cwd):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split()
    return out[-2], out[-1]


def test_cache_honours_env_dir(tmp_path):
    """JAX_COMPILATION_CACHE_DIR, when set, is where the cache goes and
    nothing overrides it."""
    want = str(tmp_path / "jaxcache")
    helper, config = _probe(want, cwd=str(tmp_path))
    assert helper == config == want
    assert os.path.isdir(want)


def test_cache_defaults_to_checkout_from_any_cwd(tmp_path):
    """Unset, the cache is <checkout>/.jax_cache whatever the cwd."""
    want = os.path.join(ROOT, ".jax_cache")
    helper, config = _probe(None, cwd=str(tmp_path))
    assert helper == config == want


def _chip_smoke():
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import chip_smoke

    return chip_smoke


def test_chip_smoke_device_phase_refuses_cpu():
    """The device phase has no CPU fallback: the suite runs on the CPU
    platform, so the check must raise."""
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        _chip_smoke().check_device()


def test_chip_smoke_phase_selection():
    """--multi selects the multi-card phase (after the device check) and no
    other; without it, the single-card phases run with the card tests first
    and no multi phase."""
    cs = _chip_smoke()
    assert cs.select_phases(["--multi"]) == ("device", "multi")
    single = cs.select_phases([])
    assert single[0] == "card_tests" and "multi" not in single
    assert {"device", "reference", "flagship", "vs_reference"} <= set(single)


def test_chip_smoke_fails_without_gpu_or_package(tmp_path):
    """Without a GPU it exits non-zero with no result line; alone in a
    directory, without the package, likewise."""
    import shutil

    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin"}
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and '"ok"' not in r.stdout
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and '"ok"' not in r.stdout
