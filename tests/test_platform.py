"""Platform plumbing: compile-cache placement and the on-card smoke test.

Each check runs in a subprocess, so that the process under test imports
the package fresh with the environment the check sets.  The test process
itself stays on the CPU backend (tests/conftest.py); only the `gpu`-marked
test lets a subprocess open a card, and only when one is present.
"""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "chip_smoke.py")


def _env(**overrides):
    env = dict(os.environ)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env["JAX_PLATFORMS"] = "cpu"
    env.update(overrides)
    return env


def _cache_dir(env, cwd):
    out = subprocess.run(
        [sys.executable, "-c",
         "import flash_hash_join_tpu, jax; "
         "print(jax.config.jax_compilation_cache_dir)"],
        env=env, cwd=cwd, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip().splitlines()[-1]


def test_compile_cache_in_checkout_by_default(tmp_path):
    env = _env(PYTHONPATH=REPO)
    assert _cache_dir(env, str(tmp_path)) == os.path.join(REPO, ".jax_cache")


def test_compile_cache_follows_env(tmp_path):
    want = str(tmp_path / "cache")
    env = _env(PYTHONPATH=REPO, JAX_COMPILATION_CACHE_DIR=want)
    assert _cache_dir(env, str(tmp_path)) == want


def test_chip_smoke_fails_without_gpu():
    out = subprocess.run([sys.executable, SMOKE], env=_env(), cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    """Alone in a directory, the script cannot import the engine."""
    shutil.copy(SMOKE, tmp_path)
    env = _env()
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, str(tmp_path / "chip_smoke.py"), "--cpu-rehearsal"],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


@pytest.mark.gpu
def test_chip_smoke_on_card():
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)  # undo conftest's CPU forcing
    env["XLA_FLAGS"] = " ".join(
        f for f in env.get("XLA_FLAGS", "").split()
        if "xla_force_host_platform_device_count" not in f)
    probe = subprocess.run(
        [sys.executable, "-c",
         "import jax; print(jax.devices()[0].platform)"],
        env=env, capture_output=True, text=True, timeout=300)
    if probe.stdout.strip().splitlines()[-1:] != ["gpu"]:
        pytest.skip("no GPU visible to JAX")
    out = subprocess.run([sys.executable, SMOKE], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=1500)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1].startswith('{"ok": true')
