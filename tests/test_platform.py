"""The parts that decide where the program runs and what it reports:
the compile-cache location, the native builder's build-from-source,
and the refusal of `chip_smoke.py` and `bench.py` to report anything
off the GPU. None of these tests needs a GPU."""

import importlib.util
import os
import pathlib
import subprocess
import sys

import jax
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load_script(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_honours_env_var(monkeypatch, tmp_path,
                                       restore_cache_dir):
    from halogen_tpu.utils.compile_cache import enable_compile_cache

    jax.config.update("jax_compilation_cache_dir", None)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert enable_compile_cache() == str(tmp_path)
    # the variable is JAX's own: the helper sets no path of its own
    assert jax.config.jax_compilation_cache_dir is None


def test_compile_cache_defaults_to_checkout(monkeypatch,
                                            restore_cache_dir):
    from halogen_tpu.utils.compile_cache import enable_compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = enable_compile_cache()
    assert path == str(ROOT / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    assert enable_compile_cache() == path  # fixed, not per process


def _run(args, env_extra):
    env = dict(os.environ, **env_extra)
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_cpu():
    """Off the GPU the smoke test exits non-zero and prints no result."""
    out = _run(["chip_smoke.py"], {"JAX_PLATFORMS": "cpu"})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "not a GPU" in out.stdout


@pytest.mark.parametrize("argv,phases", [
    ([], ("device", "forward", "gradient", "golden", "timing")),
    (["--four"], ("device", "four")),
])
def test_chip_smoke_phase_selection(argv, phases):
    smoke = _load_script("chip_smoke")
    assert smoke.selected_phases(smoke.parse_args(argv)) == phases
    assert set(phases) <= set(smoke.PHASE_FNS)


def test_bench_refuses_cpu_without_quick():
    out = _run(["bench.py"], {"JAX_PLATFORMS": "cpu"})
    assert out.returncode != 0
    assert "metric" not in out.stdout
    assert "--quick" in out.stderr


def test_native_builder_failure_warns_and_falls_back(monkeypatch, tmp_path,
                                                     caplog):
    from halogen_tpu.accel import native_loader

    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_loader, "_SRC", str(bad))
    monkeypatch.setattr(native_loader, "_LIB", str(tmp_path / "lib.so"))
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "_load_failed", False)
    with caplog.at_level("WARNING", logger="halogen_tpu"):
        assert not native_loader.available()
    assert "numpy builder" in caplog.text
    assert not (tmp_path / "lib.so").exists()
    assert list(tmp_path.iterdir()) == [bad]  # no temporary left behind
