"""The kernel build of the PyTorch port (ops/cuda/_build.py), with a stand-in
compiler: one compile per source, outputs keyed by the sources' hash and
reused, and a failing compile raises with the compiler's log."""

import os
import sys

import pytest

from surya_tpu_torch.ops.cuda import KERNELS, _build


def _fake_nvcc(tmp_path, body):
    path = tmp_path / "nvcc"
    path.write_text(f"#!{sys.executable}\nimport sys\nargs = sys.argv\n"
                    + body)
    os.chmod(path, 0o755)
    return str(path)


@pytest.fixture
def build_dir(tmp_path, monkeypatch):
    out = tmp_path / "build"
    monkeypatch.setattr(_build, "BUILD_DIR", out)
    return out


def test_one_compile_per_source_then_reuse(tmp_path, monkeypatch,
                                           build_dir):
    log = tmp_path / "calls.txt"
    nvcc = _fake_nvcc(tmp_path, (
        "open(args[args.index('-o') + 1], 'w').write('lib')\n"
        f"open({str(log)!r}, 'a').write(args[-1] + '\\n')\n"))
    monkeypatch.setattr(_build, "_nvcc", lambda: nvcc)
    _build.build_all(KERNELS)
    sources = log.read_text().split()
    assert sorted(os.path.basename(s) for s in sources) == sorted(
        f"{k}.cu" for k in KERNELS)
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
    for k in KERNELS:
        assert _build._lib_path(k).exists()
        assert _build._source_hash() in _build._lib_path(k).name
    _build.build_all(KERNELS)  # built already: no compiler runs
    assert len(log.read_text().split()) == len(KERNELS)


def test_failed_compile_raises_with_log(tmp_path, monkeypatch, build_dir):
    nvcc = _fake_nvcc(tmp_path, "print('error: bad kernel'); sys.exit(2)\n")
    monkeypatch.setattr(_build, "_nvcc", lambda: nvcc)
    with pytest.raises(RuntimeError, match="bad kernel"):
        _build.build_all(["quadrant"])
    assert not _build._lib_path("quadrant").exists()


def test_nonzero_launch_status_raises():
    _build.check(0, "ok")
    with pytest.raises(RuntimeError, match="error 9"):
        _build.check(9, "quadrant_forward")


def test_four_processes_building_at_once_all_come_up(tmp_path, build_dir):
    """Four processes (the ranks of a four-card job) build every source
    into one empty directory at once: each compiles to a file of its own
    pid and renames it into place, so all four finish with every library
    there and no temporary file left."""
    import subprocess

    nvcc = _fake_nvcc(tmp_path, (
        "import time; time.sleep(0.5)\n"
        "open(args[args.index('-o') + 1], 'w').write('lib')\n"))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys; from surya_tpu_torch.ops.cuda import KERNELS, "
            "_build; from pathlib import Path; "
            "_build.BUILD_DIR = Path(sys.argv[1]); "
            "_build._nvcc = lambda: sys.argv[2]; "
            "_build.build_all(KERNELS)")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(build_dir),
                               nvcc], cwd=root, stderr=subprocess.PIPE,
                              text=True) for _ in range(4)]
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
    assert sorted(p.name for p in build_dir.iterdir()) == sorted(
        _build._lib_path(k).name for k in KERNELS)
