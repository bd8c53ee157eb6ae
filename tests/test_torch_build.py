"""The CUDA kernels' build, as far as a machine without nvcc can check it:
the command targets Hopper (sm_90a), the library name follows the source,
and a missing compiler raises instead of falling back."""
import os

import pytest

from paddle_tpu_torch.ops.cuda import build


def test_every_source_builds_for_sm_90a_into_the_ignored_build_dir():
    names = build.sources()
    assert {"flash_attention_fwd", "flash_attention_bwd"} <= set(names)
    assert "hopper.cuh" in build.headers()
    for name in names:
        out = build.library_path(name)
        assert os.path.dirname(out) == build.BUILD_DIR
        cmd = build.nvcc_command(name, out, "nvcc")
        joined = " ".join(cmd)
        assert "arch=compute_90a,code=sm_90a" in joined
        assert "-shared" in cmd and cmd[-1].endswith(name + ".cu")
    with open(os.path.join(os.path.dirname(build._PKG), ".gitignore")) as f:
        assert "paddle_tpu_torch/_build/" in f.read().split()


@pytest.mark.parametrize("edited", ["k.cu", "shared.cuh"])
def test_library_name_tracks_the_source(tmp_path, monkeypatch, edited):
    """An edit to the source, or to a header it may include, renames the
    library, so a stale build is never loaded."""
    (tmp_path / "k.cu").write_text("// one\n")
    (tmp_path / "shared.cuh").write_text("// one\n")
    monkeypatch.setattr(build, "CSRC_DIR", str(tmp_path))
    first = build.library_path("k")
    assert build.library_path("k") == first
    (tmp_path / edited).write_text("// two\n")
    assert build.library_path("k") != first


def test_library_name_tracks_a_new_header(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text("// one\n")
    monkeypatch.setattr(build, "CSRC_DIR", str(tmp_path))
    first = build.library_path("k")
    (tmp_path / "extra.cuh").write_text("// new\n")
    assert build.library_path("k") != first


def test_missing_nvcc_raises(monkeypatch):
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setattr(build.os.path, "isfile",
                        lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()
