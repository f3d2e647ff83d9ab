"""The kernel build's library names (multi_modal_tracking_torch.ops._build):
a library is named by a hash of its source, of every header under csrc/
and of the nvcc flags, so an edit to any of them selects a new library and
a stale one is never loaded. Nothing is compiled here."""
import os

from multi_modal_tracking_torch.ops import _build
from tests.torch_port_threads import one_torch_thread  # noqa: F401 (autouse fixture)


def _write(path, text):
    with open(path, "w") as f:
        f.write(text)


def test_lib_path_follows_source_headers_and_flags(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path))
    _write(tmp_path / "k.cu", '#include "shared.cuh"\n')
    _write(tmp_path / "shared.cuh", "// v1\n")
    _write(tmp_path / "other.h", "// v1\n")
    first = _build._lib_path("k")
    assert os.path.dirname(first) == _build.BUILD_DIR
    assert _build._lib_path("k") == first                       # stable
    _write(tmp_path / "shared.cuh", "// v2\n")
    second = _build._lib_path("k")
    assert second != first                                      # a .cuh edit rebuilds
    _write(tmp_path / "other.h", "// v2\n")
    third = _build._lib_path("k")
    assert third not in (first, second)                         # so does a .h edit
    _write(tmp_path / "notes.txt", "not a header\n")
    assert _build._lib_path("k") == third                       # other files do not
    _write(tmp_path / "k.cu", '#include "shared.cuh"\n// edited\n')
    fourth = _build._lib_path("k")
    assert fourth != third                                      # a source edit rebuilds
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-lineinfo"])
    assert _build._lib_path("k") != fourth                      # and so do new flags


def test_headers_are_hashed_in_name_order(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path))
    for name in ("b.cuh", "a.h", "c.cuh"):
        _write(tmp_path / name, f"// {name}\n")
    _write(tmp_path / "k.cu", "\n")
    assert _build._headers() == ["a.h", "b.cuh", "c.cuh"]


def test_repo_kernels_share_the_tf32_header():
    """Both mixed-attention kernels include the shared 3xTF32 header, which
    is among the hashed headers."""
    assert "tf32_mma.cuh" in _build._headers()
    for name in ("mixed_attention", "mixed_attention_bwd"):
        with open(os.path.join(_build.CSRC_DIR, f"{name}.cu")) as f:
            assert '#include "tf32_mma.cuh"' in f.read()
