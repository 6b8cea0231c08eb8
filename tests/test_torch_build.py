"""ray_torch.ops._build names each library by what it is built from: the
kernel's source, every shared header under ``csrc/`` and the flags. Runs on
the CPU: nothing is compiled."""

from ray_torch.ops import _build


def test_a_header_edit_changes_the_library_path(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// v1\n")
    first = _build.library_path("k")
    assert _build.library_path("k") == first          # stable
    (tmp_path / "h.cuh").write_text("// v2\n")
    second = _build.library_path("k")
    assert second != first
    (tmp_path / "other.cuh").write_text("// new header\n")
    assert _build.library_path("k") != second
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n// edit\n')
    assert _build.library_path("k").name.startswith("libk-")
    assert _build.library_path("k") != second
