"""The port's kernel build (``minips_tpu_torch/ops/_build.py``): what a
library's file name hashes, so that an edited source or header rebuilds."""

from __future__ import annotations

import pytest

from minips_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text('#include "a.cuh"\n')
    (src / "a.cuh").write_text("// a\n")
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return src


@pytest.mark.parametrize("edit", ["source", "header", "new header",
                                  "removed header"])
def test_library_path_follows_source_and_headers(csrc, edit):
    before = _build.library_path("k")
    if edit == "removed header":
        (csrc / "a.cuh").unlink()
    else:
        target = {"source": "k.cu", "header": "a.cuh",
                  "new header": "b.cuh"}[edit]
        (csrc / target).write_text("// edited\n")
    after = _build.library_path("k")
    assert after != before and after.parent == before.parent
    assert after.name.startswith("libk-") and after.suffix == ".so"


def test_library_path_is_stable_and_ignores_other_files(csrc):
    before = _build.library_path("k")
    (csrc / "notes.txt").write_text("not a header\n")
    (csrc / "other.cu").write_text("// another kernel\n")
    assert _build.library_path("k") == before

