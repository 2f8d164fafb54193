"""The kernel build's library names (``ops/_build.py``), on the CPU.

A library's name carries a digest of its source, of every ``csrc/*.cuh``
header and of the flags, so editing a shared header rebuilds every kernel.
No ``nvcc`` runs here.
"""

import pytest

from evi_rag_tpu_torch.ops import _build
from evi_rag_tpu_torch.ops.score_kernels import KERNEL_SOURCES


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include "shared.cuh"\n')
    (tmp_path / "shared.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    return tmp_path


def test_header_edit_changes_library_path(csrc):
    before = _build.library_path("k.cu")
    assert before.name.startswith("libk-") and before.suffix == ".so"
    assert _build.library_path("k.cu") == before
    (csrc / "shared.cuh").write_text("// v2\n")
    assert _build.library_path("k.cu") != before


def test_source_edit_and_new_header_change_library_path(csrc):
    before = _build.library_path("k.cu")
    (csrc / "other.cuh").write_text("// new\n")
    after_header = _build.library_path("k.cu")
    assert after_header != before
    (csrc / "k.cu").write_text('#include "shared.cuh"\n// edited\n')
    assert _build.library_path("k.cu") != after_header


def test_every_kernel_source_is_in_the_checkout():
    for source in KERNEL_SOURCES:
        assert (_build.CSRC / source).is_file(), source
        assert _build.library_path(source).parent == _build.BUILD_DIR
    assert (_build.CSRC / "twin_score.cuh").is_file()
