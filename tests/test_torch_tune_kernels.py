"""``ops/_build.edited_copy`` and the variant table of ``ops/tune_kernels.py``,
on the CPU (the sources are read and copied, never built here)."""

import pytest

from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops.tune_kernels import VARIANTS


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_variant_edits_each_find_their_text_once(name):
    for file, old, new in VARIANTS[name][1]:
        assert (_build.CSRC / file).read_text().count(old) == 1, f"{name}: {old!r} in {file}"
        assert old != new


def test_edited_copy_applies_each_edit_and_copies_the_rest(tmp_path):
    edit = ("flash_fwd.cu", "constexpr int kFwdBQ = 64;", "constexpr int kFwdBQ = 128;")
    dst = _build.edited_copy(tmp_path / "csrc", [edit])
    sources = sorted(p.name for p in _build.CSRC.iterdir() if p.suffix in (".cu", ".cuh"))
    assert sorted(p.name for p in dst.iterdir()) == sources
    fwd = (dst / "flash_fwd.cu").read_text()
    assert edit[2] in fwd and edit[1] not in fwd
    for name in sources:
        if name != "flash_fwd.cu":
            assert (dst / name).read_text() == (_build.CSRC / name).read_text()


def test_edited_copy_refuses_a_text_it_cannot_find(tmp_path):
    with pytest.raises(RuntimeError, match="exactly once"):
        _build.edited_copy(tmp_path / "csrc", [("flash_fwd.cu", "no such line", "x")])
