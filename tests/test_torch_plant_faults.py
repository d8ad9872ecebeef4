"""``ops/plant_faults.py`` against the kernel sources, on the CPU.

The script plants each fault by replacing one text of a copy of a kernel
source, then shows on the card that the kernel-vs-plain check catches it. A
redesign of a kernel that loses such a text would leave the script stale, so
each entry's sound text must occur exactly once in its file, and a fault meant
for one kernel must lie inside that kernel's own function. The sources are
only read here.
"""

import re

import pytest

from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops.plant_faults import CASES, FAULTS, OUTPUTS

# The kernel function each wrapper launches for each input type: a fault of
# one kernel is planted there, in the type of the case it runs on.
_KERNEL = {
    ("bf16", "flash_fwd"): "flash_fwd_bf16_kernel",
    ("bf16", "flash_bwd_dkv"): "flash_bwd_dkv_bf16_kernel",
    ("bf16", "flash_bwd_dq"): "flash_bwd_dq_bf16_kernel",
    ("f32", "flash_fwd"): "flash_fwd_kernel",
    ("f32", "flash_bwd_dkv"): "flash_bwd_dkv_kernel",
    ("f32", "flash_bwd_dq"): "flash_bwd_dq_kernel",
}


def _body(text: str, function: str) -> tuple[int, int]:
    """[start, end) of the definition of `function` in `text`: from its name
    to the first closing brace at the start of a line."""
    m = re.search(rf"\b{function}\(", text)
    assert m, f"{function} not found"
    return m.start(), text.index("\n}\n", m.start())


@pytest.mark.parametrize("name", sorted(FAULTS))
def test_fault_text_occurs_once_in_its_source(name):
    file, old, new, case, broken = FAULTS[name]
    text = (_build.CSRC / file).read_text()
    assert text.count(old) == 1, f"{name}: {old!r} is in {file} {text.count(old)} times"
    assert old != new and case in CASES and broken and set(broken) <= set(OUTPUTS)
    if len(broken) == 1:  # a fault of one kernel is planted in that kernel, of the case's type
        kernel = _KERNEL[CASES[case][0], broken[0]]
        start, end = _body(text, kernel)
        assert start < text.index(old) < end, f"{name}: not inside {kernel}"
