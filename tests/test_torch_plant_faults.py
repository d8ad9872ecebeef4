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

# The kernel function each wrapper launches for bf16 inputs, where the faults
# are planted.
_BF16_KERNEL = {
    "flash_fwd": "flash_fwd_bf16_kernel",
    "flash_bwd_dkv": "flash_bwd_dkv_bf16_kernel",
    "flash_bwd_dq": "flash_bwd_dq_bf16_kernel",
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
    if len(broken) == 1:  # a fault of one kernel is planted in that kernel
        start, end = _body(text, _BF16_KERNEL[broken[0]])
        assert start < text.index(old) < end, f"{name}: not inside {_BF16_KERNEL[broken[0]]}"
