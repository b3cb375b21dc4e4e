"""The phase-profile tool's copies of the attention and scan kernels.

``repro_torch.tools.kernel_phases`` builds its copies on the card by
inserting ``clock64`` stamps at fixed lines of ``csrc/flash_attention.cu``
and ``csrc/ssd_scan.cu`` and calls each launch function from a host
program of its own. These tests run on the CPU, with no compiler: each
anchor line is found exactly once in today's source, every stamp goes in,
and each host program passes as many arguments as the launch function
takes (``kernels/build.py:SIGNATURES``). A kernel edit that moves an
anchor or a launch argument fails here, not on the card."""

import re

import pytest

pytest.importorskip("torch")

from repro_torch.kernels.build import CSRC, SIGNATURES  # noqa: E402
from repro_torch.tools import kernel_phases  # noqa: E402

_KERNELS = {
    "flash_attention": (kernel_phases.FLASH_STAMPS, kernel_phases.FLASH_MAIN),
    "ssd_scan": (kernel_phases.SSD_STAMPS, kernel_phases.SSD_MAIN),
}


@pytest.mark.parametrize("name", sorted(_KERNELS))
def test_every_anchor_is_found_once(name):
    stamps, _ = _KERNELS[name]
    text = (CSRC / f"{name}.cu").read_text()
    for anchor, _ in stamps:
        assert text.count(anchor) == 1, anchor


@pytest.mark.parametrize("name", sorted(_KERNELS))
def test_every_stamp_goes_in(name):
    stamps, main = _KERNELS[name]
    copy = kernel_phases.instrument(f"{name}.cu", stamps, main)
    inserted = sum(insert.count("STAMP(") for _, insert in stamps)
    assert inserted == len(stamps)
    original = (CSRC / f"{name}.cu").read_text().count("STAMP(")
    assert copy.count("STAMP(") - original == inserted + \
        kernel_phases.STAMP.count("STAMP(")
    assert str(CSRC / "mma_tf32x3.cuh") in copy


def _top_level_args(call: str) -> int:
    """The number of arguments in ``call``, the text between a call's
    parentheses."""
    depth, count = 0, 1
    for ch in call:
        if ch in "([{":
            depth += 1
        elif ch in ")]}":
            depth -= 1
        elif ch == "," and depth == 0:
            count += 1
    return count


@pytest.mark.parametrize("name", sorted(_KERNELS))
def test_host_program_passes_every_launch_argument(name):
    _, main = _KERNELS[name]
    call = re.search(rf"{name}_launch\((.*?)\);", main, re.S)
    assert call is not None
    assert _top_level_args(call.group(1)) == len(SIGNATURES[f"{name}_launch"])
    source = (CSRC / f"{name}.cu").read_text()
    decl = re.search(rf"int {name}_launch\((.*?)\)\s*\{{", source, re.S)
    assert decl is not None
    assert _top_level_args(decl.group(1)) == len(SIGNATURES[f"{name}_launch"])
