"""The phase-profile tool's copies of the tensor-core kernels.

``repro_torch.tools.kernel_phases`` builds its copies on the card by
inserting ``clock64`` stamps at fixed lines of ``csrc/flash_attention.cu``,
``csrc/flash_attention_bwd.cu``, ``csrc/ssd_scan.cu``,
``csrc/ssd_scan_bwd.cu``, the two bf16 forwards
(``csrc/flash_attention_bf16.cu``, ``csrc/ssd_scan_bf16.cu``), the two bf16
backwards (``csrc/flash_attention_bwd_bf16.cu``,
``csrc/ssd_scan_bwd_bf16.cu``) and
``csrc/lstm_cell_tile.cuh`` (through ``csrc/fused_gather_lstm_cell.cu``) and calls each launch function from a
host program of its own. These tests run on the CPU, with no compiler:
each anchor line is found exactly once in today's source, every stamp goes
in, and each host program passes as many arguments as the launch function
takes (``kernels/build.py:SIGNATURES``). A kernel edit that moves an
anchor or a launch argument fails here, not on the card."""

import re

import pytest

pytest.importorskip("torch")

from repro_torch.kernels.build import CSRC, SIGNATURES  # noqa: E402
from repro_torch.tools import kernel_phases  # noqa: E402

# launch function -> (the source holding the anchors, its stamps, the host
# program and the instrumented copy)
_KERNELS = {
    "flash_attention": (
        "flash_attention.cu", kernel_phases.FLASH_STAMPS,
        kernel_phases.FLASH_MAIN,
        lambda: kernel_phases.instrument("flash_attention.cu",
                                         kernel_phases.FLASH_STAMPS,
                                         kernel_phases.FLASH_MAIN)),
    "flash_attention_bwd": (
        "flash_attention_bwd.cu", kernel_phases.BWD_STAMPS,
        kernel_phases.BWD_MAIN,
        lambda: kernel_phases.instrument("flash_attention_bwd.cu",
                                         kernel_phases.BWD_STAMPS,
                                         kernel_phases.BWD_MAIN)),
    "ssd_scan": (
        "ssd_scan.cu", kernel_phases.SSD_STAMPS, kernel_phases.SSD_MAIN,
        lambda: kernel_phases.instrument("ssd_scan.cu",
                                         kernel_phases.SSD_STAMPS,
                                         kernel_phases.SSD_MAIN)),
    "ssd_scan_bf16": (
        "ssd_scan_bf16.cu", kernel_phases.SSD_BF16_STAMPS,
        kernel_phases.SSD_BF16_MAIN,
        lambda: kernel_phases.instrument("ssd_scan_bf16.cu",
                                         kernel_phases.SSD_BF16_STAMPS,
                                         kernel_phases.SSD_BF16_MAIN)),
    "flash_attention_bf16": (
        "flash_attention_bf16.cu", kernel_phases.FLASH_BF16_STAMPS,
        kernel_phases.FLASH_BF16_MAIN,
        lambda: kernel_phases.instrument("flash_attention_bf16.cu",
                                         kernel_phases.FLASH_BF16_STAMPS,
                                         kernel_phases.FLASH_BF16_MAIN)),
    "ssd_scan_bwd": (
        "ssd_scan_bwd.cu", kernel_phases.SSD_BWD_STAMPS,
        kernel_phases.SSD_BWD_MAIN,
        lambda: kernel_phases.instrument("ssd_scan_bwd.cu",
                                         kernel_phases.SSD_BWD_STAMPS,
                                         kernel_phases.SSD_BWD_MAIN)),
    "flash_attention_bwd_bf16": (
        "flash_attention_bwd_bf16.cu", kernel_phases.FLASH_BWD_BF16_STAMPS,
        kernel_phases.FLASH_BWD_BF16_MAIN,
        lambda: kernel_phases.instrument("flash_attention_bwd_bf16.cu",
                                         kernel_phases.FLASH_BWD_BF16_STAMPS,
                                         kernel_phases.FLASH_BWD_BF16_MAIN)),
    "ssd_scan_bwd_bf16": (
        "ssd_scan_bwd_bf16.cu", kernel_phases.SSD_BWD_BF16_STAMPS,
        kernel_phases.SSD_BWD_BF16_MAIN,
        lambda: kernel_phases.instrument("ssd_scan_bwd_bf16.cu",
                                         kernel_phases.SSD_BWD_BF16_STAMPS,
                                         kernel_phases.SSD_BWD_BF16_MAIN)),
    "fused_gather_lstm_cell": (
        "lstm_cell_tile.cuh", kernel_phases.CELL_STAMPS,
        kernel_phases.CELL_MAIN, kernel_phases.instrument_cell),
}


@pytest.mark.parametrize("name", sorted(_KERNELS))
def test_every_anchor_is_found_once(name):
    source, stamps, _, _ = _KERNELS[name]
    text = (CSRC / source).read_text()
    for anchor, _ in stamps:
        assert text.count(anchor) == 1, anchor


@pytest.mark.parametrize("name", sorted(_KERNELS))
def test_every_stamp_goes_in(name):
    source, stamps, _, make = _KERNELS[name]
    copy = make()
    inserted = sum(insert.count("STAMP(") for _, insert in stamps)
    if stamps is kernel_phases.CELL_STAMPS:
        # some of the cell's entries insert only cycle counters
        assert inserted >= 1
    else:
        assert inserted == len(stamps)
    original = (CSRC / source).read_text().count("STAMP(")
    assert copy.count("STAMP(") - original == inserted + \
        kernel_phases.STAMP.count("STAMP(")
    for anchor, insert in stamps:
        assert insert.lstrip("+") in copy, anchor
    assert str(CSRC / "mma_tf32x3.cuh") in copy


@pytest.mark.parametrize("early", [0, 8])
def test_early_copies_rewrite_the_tiles_constant(early):
    """The tool's EARLY copies rewrite the tile's one ``EARLY`` line and
    inline the tile into the gather cell."""
    tile = (CSRC / "lstm_cell_tile.cuh").read_text()
    assert tile.count(kernel_phases.EARLY_LINE) == 1
    copy = kernel_phases.cell_with_early(early)
    assert f"constexpr int EARLY = {early};" in copy
    assert kernel_phases.EARLY_LINE not in copy
    assert '#include "lstm_cell_tile.cuh"' not in copy
    assert "fused_gather_lstm_cell_launch(" in copy


@pytest.mark.parametrize("qn,bk", [(32, 64), (64, 32)])
def test_backward_variants_rewrite_the_register_tiles(qn, bk):
    """The tool's backward copies rewrite the one QN and the one BK line
    and call the launch function with all its arguments."""
    text = (CSRC / "flash_attention_bwd.cu").read_text()
    for line in (kernel_phases.BWD_QN_LINE, kernel_phases.BWD_BK_LINE):
        assert text.count(line) == 1
    copy = kernel_phases.bwd_variant(qn, bk)
    assert f"static constexpr int QN = {qn};" in copy
    assert f"static constexpr int BK = {bk};" in copy
    assert copy.endswith(kernel_phases.BWD_VARIANTS_MAIN.replace(
        "@TAG@", f"QN={qn} BK={bk}"))
    call = re.search(r"flash_attention_bwd_launch\((.*?)\);$",
                     kernel_phases.BWD_VARIANTS_MAIN, re.S | re.M)
    assert call is not None
    assert _top_level_args(call.group(1)) == \
        len(SIGNATURES["flash_attention_bwd_launch"])


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
    _, _, main, _ = _KERNELS[name]
    # the cell's host program calls through a variadic macro: expand it
    macro = re.search(r"#define CELL_LAUNCH\(in, B, \.\.\.\) (.*?\))\n",
                      main, re.S)
    if macro is not None:
        main = macro.group(1).replace("__VA_ARGS__", "nt, cl, cpr, gx, gy")
    call = re.search(rf"{name}_launch\((.*?)\);?$", main, re.S | re.M)
    assert call is not None
    assert _top_level_args(call.group(1)) == len(SIGNATURES[f"{name}_launch"])
    source = (CSRC / f"{name}.cu").read_text()
    decl = re.search(rf"int {name}_launch\((.*?)\)\s*\{{", source, re.S)
    assert decl is not None
    assert _top_level_args(decl.group(1)) == len(SIGNATURES[f"{name}_launch"])


def test_backward_gather_variants_pass_every_launch_argument():
    """The backward gather's block-size program calls the launch function
    with all its arguments, each time, and includes its source."""
    calls = re.findall(r"gather_rows_bwd_launch\((.*?)\);",
                       kernel_phases.GATHER_BWD_MAIN, re.S)
    assert len(calls) == 2
    for call in calls:
        assert _top_level_args(call) == \
            len(SIGNATURES["gather_rows_bwd_launch"])
