"""The kernels' own work (``repro_torch.kernels.costs``) and how the
dry-run's step counter (``launch/dryrun.py:StepCounter``) counts it.

On the meta device each kernel wrapper takes the card's route and its plain
version stands in for the launch: a traced call must count the kernel's
``(flops, bytes)`` exactly, not the plain version's ops (the plain
attention writes the full score matrix and computes the masked half),
bfloat16 operands at 2 bytes an element and what stays float32 (the
log-sum-exp, the scan's A and states) at 4; a bf16 scan saves no chunk
states for its backward, which recomputes them. The attention pair count is
held against the mask it describes, element by element."""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import costs, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402
from repro_torch.kernels.fused_cell import fused_lstm_cell  # noqa: E402
from repro_torch.kernels.fused_gather_cell import \
    fused_gather_lstm_cell  # noqa: E402
from repro_torch.kernels.gather_batch import (gather_rows,  # noqa: E402
                                              gather_rows_backward)
from repro_torch.launch.dryrun import StepCounter, trace_counts  # noqa: E402


def m(*shape, dtype=torch.float32, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta",
                       requires_grad=grad)


@pytest.mark.parametrize("Sq,Skv,causal,window", [
    (24, 24, True, 0), (24, 24, True, 5), (1, 40, True, 0), (7, 30, True, 4),
    (30, 7, True, 0), (30, 7, True, 3), (16, 16, True, 16),
    (16, 16, True, 40), (9, 13, False, 0)])
def test_attention_pairs_count_the_mask(Sq, Skv, causal, window):
    want = (int(ref.attention_mask(Sq, Skv, window).sum()) if causal
            else Sq * Skv)
    assert costs.attention_pairs(Sq, Skv, causal, window) == want


def _flash_train(q, kv):
    out = fa.flash_attention(q, kv, kv)
    torch.autograd.grad(out, (q, kv), torch.empty_like(out))


def _ssd_train(x, dt, A, BC):
    y, _ = ss.ssd_scan(x, dt, A, BC, BC, 16)
    torch.autograd.grad(y, (x,), torch.empty_like(y))


def _gather_train(src, idx):
    out = gather_rows(src, idx)
    torch.autograd.grad(out, (src,), torch.empty_like(out))


def _bf16_cases():
    """The bfloat16 forms of the attention and scan cases."""
    bf = torch.bfloat16
    q, kv = m(2, 24, 8, 16, dtype=bf), m(2, 24, 2, 16, dtype=bf)
    x, dt, A, BC = (m(2, 32, 4, 8, dtype=bf), m(2, 32, 4, dtype=bf), m(4),
                    m(2, 32, 1, 16, dtype=bf))
    lse = costs.flash_attention(2, 24, 24, 8, 2, 16, True, 0, True, 2)
    bwd = costs.flash_attention_backward(2, 24, 24, 8, 2, 16, True, 0, 2)
    # the bf16 backward recomputes the chunks' start states in fp32, so
    # the bf16 forward saves none and the backward reads none
    sfwd = costs.ssd_scan(2, 32, 4, 8, 1, 16, 16, False, False, 2)
    sbwd = costs.ssd_scan_backward(2, 32, 4, 8, 1, 16, 16, False, False,
                                   False, 2)
    qg = m(2, 24, 8, 16, dtype=bf, grad=True)
    kvg = m(2, 24, 2, 16, dtype=bf, grad=True)
    kv_grad_sum = 3 * 2 * 24 * 2 * 16 * 2   # dk + dv, bf16

    def add(*cs):
        return tuple(map(sum, zip(*cs)))

    return {
        "flash_attention bf16": (
            lambda: fa.flash_attention(q, kv, kv),
            costs.flash_attention(2, 24, 24, 8, 2, 16, True, 0, False, 2),
            0),
        "flash_attention train bf16": (lambda: _flash_train(qg, kvg),
                                       add(lse, bwd), kv_grad_sum),
        "ssd_scan bf16": (
            lambda: ss.ssd_scan(x, dt, A, BC, BC, 16),
            costs.ssd_scan(2, 32, 4, 8, 1, 16, 16, False, False, 2), 0),
        "ssd_scan train bf16": (
            lambda: _ssd_train(m(2, 32, 4, 8, dtype=bf, grad=True), dt, A,
                               BC),
            add(sfwd, sbwd), 0),
    }


def _cases():
    """name -> (call on meta, the kernels' summed costs, extra bytes the
    trace moves outside the kernels)."""
    q, kv = m(2, 24, 8, 16), m(2, 24, 2, 16)
    x, dt, A, BC = m(2, 32, 4, 8), m(2, 32, 4), m(4), m(2, 32, 1, 16)
    idx = m(7, dtype=torch.int32)
    fwd = costs.flash_attention(2, 24, 24, 8, 2, 16, True, 0)
    lse = costs.flash_attention(2, 24, 24, 8, 2, 16, True, 0, True)
    bwd = costs.flash_attention_backward(2, 24, 24, 8, 2, 16, True, 0)
    sfwd = costs.ssd_scan(2, 32, 4, 8, 1, 16, 16, False, False)
    sfwd_states = costs.ssd_scan(2, 32, 4, 8, 1, 16, 16, False, True)
    sbwd = costs.ssd_scan_backward(2, 32, 4, 8, 1, 16, 16, False, False,
                                   True)
    g = costs.gather_rows(7, 48, 4)
    gb = costs.gather_rows_backward(7, 50, 48, 4)
    qg, kvg = m(2, 24, 8, 16, grad=True), m(2, 24, 2, 16, grad=True)
    kv_grad_sum = 3 * 2 * 24 * 2 * 16 * 4   # dk + dv into kv's one gradient

    def add(*cs):
        return tuple(map(sum, zip(*cs)))

    return {
        "flash_attention": (lambda: fa.flash_attention(q, kv, kv), fwd, 0),
        "flash_attention window": (
            lambda: fa.flash_attention(q, kv, kv, True, 5),
            costs.flash_attention(2, 24, 24, 8, 2, 16, True, 5), 0),
        "flash_attention cross": (
            lambda: fa.flash_attention(m(2, 5, 8, 16), kv, kv, False),
            costs.flash_attention(2, 5, 24, 8, 2, 16, False, 0), 0),
        "flash_attention train": (lambda: _flash_train(qg, kvg),
                                  add(lse, bwd), kv_grad_sum),
        "ssd_scan": (lambda: ss.ssd_scan(x, dt, A, BC, BC, 16), sfwd, 0),
        "ssd_scan train": (
            lambda: _ssd_train(m(2, 32, 4, 8, grad=True), dt, A, BC),
            add(sfwd_states, sbwd), 0),
        "gather_rows": (lambda: gather_rows(m(50, 12), idx), g, 0),
        "gather_rows train": (
            lambda: _gather_train(m(50, 12, grad=True), idx), add(g, gb), 0),
        "gather_rows_backward": (
            lambda: gather_rows_backward(m(7, 12), idx, 50), gb, 0),
        "fused_lstm_cell": (
            lambda: fused_lstm_cell(m(3, 40), m(40, 64), m(64), m(3, 16)),
            costs.fused_lstm_cell(3, 40, 16), 0),
        "fused_gather_lstm_cell": (
            lambda: fused_gather_lstm_cell(
                m(9, 24), m(5, 16), m(5, 16), m(3, dtype=torch.int32),
                m(3, dtype=torch.int32), m(3, dtype=torch.int32), m(40, 64),
                m(64)),
            costs.fused_gather_lstm_cell(3, 24, 16), 0),
        **_bf16_cases(),
    }


@pytest.mark.parametrize("name", list(_cases()))
def test_a_traced_wrapper_counts_its_kernels_work(name):
    call, (flops, nbytes), extra = _cases()[name]
    assert trace_counts(call) == (flops, nbytes + extra)


def test_costs_count_operands_at_their_element_size():
    """bf16 operands move half an fp32 operand's bytes; the log-sum-exp,
    A and the scan's states stay 4 bytes; FLOPs do not change."""
    B, Sq, Skv, H, KV, D = 2, 24, 30, 8, 2, 16
    operands = 2 * B * Sq * H * D + 2 * B * Skv * KV * D
    f4 = costs.flash_attention(B, Sq, Skv, H, KV, D, True, 0, True)
    f2 = costs.flash_attention(B, Sq, Skv, H, KV, D, True, 0, True, 2)
    assert f4[0] == f2[0]
    assert (f4[1], f2[1]) == (4 * operands + 4 * B * H * Sq,
                              2 * operands + 4 * B * H * Sq)
    grads = 2 * operands
    b4 = costs.flash_attention_backward(B, Sq, Skv, H, KV, D, True, 0)
    b2 = costs.flash_attention_backward(B, Sq, Skv, H, KV, D, True, 0, 2)
    assert b4[1] - b2[1] == 2 * grads and b4[0] == b2[0]
    b, l, h, p, g, n, c = 2, 32, 4, 8, 1, 16, 16
    seq = 2 * b * l * h * p + b * l * h + 2 * b * l * g * n
    fixed = h + b * h * p * n * (1 + 1 + l // c)   # A, init, final, states
    s4 = costs.ssd_scan(b, l, h, p, g, n, c, True, True)
    s2 = costs.ssd_scan(b, l, h, p, g, n, c, True, True, 2)
    assert (s4[1], s2[1]) == (4 * seq + 4 * fixed, 2 * seq + 4 * fixed)
    assert s4[0] == s2[0]
    bseq = 3 * b * l * h * p + 2 * b * l * h + 4 * b * l * g * n
    k4 = costs.ssd_scan_backward(b, l, h, p, g, n, c, True, True, True)
    k2 = costs.ssd_scan_backward(b, l, h, p, g, n, c, True, True, True, 2)
    assert k4[1] - k2[1] == 2 * bseq and k4[0] == k2[0]
    assert costs.fused_lstm_cell(3, 40, 16, 2)[1] * 2 == \
        costs.fused_lstm_cell(3, 40, 16)[1]
    c4 = costs.fused_gather_lstm_cell(3, 24, 16)[1]
    c2 = costs.fused_gather_lstm_cell(3, 24, 16, 2)[1]
    assert c4 - 3 * 3 * 4 == 2 * (c2 - 3 * 3 * 4)   # int32 indices stay


def test_the_plain_version_is_counted_only_outside_a_stand_in():
    """Without the stand-in the plain attention's full score matrix would
    be counted; inside one nothing of it is."""
    q, kv = m(2, 24, 8, 16), m(2, 24, 2, 16)
    plain = trace_counts(lambda: ref.flash_attention_ref(q, kv, kv))
    kernel = costs.flash_attention(2, 24, 24, 8, 2, 16, True, 0)
    assert plain[0] == 4 * 16 * 2 * 8 * 24 * 24 > kernel[0]
    assert plain[1] > kernel[1]
    assert ref.RECKONER is None
    counter = StepCounter()
    ref.RECKONER = counter
    try:
        with counter:
            with ref.stand_in(lambda: (5, 7)):
                ref.flash_attention_ref(q, kv, kv)
    finally:
        ref.RECKONER = None
    assert (counter.flops, counter.bytes) == (5, 7)


def test_stand_in_does_nothing_outside_a_trace():
    called = []
    with ref.stand_in(lambda: called.append(1) or (1, 1)):
        pass
    assert not called
