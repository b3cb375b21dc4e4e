"""The paper's static subgraphs (Table 2): LSTM, GRU, MV, TreeLSTM, TreeGRU.

Each builder returns a :class:`CellProgram` in the DyNet idiom the paper
describes: per-gate affine ops of identical type that the batcher groups into
one batched kernel, whose weight operands the PQ planner then lays out
contiguously ("the better arrangement of the weight parameters", §5.3).
"""

from __future__ import annotations

from repro_torch.core.subgraph import CellProgram


def lstm_cell(embed: int, hidden: int) -> CellProgram:
    """y_g = W_g [x;h] + b_g for g in {i,f,g,o} — the paper's 4-gate batch."""
    p = CellProgram("LSTMCell")
    x = p.input("x", (embed,))
    h = p.input("h", (hidden,))
    c = p.input("c", (hidden,))
    W, b = {}, {}
    for g in "ifgo":  # natural per-gate declaration order (the DyNet baseline)
        W[g] = p.param(f"W{g}", (embed + hidden, hidden))
        b[g] = p.param(f"b{g}", (hidden,))
    xh = p.op("concat2", x, h, name="xh")
    y = {g: p.op("affine", xh, W[g], b[g], name=f"y{g}") for g in "ifgo"}
    i = p.op("sigmoid", y["i"], name="i")
    f = p.op("sigmoid", y["f"], name="f")
    o = p.op("sigmoid", y["o"], name="o")
    g = p.op("tanh", y["g"], name="g")
    c2 = p.op("addmul", f, c, i, g, name="c_out")
    th = p.op("tanh", c2, name="tanh_c")
    h2 = p.op("mul", o, th, name="h_out")
    p.mark_output(h2, c2)
    return p


def gru_cell(embed: int, hidden: int) -> CellProgram:
    p = CellProgram("GRUCell")
    x = p.input("x", (embed,))
    h = p.input("h", (hidden,))
    Wr = p.param("Wr", (embed + hidden, hidden))
    br = p.param("br", (hidden,))
    Wz = p.param("Wz", (embed + hidden, hidden))
    bz = p.param("bz", (hidden,))
    Wh = p.param("Wh", (embed + hidden, hidden))
    bh = p.param("bh", (hidden,))
    xh = p.op("concat2", x, h, name="xh")
    yr = p.op("affine", xh, Wr, br, name="yr")
    yz = p.op("affine", xh, Wz, bz, name="yz")
    r = p.op("sigmoid", yr, name="r")
    z = p.op("sigmoid", yz, name="z")
    rh = p.op("mul", r, h, name="rh")
    xrh = p.op("concat2", x, rh, name="xrh")
    hbar = p.op("tanh", p.op("affine", xrh, Wh, bh, name="yh"), name="hbar")
    h2 = p.op("lerp", z, h, hbar, name="h_out")
    p.mark_output(h2)
    return p


def mv_cell(hidden: int) -> CellProgram:
    """MV-RNN composition (Socher et al. 2012): vector and matrix per node."""
    p = CellProgram("MVCell")
    al = p.input("a_l", (hidden,))
    ar = p.input("a_r", (hidden,))
    Al = p.input("A_l", (hidden, hidden))
    Ar = p.input("A_r", (hidden, hidden))
    Wv = p.param("Wv", (2 * hidden, hidden))
    bv = p.param("bv", (hidden,))
    WMl = p.param("WMl", (hidden, hidden))
    WMr = p.param("WMr", (hidden, hidden))
    # vector: a_p = tanh(W [A_r a_l ; A_l a_r] + b)
    v1 = p.op("matvec", Ar, al, name="v1")
    v2 = p.op("matvec", Al, ar, name="v2")
    vv = p.op("concat2", v1, v2, name="vv")
    ap = p.op("tanh", p.op("affine", vv, Wv, bv, name="yv"), name="a_out")
    # matrix: A_p = W_Ml A_l + W_Mr A_r  (matrix-matrix bound, §5.2)
    m1 = p.op("matmat", WMl, Al, name="m1")
    m2 = p.op("matmat", WMr, Ar, name="m2")
    Ap = p.op("add", m1, m2, name="A_out")
    p.mark_output(ap, Ap)
    return p


def treelstm_leaf(embed: int, hidden: int) -> CellProgram:
    p = CellProgram("TreeLSTM-Leaf")
    x = p.input("x", (embed,))
    W, b = {}, {}
    for g in "iog":
        W[g] = p.param(f"W{g}", (embed, hidden))
        b[g] = p.param(f"b{g}", (hidden,))
    y = {g: p.op("affine", x, W[g], b[g], name=f"y{g}") for g in "iog"}
    i = p.op("sigmoid", y["i"], name="i")
    o = p.op("sigmoid", y["o"], name="o")
    g = p.op("tanh", y["g"], name="g")
    c = p.op("mul", i, g, name="c_out")
    h = p.op("mul", o, p.op("tanh", c, name="tc"), name="h_out")
    p.mark_output(h, c)
    return p


def treelstm_internal(hidden: int) -> CellProgram:
    """Binary N-ary TreeLSTM (Tai et al. 2015): per-child forget gates."""
    p = CellProgram("TreeLSTM-Internal")
    hl = p.input("h_l", (hidden,))
    hr = p.input("h_r", (hidden,))
    cl = p.input("c_l", (hidden,))
    cr = p.input("c_r", (hidden,))
    gates = ["i", "fl", "fr", "o", "g"]
    W, b = {}, {}
    for g in gates:
        W[g] = p.param(f"W{g}", (2 * hidden, hidden))
        b[g] = p.param(f"b{g}", (hidden,))
    hh = p.op("concat2", hl, hr, name="hh")
    y = {g: p.op("affine", hh, W[g], b[g], name=f"y{g}") for g in gates}
    i = p.op("sigmoid", y["i"], name="i")
    fl = p.op("sigmoid", y["fl"], name="fl")
    fr = p.op("sigmoid", y["fr"], name="fr")
    o = p.op("sigmoid", y["o"], name="o")
    g = p.op("tanh", y["g"], name="g")
    t1 = p.op("addmul", fl, cl, fr, cr, name="t1")
    t2 = p.op("mul", i, g, name="t2")
    c2 = p.op("add", t1, t2, name="c_out")
    h2 = p.op("mul", o, p.op("tanh", c2, name="tc"), name="h_out")
    p.mark_output(h2, c2)
    return p


def treegru_leaf(embed: int, hidden: int) -> CellProgram:
    p = CellProgram("TreeGRU-Leaf")
    x = p.input("x", (embed,))
    Wz = p.param("Wz", (embed, hidden))
    Wh = p.param("Wh", (embed, hidden))
    bz = p.param("bz", (hidden,))
    bh = p.param("bh", (hidden,))
    z = p.op("sigmoid", p.op("affine", x, Wz, bz, name="yz"), name="z")
    hbar = p.op("tanh", p.op("affine", x, Wh, bh, name="yh"), name="hbar")
    h = p.op("mul", z, hbar, name="h_out")
    p.mark_output(h)
    return p


def treegru_internal(hidden: int) -> CellProgram:
    p = CellProgram("TreeGRU-Internal")
    hl = p.input("h_l", (hidden,))
    hr = p.input("h_r", (hidden,))
    gates = ["z", "rl", "rr"]
    W, b = {}, {}
    for g in gates:
        W[g] = p.param(f"W{g}", (2 * hidden, hidden))
        b[g] = p.param(f"b{g}", (hidden,))
    hh = p.op("concat2", hl, hr, name="hh")
    y = {g: p.op("affine", hh, W[g], b[g], name=f"y{g}") for g in gates}
    z = p.op("sigmoid", y["z"], name="z")
    rl = p.op("sigmoid", y["rl"], name="rl")
    rr = p.op("sigmoid", y["rr"], name="rr")
    gl = p.op("mul", rl, hl, name="gl")
    gr = p.op("mul", rr, hr, name="gr")
    gg = p.op("concat2", gl, gr, name="gg")
    Wc = p.param("Wc", (2 * hidden, hidden))
    bc = p.param("bc", (hidden,))
    hbar = p.op("tanh", p.op("affine", gg, Wc, bc, name="yc"), name="hbar")
    mean = p.op("lerp", z, hl, hbar, name="h_out")
    p.mark_output(mean)
    return p


def lattice_char_lstm(embed: int, hidden: int) -> CellProgram:
    """LatticeLSTM char cell at a merge position (Zhang & Yang 2018): a plain
    LSTM cell plus a word-forget gate folding in the ending word's (h_w, c_w)."""
    p = CellProgram("LatticeCharLSTM")
    x = p.input("x", (embed,))
    h = p.input("h", (hidden,))
    c = p.input("c", (hidden,))
    hw = p.input("h_w", (hidden,))
    cw = p.input("c_w", (hidden,))
    gates = ["i", "f", "g", "o", "fw"]
    W, b = {}, {}
    for g in gates:
        W[g] = p.param(f"W{g}", (embed + hidden, hidden))
        b[g] = p.param(f"b{g}", (hidden,))
    xh = p.op("concat2", x, h, name="xh")
    y = {g: p.op("affine", xh, W[g], b[g], name=f"y{g}") for g in "ifgo"}
    # word gate looks at the word hidden state
    hwh = p.op("concat2", x, hw, name="hwh")
    yfw = p.op("affine", hwh, W["fw"], b["fw"], name="yfw")
    i = p.op("sigmoid", y["i"], name="i")
    f = p.op("sigmoid", y["f"], name="f")
    o = p.op("sigmoid", y["o"], name="o")
    fw = p.op("sigmoid", yfw, name="fw")
    g = p.op("tanh", y["g"], name="g")
    t1 = p.op("addmul", f, c, i, g, name="t1")
    t2 = p.op("mul", fw, cw, name="t2")
    c2 = p.op("add", t1, t2, name="c_out")
    h2 = p.op("mul", o, p.op("tanh", c2, name="tc"), name="h_out")
    p.mark_output(h2, c2)
    return p


def lattice_char_gru(embed: int, hidden: int) -> CellProgram:
    """LatticeGRU char cell at a merge position: GRU whose candidate folds in
    the ending word's hidden state."""
    p = CellProgram("LatticeCharGRU")
    x = p.input("x", (embed,))
    h = p.input("h", (hidden,))
    hw = p.input("h_w", (hidden,))
    Wr = p.param("Wr", (embed + hidden, hidden))
    br = p.param("br", (hidden,))
    Wz = p.param("Wz", (embed + hidden, hidden))
    bz = p.param("bz", (hidden,))
    Wh = p.param("Wh", (embed + hidden, hidden))
    bh = p.param("bh", (hidden,))
    xh = p.op("concat2", x, h, name="xh")
    r = p.op("sigmoid", p.op("affine", xh, Wr, br, name="yr"), name="r")
    z = p.op("sigmoid", p.op("affine", xh, Wz, bz, name="yz"), name="z")
    rh = p.op("mul", r, h, name="rh")
    rhw = p.op("add", rh, hw, name="rhw")       # fold the word state in
    xrh = p.op("concat2", x, rhw, name="xrh")
    hbar = p.op("tanh", p.op("affine", xrh, Wh, bh, name="yh"), name="hbar")
    h2 = p.op("lerp", z, h, hbar, name="h_out")
    p.mark_output(h2)
    return p


CELLS = {
    "LSTMCell": lambda e, h: lstm_cell(e, h),
    "GRUCell": lambda e, h: gru_cell(e, h),
    "MVCell": lambda e, h: mv_cell(h),
    "TreeLSTM-Leaf": lambda e, h: treelstm_leaf(e, h),
    "TreeLSTM-Internal": lambda e, h: treelstm_internal(h),
    "TreeGRU-Leaf": lambda e, h: treegru_leaf(e, h),
    "TreeGRU-Internal": lambda e, h: treegru_internal(h),
}
