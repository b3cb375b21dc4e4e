"""The row gather's backward on the CPU, and training through the
dynamic-graph executors.

The plain backward (``kernels/ref.py:gather_rows_bwd_ref``) against
autograd of ``src[idx]`` and against ``jax.vjp`` of the JAX package's
``gather_rows``; replays of ``csrc/gather_rows_bwd.cu``'s two paths in
torch (one launch: each block's compaction of the pairs landing in its
rows in ascending k, the stable counting sort by row, the row sums; the
sort: the 2048-key bitonic tiles, the pairwise merges by binary search,
and the row sums over each row's run of keys, in ascending k), and where
:func:`backward_geometry` puts the threshold between them; the autograd
``Function``'s bookkeeping (it saves the index vector and never ``src``);
and TreeGRU trained through ``DynamicExecutor`` (``examples/
tree_classifier_torch.py``) against the same steps through the JAX
package's executor with ``jax.value_and_grad``, and through
``CompiledPlan``."""

import importlib.util
import math
import random
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.kernels import gather_batch as jax_gather  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.gather_batch import (  # noqa: E402
    ONE_PASS_MAX_K, ONE_PASS_THREADS, GatherRowsFunction, backward_geometry,
    gather_geometry, gather_rows, gather_rows_backward)

ROOT = Path(__file__).resolve().parents[1]
SORT_TILE = 2048    # csrc/gather_rows_bwd.cu: most keys a sort block takes

# name: (src shape, K, repeats, negatives)
CASES = {
    "no repeats": ((64, 16), 32, False, False),
    "repeats": ((64, 16), 48, True, False),
    "repeats and negatives": ((40, 12), 60, True, True),
    "flat (d, d) rows": ((30, 5, 5), 25, True, True),
    "ragged 17": ((50, 17), 70, True, True),
    "K > one sort tile": ((300, 3), 5000, True, True),
    "K = 0": ((10, 8), 0, False, False),
}


def make(shape, K, repeats, negatives, seed=0, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    N = shape[0]
    if repeats:
        idx = rng.integers(0, N, K)
        idx[: K // 3] = idx[0]
    else:
        idx = rng.permutation(N)[:K]
    if negatives and K:
        flip = rng.random(K) < 0.4
        idx = np.where(flip, idx - N, idx)
    src = torch.as_tensor(rng.standard_normal(shape), dtype=dtype)
    dout = torch.as_tensor(rng.standard_normal((K,) + shape[1:]),
                           dtype=dtype)
    return src, torch.as_tensor(idx, dtype=torch.int32), dout


def _zero(shape, dtype):
    """The kernel's accumulator: a bf16 sum is held in fp32 registers."""
    return torch.zeros(shape, dtype=torch.float32 if dtype == torch.bfloat16
                       else dtype)


def _accumulate(acc, v):
    """One add of the kernel's sum: fp32 as it is; bf16 in an fp32
    register, rounded to bf16 after the add
    (``csrc/gather_rows_bwd.cu``: ``Sum<uint4>``, ``Sum<__nv_bfloat16>``)."""
    if v.dtype == torch.bfloat16:
        return (acc + v.float()).to(torch.bfloat16).float()
    return acc + v


def replay_backward(dout, idx, n_rows):
    """csrc/gather_rows_bwd.cu step by step: keys (row << 32 | k) sorted in
    bitonic tiles (the next power of two of K, at most 2048 keys), merged
    pairwise (each key placed at its index in its run plus the count of
    smaller keys in the partner run), then each row of dsrc the sum, in
    order, of its run's dout rows (in bf16 rounded after every add)."""
    K = idx.shape[0]
    rows = torch.where(idx < 0, idx + n_rows, idx).long()
    assert bool(((rows >= 0) & (rows < n_rows)).all())
    keys = (rows << 32) | torch.arange(K)
    pad = torch.iinfo(torch.int64).max
    tile = 2
    while tile < K and tile < SORT_TILE:
        tile *= 2
    runs = []
    for base in range(0, K, tile):
        s = torch.full((tile,), pad, dtype=torch.int64)
        part = keys[base:base + tile]
        s[:part.shape[0]] = part
        size = 2
        while size <= tile:
            stride = size // 2
            while stride > 0:
                t = torch.arange(tile // 2)
                lo = 2 * t - (t & (stride - 1))
                hi = lo + stride
                up = (lo & size) == 0
                a, b = s[lo], s[hi]
                swap = (a > b) == up
                s[lo] = torch.where(swap, b, a)
                s[hi] = torch.where(swap, a, b)
                stride //= 2
            size *= 2
        runs.append(s[:part.shape[0]])
    cur = torch.cat(runs) if runs else keys
    width = SORT_TILE
    while width < K:
        out = torch.empty_like(cur)
        for i in range(K):
            run, j = divmod(i, width)
            other = run ^ 1
            os_ = other * width
            part = cur[os_:os_ + width] if os_ < K else cur[:0]
            below = int(torch.searchsorted(part, cur[i]))
            out[min(run, other) * width + j + below] = cur[i]
        cur, width = out, width * 2
    assert torch.equal(cur, torch.sort(keys).values)
    dsrc = torch.zeros((n_rows,) + tuple(dout.shape[1:]), dtype=dout.dtype)
    for r in range(n_rows):
        lo = int(torch.searchsorted(cur, torch.tensor(r << 32)))
        hi = int(torch.searchsorted(cur, torch.tensor((r + 1) << 32)))
        acc = _zero(dout.shape[1:], dout.dtype)
        for e in range(lo, hi):
            acc = _accumulate(acc, dout[int(cur[e]) & 0xFFFFFFFF])
        dsrc[r] = acc
    return dsrc


def replay_one_pass(dout, idx, n_rows, rows):
    """csrc/gather_rows_bwd.cu's one-launch path, block by block: the pairs
    (local row, k) landing in the block's ``rows`` rows, compacted in the
    order of the (chunk, warp) groups (chunk i, warp w holding k = 256 i +
    32 w + lane), lanes in order within a group; each row's count and its
    prefix; the pairs placed 32 at a time in list order, equal rows within
    the 32 in lane order; then each row the sum of its run in order (zero
    for an empty run; in bf16 rounded after every add)."""
    K = idx.shape[0]
    assert K <= ONE_PASS_MAX_K
    flat = dout.reshape(K, math.prod(dout.shape[1:]))
    target = torch.where(idx < 0, idx + n_rows, idx).long()
    assert bool(((target >= 0) & (target < n_rows)).all())
    dsrc = torch.empty((n_rows, flat.shape[1]), dtype=dout.dtype)
    warps = ONE_PASS_THREADS // 32
    for r0 in range(0, n_rows, rows):
        nrows = min(rows, n_rows - r0)
        pairs = []
        for i in range(ONE_PASS_MAX_K // ONE_PASS_THREADS):
            for w in range(warps):
                for lane in range(32):
                    kk = i * ONE_PASS_THREADS + 32 * w + lane
                    if kk < K and r0 <= int(target[kk]) < r0 + nrows:
                        pairs.append((int(target[kk]) - r0, kk))
        ks = [kk for _, kk in pairs]
        assert ks == sorted(ks)   # the compaction keeps ascending k
        start = [0] * (nrows + 1)
        for lr, _ in pairs:
            start[lr + 1] += 1
        for r in range(nrows):
            start[r + 1] += start[r]
        cursor, runk = list(start), [None] * len(pairs)
        for base in range(0, len(pairs), 32):
            chunk = pairs[base:base + 32]
            for lane, (lr, kk) in enumerate(chunk):
                rank = sum(1 for lr2, _ in chunk[:lane] if lr2 == lr)
                runk[cursor[lr] + rank] = kk
            for lr in {lr for lr, _ in chunk}:
                cursor[lr] += sum(1 for lr2, _ in chunk if lr2 == lr)
        assert cursor[:nrows] == start[1:]
        for lr in range(nrows):
            acc = _zero(flat.shape[1], dout.dtype)
            for j in range(start[lr], start[lr + 1]):
                acc = _accumulate(acc, flat[runk[j]])
            dsrc[r0 + lr] = acc
    return dsrc.reshape((n_rows,) + tuple(dout.shape[1:]))


def threshold(n_rows, row_bytes, unit=16) -> int:
    """The largest K that takes the one-launch path at this shape."""
    k = 0
    while k < ONE_PASS_MAX_K and backward_geometry(
            k + 1, n_rows, row_bytes, unit)["path"] == "one pass":
        k += 1
    return k


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_autograd_within_1e5(case):
    shape, K, rep, neg = CASES[case]
    src, idx, dout = make(shape, K, rep, neg)
    leaf = src.clone().requires_grad_(True)
    want, = torch.autograd.grad(leaf[idx.long()], leaf, dout)
    got = ref.gather_rows_bwd_ref(dout, idx, shape[0])
    assert got.shape == src.shape
    assert float((got - want).abs().max()) <= 1e-5 * max(
        float(want.abs().max()), 1e-30)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_jax_vjp_within_1e4(case):
    """``repro.kernels.gather_batch.gather_rows`` on the CPU route
    (``jnp.take``), differentiated by ``jax.vjp``."""
    shape, K, rep, neg = CASES[case]
    src, idx, dout = make(shape, K, rep, neg)
    _, vjp = jax.vjp(lambda s: jax_gather.gather_rows(s, jnp.asarray(
        idx.numpy())), jnp.asarray(src.numpy()))
    want = torch.as_tensor(np.array(vjp(jnp.asarray(dout.numpy()))[0]))
    got = ref.gather_rows_bwd_ref(dout, idx, shape[0])
    assert float((got - want).abs().max()) <= 1e-4 * max(
        float(want.abs().max()), 1.0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_replayed_kernel_is_bit_equal_to_the_plain_backward(case):
    """The kernel sums each row's sources in ascending k, as the plain
    version's CPU ``index_add_`` does: float32 results are bit-equal."""
    shape, K, rep, neg = CASES[case]
    if K > SORT_TILE:
        shape, K = (60, 3), 2 * SORT_TILE + 300   # three runs, two passes
    src, idx, dout = make(shape, K, rep, neg, seed=2)
    got = replay_backward(dout, idx, shape[0])
    assert torch.equal(got, ref.gather_rows_bwd_ref(dout, idx, shape[0]))


@pytest.mark.parametrize("case", sorted(CASES))
def test_replayed_one_pass_is_bit_equal_to_the_plain_backward(case):
    """The one-launch path sums each row's run in ascending k too: float32
    results bit-equal to the plain version's CPU ``index_add_``, at the
    rows a block takes at this shape (and, past the pairs a block holds,
    at the largest K it takes)."""
    shape, K, rep, neg = CASES[case]
    K = min(K, ONE_PASS_MAX_K)
    src, idx, dout = make(shape, K, rep, neg, seed=4)
    row_bytes = 4 * src[0].numel()
    unit = 16 if row_bytes % 16 == 0 else 4
    plan = backward_geometry(K, shape[0], row_bytes, unit)
    rows = plan.get("rows_per_block", 3)
    got = replay_one_pass(dout, idx, shape[0], rows)
    assert torch.equal(got, ref.gather_rows_bwd_ref(dout, idx, shape[0]))


@pytest.mark.parametrize("case", sorted(CASES))
def test_replayed_bf16_kernel_is_bit_equal_to_the_plain_backward(case):
    """The bf16 kernel's sort path, replayed: each row's run in ascending
    k from zero, rounded to bf16 after every add, gives the bf16 plain
    version's bits (which are the reference's gradient's)."""
    shape, K, rep, neg = CASES[case]
    if K > SORT_TILE:
        shape, K = (60, 3), 2 * SORT_TILE + 300   # three runs, two passes
    src, idx, dout = make(shape, K, rep, neg, seed=6, dtype=torch.bfloat16)
    got = replay_backward(dout, idx, shape[0])
    want = ref.gather_rows_bwd_ref(dout, idx, shape[0])
    assert got.dtype == want.dtype == torch.bfloat16
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_replayed_bf16_one_pass_is_bit_equal_to_the_plain_backward(case):
    """The bf16 kernel's one-launch path, replayed at the rows a block
    takes at this shape in bf16 units (16 bytes where the row allows, else
    2): the bf16 plain version's bits."""
    shape, K, rep, neg = CASES[case]
    K = min(K, ONE_PASS_MAX_K)
    src, idx, dout = make(shape, K, rep, neg, seed=7, dtype=torch.bfloat16)
    row_bytes = 2 * src[0].numel()
    unit = 16 if row_bytes % 16 == 0 else 2
    plan = backward_geometry(K, shape[0], row_bytes, unit)
    rows = plan.get("rows_per_block", 3)
    got = replay_one_pass(dout, idx, shape[0], rows)
    assert torch.equal(got, ref.gather_rows_bwd_ref(dout, idx, shape[0]))


def test_bf16_backward_paths_at_the_moe_shapes():
    """Granite's bf16 train shapes (2048-byte rows) sort, as fp32's 4096-
    byte ones do; 2 KB bf16 rows take four a block on the one-launch path
    at K up to 2048; a row of 2-byte units takes at most ONE_PASS_UNITS a
    thread from the start (1023 bf16: two rows a block, where 8 KB would
    be four)."""
    assert backward_geometry(10240, 1344, 2048, 16) == {"path": "sort"}
    assert backward_geometry(8192, 11264, 2048, 16) == {"path": "sort"}
    assert backward_geometry(2048, 2048, 2048, 16) == {
        "path": "one pass", "rows_per_block": 4, "blocks": 512}
    assert backward_geometry(300, 513, 2046, 2) == {
        "path": "one pass", "rows_per_block": 2, "blocks": 257}
    # fp32's 4-byte units start where they did: 8 KB of rows a block
    assert backward_geometry(300, 513, 4092, 4)["rows_per_block"] == 2
    assert backward_geometry(300, 513, 68, 4)["rows_per_block"] == 120


# (n_src, row floats, K, index pattern): the threshold's edges, a last
# block holding fewer rows, every index on one row, negative indices, the
# bucketed executor's trash row (the last, as -1)
EDGES = {
    "K at the threshold, 64-byte rows": (300, 16, None, "repeats"),
    "K one above the threshold, 64-byte rows": (300, 16, 1, "repeats"),
    "n_src not a multiple of a block's rows": (301, 16, 200, "repeats"),
    "every index on one row": (150, 16, 300, "one row"),
    "negative indices": (97, 12, 150, "negatives"),
    "trash row": (130, 16, 180, "trash"),
}


def edge_inputs(n_src, width, K, pattern, seed=5):
    rng = np.random.default_rng(seed)
    if pattern == "one row":
        idx = np.full(K, rng.integers(0, n_src))
    elif pattern == "trash":
        idx = rng.integers(0, n_src - 1, K)
        idx[rng.random(K) < 0.5] = -1
    else:
        idx = rng.integers(0, n_src, K)
        if pattern == "negatives":
            idx = np.where(rng.random(K) < 0.5, idx - n_src, idx)
    dout = torch.as_tensor(rng.standard_normal((K, width)),
                           dtype=torch.float32)
    return torch.as_tensor(idx, dtype=torch.int32), dout


@pytest.mark.parametrize("case", sorted(EDGES))
def test_one_pass_edges_are_bit_equal_to_the_plain_backward(case):
    """At the threshold the one-launch path, one above it the sort; both
    give the plain version's bits."""
    n_src, width, K, pattern = EDGES[case]
    row_bytes = 4 * width
    if "threshold" in case:
        K = threshold(n_src, row_bytes) + (K or 0)
    idx, dout = edge_inputs(n_src, width, K, pattern)
    plan = backward_geometry(K, n_src, row_bytes, 16)
    want = ref.gather_rows_bwd_ref(dout, idx, n_src)
    if plan["path"] == "one pass":
        got = replay_one_pass(dout, idx, n_src, plan["rows_per_block"])
    else:
        got = replay_backward(dout, idx, n_src)
    assert torch.equal(got, want)
    if "above" in case:
        assert plan["path"] == "sort"
    else:
        assert plan["path"] == "one pass"
        if case.startswith("n_src"):
            assert n_src % plan["rows_per_block"] != 0


def test_backward_paths_at_the_paths_shapes():
    """2 KB rows into 2048: one launch, four rows a block, at every K a
    block can hold (the index rule's bound is 2048 there too); into 4096
    rows four a block up to the index rule's 1365, eight past it; the sort
    past 2048 and for 5000 indices into narrow rows (phase 10 (a)'s
    cases)."""
    def path(k, n=2048, row_bytes=2048):
        return backward_geometry(k, n, row_bytes, 16)
    assert path(1) == path(256) == path(2048) == {
        "path": "one pass", "rows_per_block": 4, "blocks": 512}
    assert path(1365, 4096) == {
        "path": "one pass", "rows_per_block": 4, "blocks": 1024}
    assert path(1366, 4096) == {
        "path": "one pass", "rows_per_block": 8, "blocks": 512}
    assert path(2049) == {"path": "sort"}
    assert path(5000, 8192, 64) == {"path": "sort"}
    assert threshold(2048, 2048) == threshold(300, 64) == ONE_PASS_MAX_K
    # where the index reads decide: 4-byte rows, many of them, 2048 a block
    # at most: 49 blocks read 196 K bytes against 4 (K + 100000)
    assert threshold(100000, 4, unit=4) == 1030
    assert backward_geometry(1030, 100000, 4, 4) == {
        "path": "one pass", "rows_per_block": 2048, "blocks": 49}
    for k, n, rb in ((7, 300, 64), (0, 5, 4096), (2048, 1, 4)):
        plan = path(k, n, rb)
        if plan["path"] == "one pass":
            assert 2 * plan["blocks"] * k * 4 <= (k + n) * rb
            assert plan["rows_per_block"] * (rb // 16) <= 8 * 256 or \
                plan["rows_per_block"] == 1


def test_plain_backward_raises_on_an_index_out_of_range():
    with pytest.raises(IndexError):
        ref.gather_rows_bwd_ref(torch.zeros(2, 3),
                                torch.tensor([0, 5], dtype=torch.int32), 4)


@pytest.mark.parametrize("n_rows,row_bytes,unit", [
    (2048, 2048, 16), (300, 12, 4), (50, 68, 4), (1, 2048, 16),
    (150000, 2048, 16)])
def test_backward_geometry_covers_every_row_of_dsrc(n_rows, row_bytes, unit):
    """The sum kernel runs the gather's geometry over dsrc's rows: every
    (row, unit) pair is owned by exactly one thread of the grid-stride
    loops."""
    geo = gather_geometry(n_rows, row_bytes, unit)
    upr = row_bytes // unit
    assert geo["tc"] * geo["r"] <= 256
    assert geo["row_tiles"] * geo["r"] >= n_rows
    assert geo["unit_tiles"] * geo["tc"] * geo["v"] >= upr
    assert (geo["row_tiles"] - 1) * geo["r"] < n_rows


def test_function_saves_the_indices_and_never_src():
    """GatherRowsFunction keeps idx and src's shape only, so an in-place
    write to src after the gather (as the executors write their arenas)
    leaves its backward intact."""
    src, idx, dout = make((20, 4, 3), 30, True, True)
    leaf = src.clone().requires_grad_(True)
    buf = leaf * 1.0
    out = GatherRowsFunction.apply(buf, idx)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 1 and saved[0] is idx
    buf.mul_(2.0)                       # bumps buf's version
    got, = torch.autograd.grad(out, leaf, dout)
    assert torch.equal(got, ref.gather_rows_bwd_ref(dout, idx, 20))


def test_cpu_wrappers_take_the_plain_versions():
    src, idx, dout = make((16, 8), 12, True, True)
    before = (gather_rows.launches, gather_rows_backward.launches)
    assert torch.equal(gather_rows_backward(dout, idx, 16),
                       ref.gather_rows_bwd_ref(dout, idx, 16))
    leaf = src.clone().requires_grad_(True)
    out = gather_rows(leaf, idx)
    assert "GatherRows" not in type(out.grad_fn).__name__
    assert (gather_rows.launches, gather_rows_backward.launches) == before


# -- training through the executors -----------------------------------------


def _example():
    spec = importlib.util.spec_from_file_location(
        "tree_classifier_torch", ROOT / "examples" / "tree_classifier_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_steps(model_size, rl_iters, steps, lr, n_trees):
    """``examples/tree_classifier.py``'s loop over the JAX package, a few
    steps: the losses and each step's gradient."""
    from repro.core.executor import DynamicExecutor
    from repro.core.rl import RLConfig, train_fsm
    from repro.models.workloads import make_workload

    ex_mod = _example()
    rng = random.Random(0)
    wl = make_workload("TreeGRU", model_size=model_size)
    res = train_fsm([wl.sample_graph(rng, 2) for _ in range(3)],
                    RLConfig(max_iters=rl_iters))
    ex = DynamicExecutor(wl.impls, None)
    params = {"I": wl.cells["TreeGRU-Internal"].init_params(
        np.random.default_rng(1))}

    def batch_loss(params, graph, labels, root_ids):
        out = ex.run(graph, res.policy, params=params)
        logp = jax.nn.log_softmax(out.field("y", root_ids))
        return -jnp.mean(logp[jnp.arange(len(labels)), labels])

    losses, grads = [], []
    for _ in range(steps):
        g = wl.sample_graph(rng, n_trees)
        roots, labels = ex_mod.labelled_roots(g)
        loss, gr = jax.value_and_grad(batch_loss)(
            params, g, jnp.asarray(labels), np.asarray(roots))
        params = jax.tree.map(lambda p, d: p - lr * d, params, gr)
        losses.append(float(loss))
        grads.append(np.asarray(gr["I"]))
    return losses, grads


def _torch_steps(model_size, rl_iters, steps, lr, n_trees, executor):
    from repro_torch.core.executor import DynamicExecutor
    from repro_torch.core.rl import RLConfig, train_fsm
    from repro_torch.models.workloads import make_workload

    ex_mod = _example()
    rng = random.Random(0)
    wl = make_workload("TreeGRU", model_size=model_size, device="cpu")
    res = train_fsm([wl.sample_graph(rng, 2) for _ in range(3)],
                    RLConfig(max_iters=rl_iters))
    ex = DynamicExecutor(wl.impls, None, device="cpu")
    params = {"I": wl.cells["TreeGRU-Internal"].init_params(
        np.random.default_rng(1), device="cpu")}
    losses, grads = [], []
    for _ in range(steps):
        g = wl.sample_graph(rng, n_trees)
        roots, labels = ex_mod.labelled_roots(g)
        leaf = params["I"].detach().requires_grad_(True)
        run = executor(wl, ex, res.policy, g)
        out = run({"I": leaf})
        logp = torch.log_softmax(out.field("y", roots), dim=-1)
        loss = -logp[torch.arange(len(labels)), torch.as_tensor(labels)
                     ].mean()
        gr, = torch.autograd.grad(loss, [leaf])
        params = {"I": leaf.detach() - lr * gr}
        losses.append(float(loss.detach()))
        grads.append(gr)
    return losses, grads


def _dynamic(wl, ex, policy, g):
    return lambda params: ex.run(g, policy, params=params)


def _compiled(wl, ex, policy, g):
    from repro_torch.core.batching import resolve_schedule
    from repro_torch.core.plan import CompiledPlan

    # small PQ chunks: joint planning of a few hundred variables takes
    # minutes, and the gradients do not depend on the layout
    plan = CompiledPlan(g, resolve_schedule(g, policy), wl.impls,
                        max_pq_vars=48, device="cpu")
    return lambda params: plan.execute(g, params=params)


def test_tree_classifier_steps_match_the_jax_executor_within_1e4():
    """Three SGD steps of the example's TreeGRU classifier, the port's
    ``DynamicExecutor`` with ``torch.autograd.grad`` against the JAX
    package's with ``jax.value_and_grad``, on identical graphs, FSM and
    parameters: losses and gradients within 1e-4."""
    args = dict(model_size=16, rl_iters=60, steps=3, lr=0.05, n_trees=4)
    want_l, want_g = _jax_steps(**args)
    got_l, got_g = _torch_steps(**args, executor=_dynamic)
    for a, b in zip(got_l, want_l):
        assert abs(a - b) <= 1e-4 * max(abs(b), 1.0)
    for a, b in zip(got_g, want_g):
        b = torch.as_tensor(b)
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


def test_compiled_plan_gradients_match_the_dynamic_executors():
    """CompiledPlan differentiates with threaded params (its arena writes
    are functional while autograd records), to the DynamicExecutor's
    losses and gradients."""
    args = dict(model_size=16, rl_iters=60, steps=2, lr=0.05, n_trees=4)
    dyn_l, dyn_g = _torch_steps(**args, executor=_dynamic)
    plan_l, plan_g = _torch_steps(**args, executor=_compiled)
    for a, b in zip(plan_l, dyn_l):
        assert abs(a - b) <= 1e-6 * max(abs(b), 1.0)
    for a, b in zip(plan_g, dyn_g):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


def test_compiled_plan_forward_is_unchanged_by_recording():
    """The functional writes give the same arenas as the in-place ones."""
    from repro_torch.core.batching import resolve_schedule
    from repro_torch.core.plan import CompiledPlan
    from repro_torch.core.rl import RLConfig, train_fsm
    from repro_torch.models.workloads import make_workload

    rng = random.Random(1)
    wl = make_workload("TreeGRU", model_size=8, device="cpu")
    res = train_fsm([wl.sample_graph(rng, 2) for _ in range(2)],
                    RLConfig(max_iters=30))
    g = wl.sample_graph(rng, 3)
    plan = CompiledPlan(g, resolve_schedule(g, res.policy), wl.impls,
                        max_pq_vars=48, device="cpu")
    assert plan.stats.layout == "pq-chunked"
    pbuf = wl.cells["TreeGRU-Internal"].init_params(np.random.default_rng(1),
                                                    device="cpu")
    with torch.no_grad():
        plain = plan.execute(g, params={"I": pbuf})
    recorded = plan.execute(g, params={"I": pbuf.clone().requires_grad_()})
    for key, arena in plain.arenas.items():
        assert torch.equal(recorded.arenas[key].detach(), arena), key
