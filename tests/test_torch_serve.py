"""The port's continuous-batching serve engine (``repro_torch.serve``)
against the reference's (``repro.serve``) on the CPU.

Both engines get bit-identical workloads (weights from the same numpy
seed) and the same ``synth_trace``; terminal statuses, token streams,
rounds and batches per family must be equal and tree and lattice outputs
within 1e-4 (the reference's cross-tier bar), in every mode of the
single-shard engine: continuous and wave scheduling, bucketed, per-topology
and interpreted execution, pipelined and serial rounds. Pipelined rounds
must equal serial ones bit for bit, as in ``tests/test_pipeline.py``.

The bucketed executor's static-buffer path (what a captured CUDA graph
replays over) runs eagerly here and must equal the plain body bit for bit;
its executable key, the weight copies an entry pins, the launch-count
bookkeeping of replays and the kernels' grad guard are checked without a
card."""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import serve as jserve  # noqa: E402
from repro.core.cache import FIFOCache as JFIFOCache  # noqa: E402
from repro.core.cache import LRUCache as JLRUCache  # noqa: E402
from repro.models.workloads import make_workload as jmake_workload  # noqa: E402
from repro_torch import serve  # noqa: E402
from repro_torch.core.batching import SufficientConditionPolicy  # noqa: E402
from repro_torch.core.cache import FIFOCache, LRUCache  # noqa: E402
from repro_torch.core.executor import derived_copies  # noqa: E402
from repro_torch.core.plan import (BucketedPlanExecutor,  # noqa: E402
                                   PlanResult, _node_aux_np)
from repro_torch.kernels import launches  # noqa: E402
from repro_torch.kernels.guard import check_no_grad  # noqa: E402
from repro_torch.models.workloads import make_workload  # noqa: E402
from repro_torch.serve.queue import COMPLETED  # noqa: E402

MODEL_SIZE = 8
FAMILIES = ["lm", "tree", "lattice"]
# Graphs small enough to stay out of the joint PQ planner's slow window
# (150-512 layout variables) once a round merges them.
SIZES = dict(tree_leaves=(3, 5), lattice_chars=(4, 6))


def _workloads(make, **kw):
    return {"lm": make("ChainLM", MODEL_SIZE, **kw),
            "tree": make("TreeLSTM", MODEL_SIZE, **kw),
            "lattice": make("LatticeLSTM", MODEL_SIZE, **kw)}


@pytest.fixture(scope="module")
def stacks():
    """Per package: the serve module, its workloads and caches shared by
    every engine of the module (hits only save lowering and builds)."""
    return {
        "jax": (jserve, _workloads(jmake_workload),
                dict(plan_cache=JFIFOCache(256), schedule_cache=JFIFOCache(512),
                     bucket_cache=JLRUCache(64)), {}),
        "torch": (serve, _workloads(make_workload, device="cpu"),
                  dict(plan_cache=FIFOCache(256), schedule_cache=FIFOCache(512),
                       bucket_cache=LRUCache(64)), {"device": "cpu"}),
    }


TRACES = {  # name: (families, n, rate, max_new, seed)
    "mixed": (FAMILIES, 9, 3.0, 4, 11),
    "lm": (["lm"], 12, 3.0, 6, 5),
    # wave mode admits a whole wave at once: fewer single-shot requests
    # keep its merged graphs small
    "wave": (["lm", "lm", "tree"], 9, 3.0, 4, 11),
}


def _serve(stack, trace, **kw):
    mod, wls, caches, extra = stack
    fams, n, rate, max_new, seed = TRACES[trace]
    reqs = mod.synth_trace(fams, n, rate, max_new, wls, seed, **SIZES)
    eng = mod.ServeEngine(dict(wls), max_slots=4, **caches, **extra, **kw)
    eng.submit_many(reqs)
    stats = eng.run()
    return eng, reqs, stats


def _batches(eng):
    return {fam: es.n_batches for fam, es in sorted(eng._exec_stats.items())}


def _assert_same(got, want, exact=False):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a.family, a.status) == (b.family, b.status)
        assert a.status == COMPLETED
        if a.family == "lm":
            assert a.out == b.out
        elif exact:
            assert np.array_equal(a.result, b.result)
        else:
            np.testing.assert_allclose(a.result, np.asarray(b.result),
                                       rtol=0, atol=1e-4)


MODES = {
    "bucketed": {},
    "serial": dict(pipeline=False),
    "per_topology": dict(bucketed=False),
    "interpreted": dict(compiled=False),
    "wave": dict(continuous=False),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_engine_matches_reference(stacks, mode):
    trace = "wave" if mode == "wave" else "mixed"
    jeng, jreqs, jstats = _serve(stacks["jax"], trace, **MODES[mode])
    eng, reqs, stats = _serve(stacks["torch"], trace, **MODES[mode])
    _assert_same(reqs, jreqs)
    assert stats.n_rounds == jstats.n_rounds
    assert stats.tier_rounds == jstats.tier_rounds
    assert _batches(eng) == _batches(jeng)
    assert stats.tokens_out == jstats.tokens_out
    assert stats.requests_done == len(reqs)
    assert (stats.n_pipelined_rounds, stats.n_overlapped_packs) == \
        (jstats.n_pipelined_rounds, jstats.n_overlapped_packs)


@pytest.mark.parametrize("trace", ["mixed", "lm"])
def test_pipelined_equals_serial_bit_for_bit(stacks, trace):
    _, serial, _ = _serve(stacks["torch"], trace, pipeline=False)
    _, piped, stats = _serve(stacks["torch"], trace, pipeline=True)
    _assert_same(piped, serial, exact=True)
    # the lm rounds really did pipeline
    assert stats.n_pipelined_rounds > 0
    assert stats.n_overlapped_packs > 0


def test_slot_pool_is_updated_in_place(stacks):
    """A captured graph reads the slot pool at fixed addresses, so the
    engine writes it in place: the pool's tensors keep their storage
    across rounds, and hold the last state of the slots in use."""
    _, wls, _, _ = stacks["torch"]
    eng = serve.ServeEngine(dict(wls), max_slots=4, device="cpu")
    pool = eng._lm_pool()
    before = {f: (t, t.data_ptr()) for f, t in pool.items()}
    eng.submit(serve.lm_request([3, 1, 4, 1, 5], 3))
    eng.run()
    for f, (t, ptr) in before.items():
        assert eng._lm_pool()[f] is t and t.data_ptr() == ptr
        assert t[0].abs().sum() > 0      # the request's slot was written
        assert t[1:].abs().sum() == 0


def test_shared_cache_does_not_alias_different_weights(stacks):
    """Two engines sharing one pack cache and one bucket cache, built
    around different weights, must not serve each other's programs."""
    _, wls, _, _ = stacks["torch"]
    cache, buckets = FIFOCache(8), FIFOCache(8)

    def run(w):
        eng = serve.ServeEngine(w, max_slots=2, plan_cache=cache,
                                bucket_cache=buckets, device="cpu")
        req = serve.lm_request([1, 2, 3], max_new=2)
        eng.submit(req)
        return eng.run(), req.out

    other = dict(wls, lm=make_workload("ChainLM", MODEL_SIZE, seed=1,
                                       device="cpu"))
    _, out_a = run(dict(wls))
    misses, bucket_misses = cache.misses, buckets.misses
    stats_b, out_b = run(other)
    assert stats_b.n_compiles >= 1
    assert cache.misses > misses and buckets.misses > bucket_misses
    _, out_b_alone = run(dict(other))
    assert out_b == out_b_alone != out_a


# -- the bucketed executor's static buffers ---------------------------------


@pytest.fixture(scope="module")
def trees():
    wl = make_workload("TreeLSTM", MODEL_SIZE, device="cpu")
    rng = random.Random(3)
    return wl, [wl.sample_graph(rng, 1, leaves_lo=3, leaves_hi=5)
                for _ in range(5)]


def test_static_buffer_path_equals_plain_path(trees):
    """The static-buffer path (index and aux vectors copied into one
    entry's fixed buffers, then the body over them) equals the plain body
    run on each pack's own index vectors bit for bit, across topologies
    that share a bucket signature and alternate (so the buffers are
    refilled), repeated runs, donation, and either run mode."""
    wl, graphs = trees
    pol = SufficientConditionPolicy()
    packs = FIFOCache(16)
    for donate in (False, True):
        for capture in (True, False):
            ex = BucketedPlanExecutor(wl.impls, None, ladder=(8,),
                                      donate=donate, device="cpu",
                                      capture=capture, pack_cache=packs)
            specs = {ex.pack_for(g, pol).spec for g in graphs}
            assert len(specs) < len(graphs)          # some share a signature
            for g in graphs + graphs[::-1]:
                pack = ex.pack_for(g, pol)
                a = ex.run(g, pol)
                entry = ex._exes.peek(ex.executable_key(pack, None))
                assert entry.graph is None           # no card here
                aux = torch.from_numpy(_node_aux_np(g, pack.aux_perm))
                b = PlanResult(g, wl.impls, entry.prog.body(
                    None, pack.idxpack, pack.idxpack_long, aux, {}),
                    pack.row_of)
                for n in g.nodes:
                    for f, t in a.node(n.id).items():
                        assert torch.equal(t, b.node(n.id)[f])
            assert ex.n_bucket_compiles == len(specs)
            assert ex.n_captures == ex.n_replays == 0


def test_derived_weight_copies_are_collected_for_the_entry():
    """A captured graph reads the fused cell's blocked weights, which the
    cell keeps for the last few parameter buffers it saw only.
    ``derived_copies`` hands a capture the copies the body used and the buffer and version
    each came from, so the entry can pin them and notice an in-place
    update; here on the CPU, around plain runs with the cell's own buffer,
    a threaded one, and its own again."""
    wl = make_workload("BiLSTM-Tagger", MODEL_SIZE, device="cpu")
    g = wl.sample_graph(random.Random(0), 2, lo=4, hi=6)
    pol = SufficientConditionPolicy()
    cells = [impl for impl in wl.impls.values()
             if impl.fused_gather is not None]
    assert cells
    ex = BucketedPlanExecutor(wl.impls, None, device="cpu")
    pack = ex.pack_for(g, pol)
    own = cells[0].params["pbuf"]
    threaded = {cells[0].name: own.clone()}
    for params, buf in ((None, own), (threaded, threaded[cells[0].name]),
                        (None, own)):
        with derived_copies() as found:
            ex.run(g, pol, params=params)
        mine = [(v, c) for src, v, c in found if src is buf]
        assert mine and all(v == buf._version for v, _ in mine)
        assert all(c[0] is mine[0][1][0] and c[1] is mine[0][1][1]
                   for _, c in mine)
    entry = ex._exes.peek(ex.executable_key(pack, threaded))
    buf = threaded[cells[0].name]
    entry.sources = [(buf, buf._version)]
    assert entry.current() and ex.executable_ready(pack, threaded)
    buf.mul_(1.0)
    assert not entry.current() and not ex.executable_ready(pack, threaded)
    ex.run(g, pol, params=threaded)              # builds the entry again
    assert ex._exes.peek(ex.executable_key(pack, threaded)) is not entry


def test_executable_key_tracks_the_tensors_a_graph_reads():
    wl = make_workload("ChainLM", MODEL_SIZE, device="cpu")
    ex = BucketedPlanExecutor(wl.impls, None, device="cpu")
    eager = BucketedPlanExecutor(wl.impls, None, device="cpu", capture=False)
    g = wl.sample_graph(random.Random(0), 1)
    pack = ex.pack_for(g, SufficientConditionPolicy())
    pool = wl.init_slots(4)
    params = {"slots": pool}
    key = ex.executable_key(pack, params)
    assert key[:3] == eager.executable_key(pack, params)[:3]
    # in-place updates of the threaded pool keep the key: the graph reads
    # the pool at each replay
    pool["h_out"].index_fill_(0, torch.tensor([1]), 2.0)
    assert ex.executable_key(pack, params) == key
    # a new pool tensor does not
    params2 = {"slots": dict(pool, h_out=pool["h_out"].clone())}
    assert ex.executable_key(pack, params2) != key
    # nor a replaced weight, or one updated in place (its blocked and
    # packed copies are built once, before the capture)
    pbuf = wl.impls["C"].params["pbuf"]
    wl.impls["C"].params["pbuf"] = pbuf.clone()
    key2 = ex.executable_key(pack, params)
    assert key2 != key
    wl.impls["C"].params["pbuf"].mul_(1.0)
    assert ex.executable_key(pack, params) != key2
    # the eager path reads nothing at fixed addresses
    assert eager.executable_key(pack, params2) == \
        eager.executable_key(pack, params)


def test_replay_launch_count_bookkeeping():
    """Launches counted while a thread captures move no count: they go to
    the capture's tally (the gather's shapes too), another thread's
    launches meanwhile count as usual, and each replay adds the tally."""
    import threading

    from repro_torch.kernels import counting
    from repro_torch.kernels.fused_gather_cell import fused_gather_lstm_cell
    from repro_torch.kernels.gather_batch import gather_rows

    start = launches.snapshot()
    try:
        with launches.captured() as d:
            for shape in [(16, 2048), (16, 2048), (1, 2048)]:
                counting.count(gather_rows, shape)
            for _ in range(5):
                counting.count(fused_gather_lstm_cell)
            other = threading.Thread(
                target=lambda: counting.count(gather_rows, (4, 64)))
            other.start()
            other.join()
        assert d["gather_rows"] == 3 and d["fused_gather_lstm_cell"] == 5
        assert d["ssd_scan"] == d["flash_attention"] == 0
        assert d["gather_shapes"] == {(16, 2048): 2, (1, 2048): 1}
        now = launches.delta(start, launches.snapshot())
        assert now["gather_rows"] == 1 and now["fused_gather_lstm_cell"] == 0
        assert now["gather_shapes"] == {(4, 64): 1}
        for _ in range(4):
            launches.add(d)
        now = launches.snapshot()
        assert now["gather_rows"] == start["gather_rows"] + 13
        assert now["fused_gather_lstm_cell"] == \
            start["fused_gather_lstm_cell"] + 20
        assert now["gather_shapes"][(16, 2048)] == \
            start["gather_shapes"][(16, 2048)] + 8
    finally:
        launches.restore(start)


def test_grad_guard():
    x = torch.ones(3, requires_grad=True)
    y = torch.ones(3)
    check_no_grad("k", y, None)
    with pytest.raises(RuntimeError, match="k: the CUDA kernel has no "
                                           "backward"):
        check_no_grad("k", y, x)
    with torch.no_grad():
        check_no_grad("k", x)
    check_no_grad("k", x.detach())
