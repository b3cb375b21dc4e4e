"""The port's wave LM server (``repro_torch.serve.lm_wave``) against the
JAX package's ``repro.serve.lm_wave`` with the same parameters and prompts:
identical token streams (a mismatch reports the top-2 logit margin at the
first differing step) and identical batch counts."""

import dataclasses
import gc
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.arch.model import TransformerLM as JaxLM  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.serve import lm_wave as jwave  # noqa: E402
from repro_torch.arch.convert import install_params  # noqa: E402
from repro_torch.arch.model import TransformerLM  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.batching import FSMPolicy  # noqa: E402
from repro_torch.serve import lm_wave  # noqa: E402


def _pair(name, **over):
    jcfg = jax_config(name).reduced(**over)
    cfg = get_config(name).reduced(**over)
    jm = JaxLM(jcfg)
    jparams = jm.init_params(jax.random.PRNGKey(0))
    m = TransformerLM(cfg, device="cpu")
    params = m.init_params(torch.Generator().manual_seed(0))
    install_params(params, jax.tree.map(np.asarray, jparams))
    return jm, jparams, m, params


def _top2_margin(m, params, prompt, prefix) -> float:
    """Top-1 minus top-2 logit of the step that produced ``prefix``'s next
    token, recomputed on the port from the full sequence."""
    toks = torch.tensor([list(prompt) + list(prefix)])
    try:
        logits, _ = m.forward(params, toks)
    except ValueError:     # an SSM's forward takes whole chunks only
        return float("nan")
    top = torch.topk(logits[0, -1], 2).values
    return float(top[0] - top[1])


def _assert_same_streams(outs, jouts, m, params, prompts):
    for r, (got, want) in enumerate(zip(outs, jouts)):
        want = [int(t) for t in want]
        if got != want:
            t = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
            margin = _top2_margin(m, params, prompts[r], want[:t])
            pytest.fail(f"request {r}: token {t} is {got[t]}, the reference "
                        f"gives {want[t]} (top-2 margin {margin:.3e})")


@pytest.mark.parametrize("name,lengths,cache_len,d_model", [
    ("qwen2-0.5b", (5, 5, 9), 48, 32),        # tests/test_launch.py's case
    ("qwen2-0.5b", (7, 12, 7, 3), 40, 0),
    ("mamba2-130m", (16, 32, 16), 48, 0),     # prompts: multiples of the chunk
])
def test_serve_engine_matches_reference(name, lengths, cache_len, d_model):
    over = {"d_model": d_model} if d_model else {}
    jm, jparams, m, params = _pair(name, **over)
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(0, m.cfg.vocab, n)) for n in lengths]
    jeng = jwave.ServeEngine(jm, jparams, cache_len=cache_len)
    eng = lm_wave.ServeEngine(m, params, cache_len=cache_len, device="cpu")
    jouts, jstats = jeng.generate(prompts, max_new=4)
    outs, stats = eng.generate(prompts, max_new=4)
    _assert_same_streams(outs, jouts, m, params, prompts)
    assert all(len(o) == 4 for o in outs)
    for f in ("n_batches", "n_prefill_batches", "n_decode_batches",
              "tokens_out"):
        assert getattr(stats, f) == getattr(jstats, f), f
    assert stats.n_prefill_batches == len(set(lengths))
    assert stats.n_decode_batches == 3


def test_serve_engine_batches_requests():
    """Mirror of the reference's launch test, on the port alone."""
    cfg = get_config("qwen2-0.5b").reduced(d_model=32)
    model = TransformerLM(cfg, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    eng = lm_wave.ServeEngine(model, params, cache_len=48, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(0, cfg.vocab, n)) for n in (5, 5, 9)]
    outs, stats = eng.generate(prompts, max_new=4)
    assert all(len(o) == 4 for o in outs)
    # 2 prompt-length types + 3 decode waves
    assert stats.n_prefill_batches == 2
    assert stats.n_decode_batches == 3
    # a repeat of the same wave shape hits the schedule cache
    eng.generate(prompts, max_new=4, stats=stats)
    assert stats.sched_cache_hits == 1


def test_request_graph_and_schedule_match_reference():
    from repro.core.batching import SufficientConditionPolicy as JPolicy
    from repro.core.batching import resolve_schedule as jresolve
    from repro_torch.core.batching import (SufficientConditionPolicy,
                                           resolve_schedule)

    lengths, max_new = (4, 9, 4, 6), 5
    reqs = [lm_wave.Request(list(range(n)), max_new) for n in lengths]
    jreqs = [jwave.Request(list(range(n)), max_new) for n in lengths]
    g, jg = lm_wave.request_graph(reqs), jwave.request_graph(jreqs)
    assert g.topology_key() == jg.topology_key()
    assert [(n.type, n.inputs, n.attrs) for n in g.nodes] == \
        [(n.type, n.inputs, n.attrs) for n in jg.nodes]
    assert resolve_schedule(g, SufficientConditionPolicy()) == \
        jresolve(jg, JPolicy())


def test_engine_with_learned_fsm_policy_matches_reference():
    """An FSM policy (the learned kind) schedules the wave the same way in
    both packages; its Q-table goes across as the reference's payload."""
    from repro.core.batching import FSMPolicy as JFSM
    from repro.core.rl import RLConfig, train_fsm

    jm, jparams, m, params = _pair("qwen2-0.5b", d_model=32)
    rng = np.random.default_rng(1)
    prompts = [list(rng.integers(0, m.cfg.vocab, n)) for n in (6, 3, 6)]
    graph = jwave.request_graph([jwave.Request(p, 3) for p in prompts])
    fsm = train_fsm([graph], RLConfig(max_iters=50, seed=0))
    payload = fsm.policy.to_payload()
    jouts, jstats = jwave.ServeEngine(jm, jparams, cache_len=16,
                                      policy=JFSM.from_payload(payload)
                                      ).generate(prompts, max_new=3)
    outs, stats = lm_wave.ServeEngine(m, params, cache_len=16, device="cpu",
                                      policy=FSMPolicy.from_payload(payload)
                                      ).generate(prompts, max_new=3)
    _assert_same_streams(outs, jouts, m, params, prompts)
    assert (stats.n_prefill_batches, stats.n_decode_batches) == \
        (jstats.n_prefill_batches, jstats.n_decode_batches)


def test_engine_refuses_a_cross_attention_model():
    """The vision model's prefill needs image embeddings, which a wave of
    token prompts does not carry (the reference's wave fails inside its
    prefill): the port refuses the engine up front."""
    cfg = get_config("llama-3.2-vision-11b").reduced()
    model = TransformerLM(cfg, device="cpu")
    with pytest.raises(ValueError, match="cross-attention"):
        lm_wave.ServeEngine(model, {}, device="cpu")


@pytest.mark.parametrize("name,lengths", [
    ("granite-moe-1b-a400m", (5, 9, 5, 7)),
    ("olmoe-1b-7b", (6, 3, 6)),
])
def test_moe_models_serve_as_the_reference(name, lengths):
    """MoE models through the wave engine: a decode step routes its B rows
    as one group, whose expert capacity they share, as the reference's."""
    jm, jparams, m, params = _pair(name)
    rng = np.random.default_rng(6)
    prompts = [list(rng.integers(0, m.cfg.vocab, n)) for n in lengths]
    jouts, jstats = jwave.ServeEngine(jm, jparams, cache_len=24).generate(
        prompts, max_new=4)
    eng = lm_wave.ServeEngine(m, params, cache_len=24, device="cpu")
    outs, stats = eng.generate(prompts, max_new=4)
    _assert_same_streams(outs, jouts, m, params, prompts)
    assert (stats.n_prefill_batches, stats.n_decode_batches) == \
        (jstats.n_prefill_batches, jstats.n_decode_batches)


def test_engine_refuses_a_model_on_another_device():
    cfg = get_config("qwen2-0.5b").reduced(d_model=32)
    model = TransformerLM(cfg, device="cpu")
    with pytest.raises(ValueError, match="model on cpu"):
        lm_wave.ServeEngine(model, {}, device="meta")


@pytest.mark.parametrize("name,waves,cache_len", [
    ("qwen2-0.5b", [(5, 9, 5), (9, 3, 7)], 24),
    ("mamba2-130m", [(16, 32, 16), (32, 16, 16)], 48),
])
def test_successive_waves_share_the_pool_and_match_reference(name, waves,
                                                             cache_len):
    """Two waves of three requests through one engine: the second reuses
    the first's pool (zeroed in place) and the programs built for it, and
    each wave's tokens equal the reference's, whose engine makes a fresh
    pool every wave."""
    jm, jparams, m, params = _pair(name)
    jeng = jwave.ServeEngine(jm, jparams, cache_len=cache_len)
    eng = lm_wave.ServeEngine(m, params, cache_len=cache_len, device="cpu")
    rng = np.random.default_rng(2)
    pools = []
    for lengths in waves:
        prompts = [list(rng.integers(0, m.cfg.vocab, n)) for n in lengths]
        jouts, jstats = jeng.generate(prompts, max_new=4)
        outs, stats = eng.generate(prompts, max_new=4)
        _assert_same_streams(outs, jouts, m, params, prompts)
        assert (stats.n_prefill_batches, stats.n_decode_batches) == \
            (jstats.n_prefill_batches, jstats.n_decode_batches)
        assert stats.n_captures == stats.n_replays == 0   # no card here
        pools.append(eng._decode(len(lengths)).pool)
    assert pools[0] is pools[1]
    assert set(eng._programs) >= {("decode", 3, cache_len)}


def test_wave_programs_are_capped_and_a_pool_goes_with_its_decode_step():
    """The engine keeps its programs in one FIFO-capped cache, each decode
    step holding its slots' pool: past the cap the oldest go, a pool with
    the decode step that reads it, and later waves rebuild what they need
    and still give the reference's tokens."""
    jm, jparams, m, params = _pair("qwen2-0.5b", d_model=32)
    jeng = jwave.ServeEngine(jm, jparams, cache_len=24)
    eng = lm_wave.ServeEngine(m, params, cache_len=24, device="cpu")
    eng._programs.maxsize = 3
    rng = np.random.default_rng(4)
    first_pool = None   # a weak reference to a tensor of the first pool
    for lengths in [(5, 9), (4, 6, 8), (3, 7), (5, 9)]:
        prompts = [list(rng.integers(0, m.cfg.vocab, n)) for n in lengths]
        jouts, _ = jeng.generate(prompts, max_new=3)
        outs, _ = eng.generate(prompts, max_new=3)
        _assert_same_streams(outs, jouts, m, params, prompts)
        assert len(eng._programs) <= 3
        pools = {k: p.pool for k, p in eng._programs.items()}
        assert all((p is None) == (k[0] == "prefill")
                   for k, p in pools.items())
        if first_pool is None:
            pool = eng._decode(2).pool
            first_pool = weakref.ref(pool[0][next(iter(pool[0]))])
            del pool
    gc.collect()
    assert first_pool() is None


def _decode_early(graph):
    """A wave schedule that prefills the last request alone and decodes it
    twice before the other prompts are prefilled, then decodes in
    lockstep: the early decode steps run over slots no prompt has filled
    yet."""
    chains: dict[int, list] = {}
    for n in graph.nodes:
        chains.setdefault(n.attrs["req"], []).append(n)
    last = max(chains)
    sched = [(chains[last][0].type, [chains[last][0].id]),
             ("D", [chains[last][1].id]), ("D", [chains[last][2].id])]
    sched += [(chains[r][0].type, [chains[r][0].id])
              for r in sorted(chains) if r != last]
    done = {r: (3 if r == last else 1) for r in chains}
    while any(done[r] < len(c) for r, c in chains.items()):
        ids = [chains[r][done[r]].id for r in sorted(chains)
               if done[r] < len(chains[r])]
        for r in chains:
            done[r] += done[r] < len(chains[r])
        sched.append(("D", ids))
    return sched


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_decoding_before_every_prefill_matches_reference_across_waves(
        capacity_factor):
    """Jamba (SSM, attention and MoE layers), two waves of four requests
    through one engine under a schedule that decodes before every prompt
    is prefilled. The reference decodes its unfilled slots from a fresh
    zeroed pool; the port keeps its pool across waves, and an unfilled
    slot's SSM state from the first wave would route its row differently
    in the second, and so, through the experts' capacity, which the decode
    step's rows share, drop another real token. Each wave's tokens must
    equal the reference's."""
    over = {"capacity_factor": capacity_factor}
    jcfg = dataclasses.replace(jax_config("jamba-v0.1-52b").reduced(), **over)
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b").reduced(), **over)
    jm = JaxLM(jcfg)
    jparams = jm.init_params(jax.random.PRNGKey(0))
    m = TransformerLM(cfg, device="cpu")
    params = m.init_params(torch.Generator().manual_seed(0))
    install_params(params, jax.tree.map(np.asarray, jparams))
    jeng = jwave.ServeEngine(jm, jparams, cache_len=48, policy=_decode_early)
    eng = lm_wave.ServeEngine(m, params, cache_len=48, device="cpu",
                              policy=_decode_early)
    rng = np.random.default_rng(5)
    for lengths in [(32, 16, 32, 16), (16, 32, 16, 32)]:
        prompts = [list(rng.integers(0, m.cfg.vocab, n)) for n in lengths]
        jouts, jstats = jeng.generate(prompts, max_new=5)
        outs, stats = eng.generate(prompts, max_new=5)
        _assert_same_streams(outs, jouts, m, params, prompts)
        assert stats.n_decode_batches == jstats.n_decode_batches == 6
