"""The port's serving engines against the JAX package's.

The ``BatchEngine`` behaviour tests of ``test_serving_batch.py`` (slot
reuse, FIFO admission, page growth, exact page accounting, re-open,
int8, idle reaping), run on the port; the ``benchmarks/decode_step.py``
feed through both engines (logits, greedy path, cost model); greedy
generation; pipeline shards; and the device-resident pool that is written
in place.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import decode_step as jbench
from repro.configs import get_config as jax_get_config
from repro.core.simnet import Sim as JaxSim
from repro.models import ops_for as jax_ops_for
from repro.serving.engine import GenerationEngine as JaxGenerationEngine
from repro_torch.configs import get_config
from repro_torch.core.simnet import Sim
from repro_torch.params import params_from_numpy
from repro_torch.serving import (BatchEngine, GenerationEngine, ShardModule,
                                 plan_shards, split_params)

LOGIT_TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and on one thread each this file's small tensor ops do not contend
    (the reduced hymba's serving rehearsal took 4 s alone, 705 s beside
    five other test processes, on eight threads each)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs():
    kw = dict(n_layers=4, d_model=64, vocab=256)
    return (jax_get_config("granite-8b").reduced(**kw),
            get_config("granite-8b").reduced(**kw))


@pytest.fixture(scope="module")
def model():
    """JAX config/params and the port's, on the same weights."""
    jcfg, cfg = _cfgs()
    jparams = jax_ops_for(jcfg).init(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, cfg, params


def _full_module(cfg, params):
    return ShardModule(cfg, params, (0, cfg.n_layers), is_first=True,
                       is_last=True)


def _engine(model, sim, **kw):
    _, _, cfg, params = model
    return BatchEngine(_full_module(cfg, params), sim, device="cpu", **kw)


def _prompt(seed, n, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (1, n), dtype=np.int32)


def _pages_for(eng, n_tokens):
    return -(-n_tokens // eng.page_size)


# --------------------------------------------------------------------------
# BatchEngine behaviour (the JAX engine's unit tests, on the port)
# --------------------------------------------------------------------------

def test_slot_reuse_after_eviction(model):
    sim = Sim(seed=1)
    eng = _engine(model, sim, n_slots=1, page_size=8)
    x = _prompt(1, 4)
    sim.run_process(eng.open("A", x, 16))
    slot_a = eng.slot_of("A")
    assert slot_a is not None and eng.slots_used == 1
    eng.close(["A"])
    assert eng.slots_used == 0 and eng.slot_of("A") is None
    sim.run_process(eng.open("B", x, 16))
    assert eng.slot_of("B") == slot_a
    assert eng.stats["slot_reuse"] == 1
    assert eng.stats["evicted"] == 1
    assert eng.stats["admitted"] == 2


def test_admission_fifo_under_full_slot_table(model):
    sim = Sim(seed=2)
    eng = _engine(model, sim, n_slots=2, page_size=8)
    x = _prompt(2, 4)
    sim.run_process(eng.open("A", x, 16))
    sim.run_process(eng.open("B", x, 16))
    admitted = []

    def waiter(sid):
        yield from eng.open(sid, x, 16)
        admitted.append(sid)

    sim.process(waiter("C"))
    sim.process(waiter("D"))
    sim.run(until=sim.now + 1)
    assert eng.queue_depth == 2 and admitted == []
    eng.close(["A"])                 # the oldest waiter gets the slot
    sim.run(until=sim.now + 1)
    assert admitted == ["C"] and eng.queue_depth == 1
    eng.close(["B"])
    sim.run(until=sim.now + 1)
    assert admitted == ["C", "D"]
    assert eng.stats["queue_peak"] == 2


def test_paged_cache_grows_without_perturbing_decode(model):
    """Decode past the first page: capacity grows by whole pages and the
    greedy continuation still matches the generation engine."""
    _, _, cfg, params = model
    sim = Sim(seed=3)
    eng = _engine(model, sim, n_slots=1, page_size=8)
    x = _prompt(3, 6)
    n_new = 12
    out, _ = sim.run_process(eng.open("S", x, 32))
    toks = [int(np.argmax(out[0]))]
    for _ in range(n_new - 1):
        step_out, served, _ = eng.step(["S"], np.asarray([toks[-1]], np.int32))
        assert served == ["S"]
        toks.append(int(np.argmax(step_out[0])))
    assert eng.by_session["S"].capacity > 8
    want, _ = GenerationEngine(cfg, params, max_len=32,
                               device="cpu").generate({"tokens": x}, n_new)
    np.testing.assert_array_equal(np.asarray(toks, np.int32), want[0])


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "per_slot"])
def test_exact_page_accounting_across_lifecycle(model, fused):
    sim = Sim(seed=6)
    eng = _engine(model, sim, n_slots=4, page_size=8, fused=fused)
    x = _prompt(6, 11)
    sim.run_process(eng.open("A", x, 64))
    sim.run_process(eng.open("B", x, 64))
    assert eng.stats["pages"] == 2 * _pages_for(eng, 12)
    for _ in range(6):                     # 11 + 6 = 17 -> 3 pages
        eng.step(["A", "B"], np.asarray([1, 2], np.int32))
    assert eng.stats["pages"] == 2 * _pages_for(eng, 17)
    eng.close(["A"])
    assert eng.stats["pages"] == _pages_for(eng, 17)
    eng.close(["B"])
    assert eng.stats["pages"] == 0
    assert eng.stats["pages_peak"] == 2 * _pages_for(eng, 17)
    sim.run_process(eng.open("C", x, 64))
    assert eng.stats["pages"] == _pages_for(eng, 12)
    eng.close(["C"])
    assert eng.stats["pages"] == 0
    assert sim.leak_report() == {k: 0 for k in sim.leak_report()}


def test_reopen_same_session_frees_old_pages(model):
    sim = Sim(seed=7)
    eng = _engine(model, sim, n_slots=2, page_size=8)
    x = _prompt(7, 20)
    sim.run_process(eng.open("A", x, 64))
    first = eng.stats["pages"]
    sim.run_process(eng.open("A", x[:, :4], 64))
    assert eng.stats["pages"] == _pages_for(eng, 5) < first
    eng.close(["A"])
    assert eng.stats["pages"] == 0


def test_reap_idle_and_fail_waiters(model):
    """Idle sessions are evicted with their pages; a crash wakes every
    queued admission with the error instead of leaving it parked."""
    sim = Sim(seed=14)
    eng = _engine(model, sim, n_slots=1, page_size=8)
    x = _prompt(14, 4)
    sim.run_process(eng.open("A", x, 16))
    errors = []

    def waiter():
        try:
            yield from eng.open("B", x, 16)
        except RuntimeError as exc:
            errors.append(str(exc))

    sim.process(waiter())
    sim.run(until=sim.now + 1)
    assert eng.queue_depth == 1
    assert eng.fail_waiters(RuntimeError("shard down")) == 1
    sim.run(until=sim.now + 1)
    assert errors == ["shard down"] and eng.queue_depth == 0
    assert eng.reap_idle(ttl=10.0) == 0          # touched just now
    sim.run(until=sim.now + 11)
    assert eng.reap_idle(ttl=10.0) == 1
    assert eng.stats["idle_evicted"] == 1 and eng.stats["pages"] == 0
    assert eng.slots_used == 0


def test_int8_kv_cache_smaller_and_greedy_consistent(model):
    outs, bytes_used = {}, {}
    x = _prompt(8, 10)
    for dtype in ("fp32", "int8"):
        sim = Sim(seed=8)
        eng = _engine(model, sim, n_slots=1, page_size=8, kv_dtype=dtype)
        assert eng.fused
        out, _ = sim.run_process(eng.open("S", x, 64))
        toks = [int(np.argmax(out[0]))]
        for _ in range(20):
            last, served, _ = eng.step(["S"], np.asarray([toks[-1]], np.int32))
            toks.append(int(np.argmax(last[0])))
        outs[dtype] = (toks, last)
        bytes_used[dtype] = eng.kv_bytes()
    assert bytes_used["int8"] <= 0.55 * bytes_used["fp32"]
    assert outs["int8"][0] == outs["fp32"][0]
    assert np.abs(outs["int8"][1] - outs["fp32"][1]).max() < 0.25


def test_pool_is_written_in_place_on_the_device(model):
    """A decode step writes only the new token's pool rows, into the same
    storage (the pool is replaced only when it grows)."""
    sim = Sim(seed=9)
    eng = _engine(model, sim, n_slots=2, page_size=8)
    sim.run_process(eng.open("A", _prompt(9, 5), 64))
    sim.run_process(eng.open("B", _prompt(10, 13), 64))
    pool = eng._pool
    for _ in range(4):
        ptrs = (pool.kp.data_ptr(), pool.vp.data_ptr(), pool.n_pages)
        before_k, before_v = pool.kp.clone(), pool.vp.clone()
        pos = {sid: (eng.by_session[sid].length, list(eng.by_session[sid].pages))
               for sid in ("A", "B")}
        eng.step(["A", "B"], np.asarray([3, 4], np.int32))
        if pool.n_pages == ptrs[2]:
            assert (pool.kp.data_ptr(), pool.vp.data_ptr()) == ptrs[:2]
        changed = ((pool.kp[:, :ptrs[2]] != before_k).any(dim=(0, 3, 4))
                   | (pool.vp[:, :ptrs[2]] != before_v).any(dim=(0, 3, 4)))
        want = torch.zeros_like(changed)
        for sid, (length, _) in pos.items():
            pages = eng.by_session[sid].pages
            want[pages[length // 8], length % 8] = True
        assert torch.equal(changed, want)


# --------------------------------------------------------------------------
# the decode_step benchmark feed through both engines
# --------------------------------------------------------------------------

def _drive(eng, sim, feed=None):
    """``benchmarks/decode_step._drive``, recording every step's logits."""
    rng = np.random.default_rng(11)
    sessions = [f"s{i}" for i in range(jbench.N_SESSIONS)]
    prompts = rng.integers(1, 200, size=(jbench.N_SESSIONS, jbench.PROMPT_LEN))
    toks = {}
    for sid, prompt in zip(sessions, prompts):
        out, _ = sim.run_process(eng.open(
            sid, prompt[None].astype(np.int32),
            jbench.PROMPT_LEN + jbench.DECODE_STEPS + 1))
        toks[sid] = int(np.argmax(out[0]))
    cost, tokens, fed, logits = 0.0, 0, [], []
    for t in range(jbench.DECODE_STEPS):
        x = (feed[t] if feed is not None
             else np.asarray([toks[s] for s in sessions], np.int32))
        fed.append(x)
        out, served, c = eng.step(sessions, x)
        cost += c
        tokens += len(served)
        for sid, row in zip(served, out):
            toks[sid] = int(np.argmax(row))
        logits.append(np.asarray(out))
    return cost, tokens, eng.kv_bytes(), logits, fed


@pytest.fixture(scope="module")
def decode_feed(model):
    """The JAX fused engine's run of the benchmark feed."""
    jcfg, jparams, _, _ = model
    sim = JaxSim(seed=3)
    eng = jbench._build_engine(jcfg, jparams, sim)
    return _drive(eng, sim)


def test_decode_step_feed_matches_jax_and_cost_model(model, decode_feed):
    _, _, cfg, params = model
    j_cost, j_tokens, j_bytes, j_logits, feed = decode_feed
    rows, logits = {}, {}
    for name, kw in (("fused", {}), ("unfused", {"fused": False}),
                     ("int8", {"kv_dtype": "int8"})):
        sim = Sim(seed=3)
        eng = BatchEngine(_full_module(cfg, params), sim,
                          n_slots=jbench.N_SESSIONS, page_size=8, device="cpu",
                          **kw)
        cost, tokens, cache_bytes, lg, fed = _drive(
            eng, sim, None if name == "fused" else feed)
        rows[name] = (tokens / cost, cache_bytes)
        logits[name] = lg
        if name == "fused":
            # same greedy path, same logits, same simulated cost as JAX
            for a, b in zip(fed, feed):
                np.testing.assert_array_equal(a, b)
            for a, b in zip(lg, j_logits):
                np.testing.assert_allclose(a, b, atol=LOGIT_TOL, rtol=0)
            assert cost == pytest.approx(j_cost, rel=1e-12)
            assert cache_bytes == j_bytes and tokens == j_tokens
    speedup = rows["fused"][0] / rows["unfused"][0]
    ratio = rows["int8"][1] / rows["fused"][1]
    # the digits BENCH_decode_step.json records
    assert round(speedup, 9) == 6.394856771
    assert ratio == 0.3828125
    for a, b in zip(logits["unfused"], logits["fused"]):
        np.testing.assert_allclose(a, b, atol=LOGIT_TOL, rtol=0)
    assert np.array_equal(np.argmax(logits["int8"][-1], -1),
                          np.argmax(logits["fused"][-1], -1))
    assert np.abs(logits["int8"][-1] - logits["fused"][-1]).max() <= \
        jbench.LOGIT_DEV_BOUND


def test_generation_engine_greedy_matches_jax(model):
    jcfg, jparams, cfg, params = model
    tokens = np.random.default_rng(12).integers(0, cfg.vocab, (2, 9),
                                                dtype=np.int32)
    want, _ = JaxGenerationEngine(jcfg, jparams, max_len=32).generate(
        {"tokens": jnp.asarray(tokens)}, 10)
    got, stats = GenerationEngine(cfg, params, max_len=32,
                                  device="cpu").generate({"tokens": tokens}, 10)
    np.testing.assert_array_equal(got, want)
    assert stats["generated"] == 20


def test_sharded_pipeline_matches_whole_model(model):
    """Two shards chained (activations between them) decode like one."""
    _, _, cfg, params = model
    plan = plan_shards(cfg, 2)
    assert plan == [(0, 2), (2, 4)]
    subs = split_params(cfg, params, plan)
    shards = [ShardModule(cfg, sp, rng, is_first=i == 0, is_last=i == 1)
              for i, (sp, rng) in enumerate(zip(subs, plan))]
    sim = Sim(seed=13)
    engs = [BatchEngine(m, sim, n_slots=2, page_size=8, device="cpu")
            for m in shards]
    whole = _engine(model, sim, n_slots=2, page_size=8)
    x = _prompt(13, 7)
    h, _ = sim.run_process(engs[0].open("S", x, 32))
    a, _ = sim.run_process(engs[1].open("S", h, 32))
    b, _ = sim.run_process(whole.open("S", x, 32))
    np.testing.assert_allclose(a, b, atol=LOGIT_TOL, rtol=0)
    whole_first = b
    tok = np.asarray([int(np.argmax(b[0]))], np.int32)
    h, _, _ = engs[0].step(["S"], tok)
    a, _, _ = engs[1].step(["S"], h)
    b, _, _ = whole.step(["S"], tok)
    np.testing.assert_allclose(a, b, atol=LOGIT_TOL, rtol=0)
    # without a cache, a shard's stack applies to the whole prompt at once
    emb = shards[0].embed(torch.from_numpy(x))
    pos = torch.arange(x.shape[1], dtype=torch.int32)[None]
    h1, none = shards[0].apply(emb, pos, None)
    h2, _ = shards[1].apply(h1, pos, None)
    assert none is None
    np.testing.assert_allclose(shards[1].head(h2[:, -1:])[:, 0].numpy(),
                               whole_first, atol=LOGIT_TOL, rtol=0)
