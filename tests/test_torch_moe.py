"""The port's MoE path against the JAX package's, on the same inputs.

* Gating: the port's plain version against the TPU kernel itself
  (``moe_gating_tokens`` in interpret mode) and against
  ``ref.moe_gating_ref``.  Expert ids must be equal; weights and
  probabilities agree within 1e-6 (the softmax sums in another order).
* ``run_moe`` through the weight bridge, with and without token drops, in
  one and in four groups: y within 1e-5, the aux loss within 1e-6.
* Reduced qwen2-moe-a2.7b and dbrx-132b: forward logits, greedy prefill +
  decode and the continuous-batching engine on one replayed feed with its
  cost model (with the JAX gating in jnp, and through the TPU kernel in
  interpret mode), the per-slot path and pipeline shards.  The JAX
  forward's Pallas flash kernel does not run on this jax (it asks for
  ``pltpu.TPUCompilerParams``), so the forward compares the jnp paths.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.simnet import Sim as JaxSim
from repro.kernels.moe_gating import moe_gating_tokens
from repro.kernels.ref import moe_gating_ref
from repro.models import decoder as jdec
from repro.models import moe as jmoe
from repro.models import ops_for as jax_ops_for
from repro.serving.batch import BatchEngine as JaxBatchEngine
from repro.serving.sharded import ShardModule as JaxShardModule
from repro_torch.configs import get_config
from repro_torch.core.simnet import Sim
from repro_torch.kernels import ops
from repro_torch.kernels.moe_gating import moe_gating_plain
from repro_torch.launch import serve
from repro_torch.models import decoder, moe
from repro_torch.params import params_from_numpy, params_to_numpy
from repro_torch.serving import (BatchEngine, ShardModule, plan_shards,
                                 split_params)

GATE_TOL = 1e-6
LOGIT_TOL = 1e-4
ARCHS = ("qwen2-moe-a2.7b", "dbrx-132b")


def _logits(T, E, seed):
    return (np.random.default_rng(seed).normal(size=(T, E)) * 2).astype(
        np.float32)


def _check_gating(got, want):
    w, ids, probs = (t.numpy() for t in got)
    wr, ir, pr = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(ids, ir.astype(np.int32))
    np.testing.assert_allclose(w, wr, atol=GATE_TOL, rtol=0)
    np.testing.assert_allclose(probs, pr, atol=GATE_TOL, rtol=0)


# ----------------------------------------------------------------- gating

@pytest.mark.parametrize("T,E,K", [(256, 16, 4), (512, 60, 4), (256, 8, 2),
                                   (1024, 64, 8)])
def test_gating_matches_the_tpu_kernel_and_the_reference(T, E, K):
    x = _logits(T, E, T + E)
    got = moe_gating_plain(torch.from_numpy(x), K)
    assert got[1].dtype == torch.int32
    _check_gating(got, moe_gating_tokens(jnp.asarray(x), K, bt=256,
                                         interpret=True))
    _check_gating(got, moe_gating_ref(jnp.asarray(x), K))
    np.testing.assert_allclose(got[0].sum(1).numpy(), 1.0, atol=1e-5)
    assert all(len(set(row)) == K for row in got[1].numpy())


@pytest.mark.parametrize("T", [300, 1, 0])
def test_gating_takes_a_ragged_token_count(T):
    """The Pallas wrapper asserts ``T % 256 == 0`` past 256 tokens; the
    port takes any count (a prompt of 300 tokens)."""
    x = _logits(T, 60, T)
    got = moe_gating_plain(torch.from_numpy(x), 4)
    assert [tuple(t.shape) for t in got] == [(T, 4), (T, 4), (T, 60)]
    _check_gating(got, moe_gating_ref(jnp.asarray(x), 4))


def test_gating_ties_go_to_the_lowest_expert():
    """Every logit appears twice (columns j and j + 8), and one row is
    uniform: equal probabilities are picked lowest index first, as the TPU
    kernel and ``lax.top_k`` pick them."""
    half = _logits(64, 8, 5)
    x = np.concatenate([half, half], axis=1)
    x[3] = 0.5
    got = moe_gating_plain(torch.from_numpy(x), 4)
    _check_gating(got, moe_gating_tokens(jnp.asarray(x), 4, interpret=True))
    _check_gating(got, moe_gating_ref(jnp.asarray(x), 4))
    ids = got[1].numpy()
    np.testing.assert_array_equal(ids[3], [0, 1, 2, 3])
    for r, row in enumerate(ids):
        if r != 3:
            first, second = np.argsort(-half[r])[:2]
            np.testing.assert_array_equal(
                row, [first, first + 8, second, second + 8])


def test_gating_refuses_more_picks_than_experts():
    with pytest.raises(ValueError):
        moe_gating_plain(torch.zeros((4, 3)), 4)


# ---------------------------------------------------------------- run_moe

def _moe_cfgs(groups, **kw):
    kw = dict(n_layers=1, d_model=64, vocab=64, n_experts=8, moe_top_k=2,
              d_expert=32, capacity_factor=1.0, moe_groups=groups, **kw)
    return (jax_get_config("qwen2-moe-a2.7b").reduced(**kw),
            get_config("qwen2-moe-a2.7b").reduced(**kw))


@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("no_drop", [True, False], ids=["no_drop", "drop"])
def test_run_moe_matches_jax(no_drop, groups):
    jcfg, cfg = _moe_cfgs(groups)
    jp = jmoe.init_moe(jcfg, jax.random.PRNGKey(groups), jnp.float32)
    p = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.default_rng(groups).normal(size=(2, 32, jcfg.d_model)
                                             ).astype(np.float32)
    want_y, want_aux = jmoe.run_moe(jp, jcfg, jnp.asarray(x), no_drop=no_drop)
    got_y, probs, experts = moe.run_moe(p, cfg, torch.from_numpy(x),
                                        no_drop=no_drop)
    got_aux = moe.switch_aux(cfg, probs, experts)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=1e-5,
                               rtol=0)
    assert abs(float(got_aux) - float(want_aux)) <= 1e-6
    # the drop case really drops: some expert is over its capacity
    _, experts, _ = jmoe.topk_gating(
        jnp.asarray(x).reshape(-1, jcfg.d_model) @ jp["router"], jcfg.moe_top_k)
    Tg = x.shape[0] * x.shape[1] // groups
    load = np.stack([np.bincount(g.ravel(), minlength=jcfg.n_experts)
                     for g in np.asarray(experts).reshape(groups, -1)])
    assert (load.max() > moe.capacity(cfg, Tg, no_drop)) == (not no_drop)


# ------------------------------------------------------------ whole models

def _model_cfgs(arch, **kw):
    kw = dict(n_layers=2, d_model=64, vocab=256, **kw)
    return jax_get_config(arch).reduced(**kw), get_config(arch).reduced(**kw)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    jcfg, cfg = _model_cfgs(request.param)
    assert jcfg.__dict__ == cfg.__dict__ and cfg.arch == "moe"
    jparams = jax_ops_for(jcfg).init(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, jparams, cfg, params_from_numpy(tree, "cpu"), tree


def test_init_and_weight_bridge_match_the_jax_tree(model):
    """The port's own init builds the JAX tree's keys, shapes and dtypes,
    and the bridge carries the MoE subtree bit-exactly both ways."""
    _, _, cfg, params, tree = model
    mine = params_to_numpy(decoder.init_params(
        cfg, torch.Generator().manual_seed(0), "cpu"))
    flat_j = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_m = jax.tree_util.tree_flatten_with_path(mine)[0]
    assert ([(p, a.shape, a.dtype) for p, a in flat_j]
            == [(p, a.shape, a.dtype) for p, a in flat_m])
    back = jax.tree_util.tree_flatten_with_path(params_to_numpy(params))[0]
    for (path, a), (_, b) in zip(flat_j, back):
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), path


def test_forward_matches_jax(model):
    jcfg, jparams, cfg, params, _ = model
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (2, 24),
                                               dtype=np.int32)
    want, want_aux = jdec.forward(jparams, jcfg, {"tokens": jnp.asarray(tokens)})
    got, got_aux = decoder.forward(params, cfg,
                                   {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL,
                               rtol=0)
    assert abs(float(got_aux) - float(want_aux)) <= 1e-6


#: ``use_flash_kernel`` on the JAX side sends the router gating of every
#: cached call (prefill, decode, the engine) through the TPU kernel in
#: interpret mode; the port always gates through its kernel entry point
GATING = {"jnp": False, "pallas": True}


@pytest.mark.parametrize("gating", sorted(GATING))
def test_prefill_and_greedy_decode_match_jax(model, gating):
    jcfg, jparams, cfg, params, _ = model
    jcfg = dataclasses.replace(jcfg, use_flash_kernel=GATING[gating])
    B, S, steps = 2, 11, 12
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (B, S),
                                               dtype=np.int32)
    jprefill = jax.jit(lambda p, b, c: jdec.prefill(p, jcfg, b, c))
    jdecode = jax.jit(lambda p, t, c: jdec.decode_step(p, jcfg, t, c))
    jl, jcache = jprefill(jparams, {"tokens": jnp.asarray(tokens)},
                          jdec.init_cache(jcfg, B, S + steps))
    tl, cache = decoder.prefill(params, cfg, {"tokens": torch.from_numpy(tokens)},
                                decoder.init_cache(cfg, B, S + steps,
                                                   device="cpu"))
    for _ in range(steps):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                                   rtol=0)
        jt = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        tt = torch.argmax(tl, dim=-1).to(torch.int32)
        np.testing.assert_array_equal(tt.numpy(), jt)
        jl, jcache = jdecode(jparams, jnp.asarray(jt), jcache)
        tl, cache = decoder.decode_step(params, cfg, tt, cache)
    assert cache["len"] == int(jcache["len"]) == S + steps


def _drive(eng, sim, prompts, steps, feed=None):
    """Open every session, decode greedily (or replay ``feed``), close.
    Returns the prefill logits, every step's logits, the feed and the
    summed simulated cost."""
    sessions = [f"s{i}" for i in range(len(prompts))]
    first, cost = [], 0.0
    for sid, p in zip(sessions, prompts):
        out, c = sim.run_process(eng.open(sid, p, p.shape[1] + steps + 1))
        first.append(np.asarray(out)[0])
        cost += c
    toks = np.asarray([int(np.argmax(r)) for r in first], np.int32)
    logits, fed = [], []
    for t in range(steps):
        x = feed[t] if feed is not None else toks
        fed.append(x)
        out, served, c = eng.step(sessions, x)
        assert served == sessions
        cost += c
        logits.append(np.asarray(out))
        toks = np.argmax(out, axis=-1).astype(np.int32)
    kv = eng.kv_bytes()
    eng.close(sessions)
    assert eng.stats["pages"] == 0
    return np.stack(first), logits, fed, cost, kv


@pytest.mark.parametrize("gating", sorted(GATING))
def test_batch_engine_matches_jax_on_a_replayed_feed(model, gating):
    """The fused engine serves MoE on both sides: same prefill and step
    logits on the JAX engine's own greedy feed, same simulated costs."""
    jcfg, jparams, cfg, params, _ = model
    jcfg = dataclasses.replace(jcfg, use_flash_kernel=GATING[gating])
    prompts = [np.random.default_rng(20 + n).integers(0, cfg.vocab, (1, n),
                                                      dtype=np.int32)
               for n in (5, 11, 17)]
    jsim = JaxSim(seed=4)
    jeng = JaxBatchEngine(JaxShardModule(jcfg, jparams, (0, jcfg.n_layers),
                                         True, True), jsim, n_slots=4,
                          page_size=8)
    assert jeng.fused
    j_first, j_logits, feed, j_cost, j_kv = _drive(jeng, jsim, prompts, 6)
    sim = Sim(seed=4)
    eng = BatchEngine(ShardModule(cfg, params, (0, cfg.n_layers), True, True),
                      sim, n_slots=4, page_size=8, device="cpu")
    assert eng.fused
    ops.reset_launch_counts()
    first, logits, fed, cost, kv = _drive(eng, sim, prompts, 6, feed)
    assert not any(ops.launch_counts().values())      # plain versions only
    np.testing.assert_allclose(first, j_first, atol=LOGIT_TOL, rtol=0)
    for a, b in zip(logits, j_logits):
        np.testing.assert_allclose(a, b, atol=LOGIT_TOL, rtol=0)
        np.testing.assert_array_equal(np.argmax(a, -1), np.argmax(b, -1))
    assert cost == pytest.approx(j_cost, rel=1e-12) and kv == j_kv
    assert (eng.module.weight_bytes() == jeng.module.weight_bytes()
            and eng.module.flops(7) == jeng.module.flops(7))


def test_per_slot_path_and_shards_match_the_fused_engine(model):
    """The per-slot path and a two-shard pipeline give the fused engine's
    logits on the same feed."""
    _, _, cfg, params, _ = model
    prompts = [np.random.default_rng(30 + n).integers(0, cfg.vocab, (1, n),
                                                      dtype=np.int32)
               for n in (6, 9)]
    whole = ShardModule(cfg, params, (0, cfg.n_layers), True, True)
    sim = Sim(seed=5)
    first, logits, feed, _, _ = _drive(
        BatchEngine(whole, sim, n_slots=2, page_size=8, device="cpu"),
        sim, prompts, 5)
    r_first, r_logits, _, _, _ = _drive(
        BatchEngine(whole, sim, n_slots=2, page_size=8, fused=False,
                    device="cpu"), sim, prompts, 5, feed)
    np.testing.assert_allclose(r_first, first, atol=LOGIT_TOL, rtol=0)
    for a, b in zip(r_logits, logits):
        np.testing.assert_allclose(a, b, atol=LOGIT_TOL, rtol=0)

    plan = plan_shards(cfg, 2)
    subs = split_params(cfg, params, plan)
    assert "moe" in subs[0]["blocks"] and subs[1]["blocks"]["moe"][
        "router"].shape[0] == 1
    shards = [BatchEngine(ShardModule(cfg, sp, rng, i == 0, i == 1), sim,
                          n_slots=2, page_size=8, device="cpu")
              for i, (sp, rng) in enumerate(zip(subs, plan))]
    h, _ = sim.run_process(shards[0].open("S", prompts[0], 32))
    out, _ = sim.run_process(shards[1].open("S", h, 32))
    np.testing.assert_allclose(out[0], first[0], atol=LOGIT_TOL, rtol=0)
    h, _, _ = shards[0].step(["S"], feed[0][:1])
    out, _, _ = shards[1].step(["S"], h)
    np.testing.assert_allclose(out, logits[0][:1], atol=LOGIT_TOL, rtol=0)


def test_cli_serves_moe_on_the_cpu_when_asked(capsys):
    serve.main(["--arch", "qwen2-moe-a2.7b", "--reduced", "--device", "cpu",
                "--batch", "2", "--prompt-len", "8", "--gen", "3"])
    out = capsys.readouterr().out
    assert "arch=qwen2-moe-a2.7b" in out and "6 tokens" in out
