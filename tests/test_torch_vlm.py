"""The port's vlm arch (qwen2-vl-7b) against the JAX package's, on the CPU.

M-RoPE (``apply_mrope`` at qwen2-vl's full sections and at the reduced
ones), the reduced qwen2-vl's init and weight bridge, ``forward`` and
``loss_fn`` with stubbed patch embeddings and Qwen2-VL-style grid
positions, ``prefill`` (one of 2048 tokens, through the flash branch)
and greedy ``decode_step``, ``GenerationEngine``, text served per slot
through ``BatchEngine`` and through a v1 ``ShardServer``, and
``launch.serve``.  The reference's decode-position hazard is pinned in
both packages.  Inputs come from numpy seeds; JAX weights cross over
through ``params_from_numpy``.  Tolerances: 1e-6 on M-RoPE, 1e-4 on
logits (``LOGIT_TOL`` of ``tests/test_torch_hybrid.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.fleet import make_fleet as jax_make_fleet
from repro.core.simnet import Sim as JaxSim
from repro.models import common as jcommon
from repro.models import decoder as jdec
from repro.models import ops_for as jax_ops_for
from repro.serving.batch import BatchEngine as JaxBatchEngine
from repro.serving.engine import GenerationEngine as JaxGenerationEngine
from repro.serving.sharded import ShardModule as JaxShardModule
from repro.serving.sharded import ShardServer as JaxShardServer
from repro.serving.sharded import plan_shards as jax_plan_shards
from repro.serving.sharded import split_params as jax_split_params
from repro_torch.configs import get_config
from repro_torch.core.fleet import make_fleet
from repro_torch.core.simnet import Sim
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import common, decoder, ops_for
from repro_torch.params import params_from_numpy, params_to_numpy
from repro_torch.serving import (BatchEngine, GenerationEngine, ShardModule,
                                 ShardServer)
from repro_torch.serving.sharded import plan_shards, split_params

MROPE_TOL = 1e-6
LOGIT_TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny tensor ops run 10-50x faster on one intra-op thread here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=LOGIT_TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=0)


# ----------------------------------------------------------------- M-RoPE

def _rope_inputs(seed, hd, S=33):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, S, 3, hd)).astype(np.float32)
    pos3 = rng.integers(0, 4096, (3, 2, S)).astype(np.int32)
    return x, pos3


@pytest.mark.parametrize("sections,hd", [((16, 24, 24), 128), ((8, 12, 12), 64)],
                         ids=["full", "reduced"])
def test_apply_mrope_matches_jax(sections, hd):
    """Distinct t/h/w streams within 1e-6 of JAX's; three equal streams
    give plain ``apply_rope`` exactly."""
    x, pos3 = _rope_inputs(hd, hd)
    want = jcommon.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), 1e6, sections)
    got = common.apply_mrope(_t(x), _t(pos3), 1e6, sections)
    _close(got, want, MROPE_TOL)
    same = np.broadcast_to(pos3[1], pos3.shape)
    got = common.apply_mrope(_t(x), _t(same), 1e6, sections)
    assert torch.equal(got, common.apply_rope(_t(x), _t(pos3[1]), 1e6))
    _close(got, jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos3[1]), 1e6),
           MROPE_TOL)


@pytest.mark.parametrize("sections", [(5, 7, 7), (8, 8, 8)],
                         ids=["short", "long"])
def test_mrope_sections_that_miss_the_head_dim_follow_jax(sections):
    """A sum short of hd/2 repeats the last stream and a longer one is cut,
    as JAX's ``total_repeat_length`` (hd = 40: 20 frequency pairs)."""
    x, pos3 = _rope_inputs(40, 40)
    want = jcommon.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), 1e4, sections)
    _close(common.apply_mrope(_t(x), _t(pos3), 1e4, sections), want,
           MROPE_TOL)


# -------------------------------------------------------------- the model

@pytest.fixture(scope="module")
def model():
    jcfg = jax_get_config("qwen2-vl-7b").reduced()
    cfg = get_config("qwen2-vl-7b").reduced()
    assert jcfg.__dict__ == cfg.__dict__
    assert cfg.mrope and cfg.mrope_sections == (8, 12, 12) and cfg.n_patches == 16
    jparams = jax_ops_for(jcfg).init(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, jparams, cfg, params_from_numpy(tree, "cpu"), tree


def grid_positions(n_patches, n_text, B=2):
    """Qwen2-VL's layout: patch i at (t=0, h=i//4, w=i%4), then the text
    at max + 1 onwards on all three streams.  (3, B, n_patches + n_text)."""
    i = np.arange(n_patches)
    grid = np.stack([0 * i, i // 4, i % 4])
    text = np.arange(n_text) + grid.max() + 1
    pos = np.concatenate([grid, np.stack([text] * 3)], axis=1)
    return np.ascontiguousarray(np.broadcast_to(
        pos[:, None], (3, B, n_patches + n_text)).astype(np.int32))


def vlm_batch(cfg, n_text, seed, B=2, positions=True):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, n_text), dtype=np.int32),
             "vision_embeds": rng.standard_normal(
                 (B, cfg.n_patches, cfg.d_model)).astype(np.float32)}
    batch["labels"] = np.roll(batch["tokens"], -1, axis=1)
    if positions:
        batch["positions3"] = grid_positions(cfg.n_patches, n_text, B)
    return batch


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: _t(v) for k, v in batch.items()}


def _flat(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def test_init_and_weight_bridge_match_the_jax_tree(model):
    """The dense tree: the port's init has JAX's keys, shapes and dtypes,
    and the bridge carries JAX's bit-exactly both ways."""
    jcfg, _, cfg, _, tree = model
    mine = params_to_numpy(decoder.init_params(
        cfg, torch.Generator().manual_seed(0), "cpu"))
    assert ([(p, a.shape, a.dtype) for p, a in _flat(tree)]
            == [(p, a.shape, a.dtype) for p, a in _flat(mine)])
    back = _flat(params_to_numpy(params_from_numpy(tree, "cpu")))
    for (path, a), (_, b) in zip(_flat(tree), back):
        assert np.array_equal(a, b), path


@pytest.mark.parametrize("positions", [True, False], ids=["grid", "arange"])
def test_forward_and_loss_match_jax(model, positions):
    """Patch embeddings before 40 text tokens, under grid positions or the
    default ``arange`` on three streams: the text's logits (the patch rows
    dropped) and the loss agree with JAX's."""
    jcfg, jparams, cfg, params, _ = model
    batch = vlm_batch(cfg, 40, 1, positions=positions)
    want, _ = jdec.forward(jparams, jcfg, _jax(batch))
    got, aux = decoder.forward(params, cfg, _torch(batch))
    assert got.shape == (2, 40, cfg.vocab)
    _close(got, want)
    assert float(aux) == 0.0
    jloss, jm = jdec.loss_fn(jparams, jcfg, _jax(batch))
    loss, m = decoder.loss_fn(params, cfg, _torch(batch))
    assert float(loss) == pytest.approx(float(jloss), abs=LOGIT_TOL)
    assert int(m["n_tokens"]) == int(jm["n_tokens"]) == 80


#: text tokens: 100 + 16 patches (the masked branch), and 2032 + 16 = 2048
#: (the flash branch)
@pytest.mark.parametrize("n_text", [100, 2032])
def test_prefill_and_greedy_decode_match_jax(model, n_text, monkeypatch):
    """Prefill with patches and grid positions, then greedy decode: the
    port replays JAX's tokens, logits within 1e-4, and the caches agree.
    The 2048-token prefill runs the flash branch once per layer (its plain
    version here)."""
    calls = []
    real = ops.flash_attention

    def spy(*a, **k):
        calls.append(k)
        return real(*a, **k)

    monkeypatch.setattr(ops, "flash_attention", spy)
    jcfg, jparams, cfg, params, _ = model
    B, steps = 2, 6
    batch = vlm_batch(cfg, n_text, n_text)
    total = n_text + cfg.n_patches
    jl, jcache = jax.jit(lambda p, b, c: jdec.prefill(p, jcfg, b, c))(
        jparams, _jax(batch), jdec.init_cache(jcfg, B, total + steps))
    cache = decoder.init_cache(cfg, B, total + steps, device="cpu")
    tl, cache = decoder.prefill(params, cfg, _torch(batch), cache)
    long = total >= common.FLASH_MIN_SEQ
    assert calls == [{"causal": True, "window": 0}] * (cfg.n_layers * long)
    jdecode = jax.jit(lambda p, t, c: jdec.decode_step(p, jcfg, t, c))
    for _ in range(steps):
        _close(tl, jl)
        jt = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        np.testing.assert_array_equal(torch.argmax(tl, -1).numpy(), jt)
        jl, jcache = jdecode(jparams, jnp.asarray(jt), jcache)
        tl, cache = decoder.decode_step(params, cfg, _t(jt), cache)
    _close(tl, jl)
    assert cache["len"] == int(jcache["len"]) == total + steps
    for key, a in params_to_numpy(cache["layers"]).items():
        np.testing.assert_allclose(a, np.asarray(jcache["layers"][key]),
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)


def _decode_position_hazard(pkg, params, cfg, batch, as_array, as_numpy):
    """One package's decode step after a grid prefill, and its forward's
    last logits when the new token takes the cache length on all three
    streams (the reference) or max(positions3) + 1 (Qwen2-VL)."""
    B, n_text = batch["tokens"].shape
    total = n_text + cfg.n_patches
    tok = np.full((B,), 7, np.int32)
    cache = pkg.init_cache(cfg, B, total + 1, **(
        {"device": "cpu"} if pkg is decoder else {}))
    _, cache = pkg.prefill(params, cfg, as_array(batch), cache)
    step, _ = pkg.decode_step(params, cfg, as_array({"t": tok})["t"], cache)
    out = {}
    for name, nxt in (("cache_len", total),
                      ("qwen2_vl", int(batch["positions3"].max()) + 1)):
        longer = dict(batch, tokens=np.concatenate(
            [batch["tokens"], tok[:, None]], axis=1))
        longer["positions3"] = np.concatenate(
            [batch["positions3"], np.full((3, B, 1), nxt, np.int32)], axis=2)
        del longer["labels"]
        logits, _ = pkg.forward(params, cfg, as_array(longer))
        out[name] = as_numpy(logits[:, -1])
    return as_numpy(step), out


def test_decode_position_is_the_cache_length_in_both_packages(model):
    """The reference's hazard, kept: after a grid prefill (16 patches on a
    4 x 4 grid, so the text starts at 4), a decode step takes position
    ``cache["len"]`` on all three streams, 12 past where Qwen2-VL would
    continue (max(positions3) + 1).  In each package the step equals the
    forward with the cache length appended, and differs from the one with
    max + 1."""
    jcfg, jparams, cfg, params, _ = model
    batch = vlm_batch(cfg, 30, 4)
    total = 30 + cfg.n_patches
    assert int(batch["positions3"].max()) + 1 == total - 12
    runs = {"jax": _decode_position_hazard(jdec, jparams, jcfg, batch, _jax,
                                           np.asarray),
            "port": _decode_position_hazard(
                decoder, params, cfg, batch, _torch,
                lambda t: t.detach().numpy())}
    for name, (step, fwd) in runs.items():
        np.testing.assert_allclose(step, fwd["cache_len"], atol=LOGIT_TOL,
                                   rtol=0, err_msg=name)
        assert np.abs(step - fwd["qwen2_vl"]).max() > 100 * LOGIT_TOL, name
    _close(runs["port"][0], runs["jax"][0])


def test_generation_engine_greedy_matches_jax(model):
    """``GenerationEngine`` with patches and grid positions: the whole
    batch reaches ``prefill``, the cache is sized for the patches, and the
    tokens are JAX's."""
    jcfg, jparams, cfg, params, _ = model
    batch = vlm_batch(cfg, 40, 8)
    del batch["labels"]
    want, _ = JaxGenerationEngine(jcfg, jparams, max_len=80).generate(
        _jax(batch), 12)
    eng = GenerationEngine(cfg, params, max_len=80, device="cpu")
    seen = {}
    real_prefill = eng.ops.prefill

    def prefill(p, c, inputs, cache):
        seen.update(keys=set(inputs), kv_len=cache["layers"]["k"].shape[2])
        return real_prefill(p, c, inputs, cache)

    eng.ops = dataclasses.replace(eng.ops, prefill=prefill)
    got, stats = eng.generate(batch, 12)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert stats["generated"] == 24
    assert seen == {"keys": set(batch), "kv_len": cfg.n_patches + 40 + 12}


# ------------------------------------------------------------- the engine

def _drive(eng, sim, prompts, steps, feed=None):
    """Open every session, decode greedily (or replay ``feed``), close.
    Returns the prefill logits, every step's logits and the feed."""
    sessions = [f"s{i}" for i in range(len(prompts))]
    first = []
    for sid, p in zip(sessions, prompts):
        out, _ = sim.run_process(eng.open(sid, p, p.shape[1] + steps + 1))
        first.append(np.asarray(out)[0])
    toks = np.asarray([int(np.argmax(r)) for r in first], np.int32)
    logits, fed = [], []
    for t in range(steps):
        x = feed[t] if feed is not None else toks
        fed.append(x)
        out, served, _ = eng.step(sessions, x)
        assert served == sessions
        logits.append(np.asarray(out))
        toks = np.argmax(out, axis=-1).astype(np.int32)
    eng.close(sessions)
    assert eng.stats["pages"] == 0
    return np.stack(first), logits, fed


#: the smoke's V1 text prompts with FLASH_MIN_SEQ cut to 128 in both
#: packages: 128 and 150 take the flash branch as 2048 and 2100 do there
ENGINE_PROMPTS = (128, 150, 12, 37)


def test_batch_engine_serves_text_per_slot_as_jax(model, monkeypatch):
    """Text only, per slot (the fused path stays closed to M-RoPE in both
    engines, even when asked for): the same prefill and step logits on
    JAX's greedy feed, the same stats, and no kernel launched."""
    monkeypatch.setattr(jcommon, "FLASH_MIN_SEQ", 128)
    monkeypatch.setattr(common, "FLASH_MIN_SEQ", 128)
    jcfg, jparams, cfg, params, _ = model
    prompts = [np.random.default_rng(60 + n).integers(0, cfg.vocab, (1, n),
                                                      dtype=np.int32)
               for n in ENGINE_PROMPTS]
    jsim = JaxSim(seed=4)
    jeng = JaxBatchEngine(JaxShardModule(jcfg, jparams, (0, cfg.n_layers),
                                         True, True), jsim, n_slots=8,
                          page_size=32, fused=True)
    assert not jeng.fused
    j_first, j_logits, feed = _drive(jeng, jsim, prompts, 6)
    sim = Sim(seed=4)
    eng = BatchEngine(ShardModule(cfg, params, (0, cfg.n_layers), True, True),
                      sim, n_slots=8, page_size=32, fused=True, device="cpu")
    assert not eng.fused
    ops.reset_launch_counts()
    first, logits, _ = _drive(eng, sim, prompts, 6, feed)
    assert not any(ops.launch_counts().values())
    _close(first, j_first)
    for a, b in zip(logits, j_logits):
        _close(a, b)
        np.testing.assert_array_equal(np.argmax(a, -1), np.argmax(b, -1))
    assert eng.stats == jeng.stats


class _Ctx:
    """The one thing ``_handle`` asks of its RPC context."""

    @staticmethod
    def cpu(seconds):
        return ("cpu", seconds)


def _call(server, payload):
    """``server._handle(payload)`` driven by hand: (reply, cost)."""
    gen = server._handle(payload, _Ctx())
    _, cost = next(gen)
    with pytest.raises(StopIteration) as stop:
        gen.send(None)
    return stop.value.value, cost


def test_shard_server_v1_serves_text_as_jax(model):
    """Two v1 shards of each package: prefill, two decode steps and a
    score, each shard's reply of JAX's shape and cost, within 1e-4."""
    jcfg, jparams, cfg, params, _ = model

    def servers(make_fleet_, sim, split, plan_of, module, server, c, p):
        fleet = make_fleet_(2, same_region="us", sim=sim, join=False,
                            maintenance=False)
        plan = plan_of(c, 2)
        parts = split(c, p, plan)
        return [server(fleet.peers[i], c, "v", i, module(
            c, parts[i], plan[i], is_first=i == 0, is_last=i == 1))
            for i in range(2)]

    jsv = servers(jax_make_fleet, JaxSim(seed=3), jax_split_params,
                  jax_plan_shards, JaxShardModule, JaxShardServer, jcfg,
                  jparams)
    psv = servers(make_fleet, Sim(seed=3), split_params, plan_shards,
                  ShardModule, ShardServer, cfg, params)
    rng = np.random.default_rng(11)
    prompt = rng.integers(0, cfg.vocab, (1, 9), dtype=np.int32)
    flows = [("prefill", {"session": ("c", 1), "max_len": 16}, prompt),
             ("decode", {"session": ("c", 1)}, np.asarray([5], np.int32)),
             ("decode", {"session": ("c", 1)}, np.asarray([7], np.int32)),
             ("score", {}, rng.integers(0, cfg.vocab, (2, 7), dtype=np.int32))]
    for op, extra, x0 in flows:
        xj = xp = x0
        for i in range(2):
            rj, cj = _call(jsv[i], dict(extra, op=op, x=xj))
            rp, cp = _call(psv[i], dict(extra, op=op, x=xp))
            assert rp["x"].shape == rj["x"].shape and cp == cj, (op, i)
            _close(rp["x"], rj["x"])
            xj, xp = rj["x"], rp["x"]


def test_cli_serves_qwen2_vl_on_the_cpu_when_asked(capsys):
    out = serve.main(["--arch", "qwen2-vl-7b", "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "20", "--gen", "4"])
    vocab = get_config("qwen2-vl-7b").reduced().vocab
    assert out.shape == (2, 4) and (out >= 0).all() and (out < vocab).all()
    text = capsys.readouterr().out
    assert "arch=qwen2-vl-7b" in text and "8 tokens" in text


def test_ops_for_serves_the_full_config():
    cfg = get_config("qwen2-vl-7b")
    assert ops_for(cfg).prefill is decoder.prefill
    assert cfg.param_count() == 7_615_286_784


# ------------------------------------------------ the smoke's vlm phases

def test_vlm_phases_rehearse_on_the_cpu(monkeypatch):
    """``chip_smoke.vlm_parity_phase`` (gate V1) and
    ``serving_vlm_phase`` (V2, V3 and ``launch.serve``) end to end on the
    CPU, ``FLASH_MIN_SEQ`` cut to 128 so that the long prompts take the
    flash branch (its plain version): V1 holds, nothing launches, the
    per-slot cache is 2 L Hk hd 4 B a token of its capacity, and V3's
    handoff holds at the reduced width."""
    import chip_smoke

    lines = []
    monkeypatch.setattr(chip_smoke, "emit", lines.append)
    monkeypatch.setattr(common, "FLASH_MIN_SEQ", 128)
    v1 = chip_smoke.vlm_parity_phase(torch, "cpu", text=[112, 20],
                                     prompts=[128, 150, 12, 37])
    assert v1["max_abs_logit_err"]["card32_vs_cpu64"] <= v1["v1_limit"]
    assert not any(v1["launches_card32"].values())
    cfg = get_config("qwen2-vl-7b").reduced()
    chip_smoke.serving_vlm_phase(torch, "cpu", cfg, text=112,
                                 prompts=[128, 127, 20, 12], cli_prompt=20)
    by = {ln["phase"]: ln for ln in lines}
    slot = by["serving_vlm"]["slot"]
    assert slot["pages_after_close"] == 0
    assert slot["kv_bytes_per_token"] == 2 * 2 * 1 * 64 * 4
    assert by["vlm_handoff_by_layer"]["kv_rel"]["k"] <= 1e-4
    hand = by["vlm_handoff"]
    assert hand["S"] == 144 and hand["handoff_over_one_ulp"] <= 1.0
    assert "seconds" in by["serving_vlm_done"]
