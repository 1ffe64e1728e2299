"""qwen3-32b's ``qk_norm`` path, and glm4-9b, against the JAX package.

Both packages initialise ``q_norm``/``k_norm`` to ones, which leaves the
``qk_norm`` lines of ``run_attention`` and of the fused engine's
``_fused_block`` unchecked.  Here a reduced qwen3-32b has its norm
weights drawn at random (the same numpy draws crossing into both
packages), and a reduced glm4-9b (one kv head for four query heads, rope
theta 1e4, no ``qk_norm``) runs beside it.  Each is held against JAX on
the forward, prefill + greedy decode, the fused and per-slot engines on
the JAX engine's feed, and one train step.  Tolerances as
``tests/test_torch_models.py``, ``tests/test_torch_serving.py`` and
``tests/test_torch_train.py``: 1e-4 on logits, train-step metrics 1e-5
relative, parameters after a step within 1e-2 of the lr.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.simnet import Sim as JaxSim
from repro.models import decoder as jdec
from repro.models import ops_for as jax_ops_for
from repro.optim import schedules as jsched
from repro.serving.batch import BatchEngine as JaxBatchEngine
from repro.serving.sharded import ShardModule as JaxShardModule
from repro.train import step as jstep
from repro_torch.configs import get_config
from repro_torch.core.simnet import Sim
from repro_torch.models import decoder
from repro_torch.optim import cosine_schedule
from repro_torch.params import params_from_numpy, train_state_from_numpy
from repro_torch.serving import BatchEngine, ShardModule
from repro_torch.train import make_train_step
from repro_torch.tree import leaves

LOGIT_TOL = 1e-4
STEP_RTOL = 1e-5
PARAM_TOL_LR = 1e-2
ARCHS = ["qwen3-32b", "glm4-9b"]


def _random_norms(tree, seed):
    """``tree`` with every ``q_norm``/``k_norm`` leaf drawn from N(1, 0.5^2)
    (numpy, so both packages take the same values)."""
    rng = np.random.default_rng(seed)
    attn = dict(tree["blocks"]["attn"])
    for key in ("q_norm", "k_norm"):
        if key in attn:
            attn[key] = (1.0 + 0.5 * rng.standard_normal(attn[key].shape)
                         ).astype(attn[key].dtype)
    return {**tree, "blocks": {**tree["blocks"], "attn": attn}}


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    kw = dict(n_layers=2, d_model=64, vocab=256)
    jcfg = jax_get_config(request.param).reduced(**kw)
    cfg = get_config(request.param).reduced(**kw)
    assert jcfg.__dict__ == cfg.__dict__
    assert cfg.qk_norm == (request.param == "qwen3-32b")
    tree = _random_norms(jax.tree.map(
        np.asarray, jax_ops_for(jcfg).init(jcfg, jax.random.PRNGKey(0))), 1)
    if cfg.qk_norm:
        assert np.abs(tree["blocks"]["attn"]["q_norm"] - 1).min() > 0
    jparams = jax.tree.map(jnp.asarray, tree)
    return jcfg, jparams, cfg, params_from_numpy(tree, "cpu")


def test_forward_matches_jax(model):
    jcfg, jparams, cfg, params = model
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (2, 24),
                                               dtype=np.int32)
    want, _ = jdec.forward(jparams, jcfg, {"tokens": jnp.asarray(tokens)})
    got, _ = decoder.forward(params, cfg, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL,
                               rtol=0)


def test_prefill_and_greedy_decode_match_jax(model):
    jcfg, jparams, cfg, params = model
    B, S, steps = 2, 11, 12
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (B, S),
                                               dtype=np.int32)
    jdecode = jax.jit(lambda p, t, c: jdec.decode_step(p, jcfg, t, c))
    jl, jcache = jax.jit(lambda p, b, c: jdec.prefill(p, jcfg, b, c))(
        jparams, {"tokens": jnp.asarray(tokens)},
        jdec.init_cache(jcfg, B, S + steps))
    cache = decoder.init_cache(cfg, B, S + steps, device="cpu")
    tl, cache = decoder.prefill(params, cfg,
                                {"tokens": torch.from_numpy(tokens)}, cache)
    for _ in range(steps):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                                   rtol=0)
        jt = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        np.testing.assert_array_equal(torch.argmax(tl, -1).numpy(), jt)
        jl, jcache = jdecode(jparams, jnp.asarray(jt), jcache)
        tl, cache = decoder.decode_step(params, cfg, torch.from_numpy(jt),
                                        cache)


def _drive(eng, sim, prompts, steps, feed=None):
    sessions = [f"s{i}" for i in range(len(prompts))]
    first = []
    for sid, p in zip(sessions, prompts):
        out, _ = sim.run_process(eng.open(sid, p, p.shape[1] + steps + 1))
        first.append(np.asarray(out)[0])
    toks = np.asarray([int(np.argmax(r)) for r in first], np.int32)
    logits, fed = [np.stack(first)], []
    for t in range(steps):
        x = feed[t] if feed is not None else toks
        fed.append(x)
        out, served, _ = eng.step(sessions, x)
        assert served == sessions
        logits.append(np.asarray(out))
        toks = np.argmax(out, axis=-1).astype(np.int32)
    eng.close(sessions)
    return logits, fed


def test_fused_and_per_slot_engines_match_jax(model):
    """The JAX fused engine's greedy feed through the port's fused engine
    (``_fused_block``'s qk_norm) and its per-slot engine: every prefill's
    and step's logits within 1e-4 of JAX's."""
    jcfg, jparams, cfg, params = model
    prompts = [np.random.default_rng(20 + n).integers(0, cfg.vocab, (1, n),
                                                      dtype=np.int32)
               for n in (5, 11, 17, 30)]
    jsim = JaxSim(seed=2)
    jeng = JaxBatchEngine(JaxShardModule(jcfg, jparams, (0, cfg.n_layers),
                                         True, True), jsim, n_slots=4,
                          page_size=8)
    assert jeng.fused
    want, feed = _drive(jeng, jsim, prompts, 10)
    for fused in (True, False):
        sim = Sim(seed=2)
        eng = BatchEngine(ShardModule(cfg, params, (0, cfg.n_layers), True,
                                      True), sim, n_slots=4, page_size=8,
                          fused=fused, device="cpu")
        assert eng.fused == fused
        got, _ = _drive(eng, sim, prompts, 10, feed)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, atol=LOGIT_TOL, rtol=0)


def test_train_step_matches_jax(model):
    """One step of ``make_train_step`` from one state (the random norms
    included): loss, ce, grad norm and lr, and every parameter after the
    step, the norms' gradients among them."""
    jcfg, jparams, cfg, _ = model
    state = jstep.train_state_init(jcfg, jax.random.PRNGKey(0))
    state = state._replace(params=jparams) if hasattr(state, "_replace") \
        else type(state)(params=jparams, opt=state.opt)
    np_state = jax.tree.map(np.asarray, state)
    sched = (jsched.cosine_schedule(3e-3, 2, 5), cosine_schedule(3e-3, 2, 5))
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab, (2, 33), dtype=np.int32)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    theirs, wm = jax.jit(jstep.make_train_step(jcfg, sched[0]))(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    mine, m = make_train_step(cfg, sched[1])(
        train_state_from_numpy(np_state, "cpu"), batch)
    for key in ("loss", "ce", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[key]), float(wm[key]),
                                   rtol=STEP_RTOL, err_msg=key)
    lr = float(wm["lr"])
    for a, b in zip(leaves(mine.params), jax.tree.leaves(theirs.params)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=0,
                                   atol=PARAM_TOL_LR * lr)
