"""The port's dense decoder against the JAX package's, on the same weights.

The JAX parameter tree crosses over through the weight bridge; forward,
prefill (including one long enough for the flash branch) and greedy
decode must agree within 1e-4 on the logits, with identical tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import decoder as jdec
from repro.models import ops_for as jax_ops_for
from repro_torch.configs import get_config
from repro_torch.models import decoder
from repro_torch.models.common import FLASH_MIN_SEQ
from repro_torch.params import params_from_numpy, params_to_numpy

LOGIT_TOL = 1e-4
#: reduced granite-8b: the default reduction (one kv head for four query
#: heads), and one with two kv heads for real grouped-query sharing
CASES = {"hk1": {}, "hk2": {"n_kv_heads": 2}}


def _configs(case):
    kw = dict(n_layers=4, d_model=64, vocab=256, **CASES[case])
    return (jax_get_config("granite-8b").reduced(**kw),
            get_config("granite-8b").reduced(**kw))


@pytest.fixture(scope="module", params=sorted(CASES))
def model(request):
    jcfg, cfg = _configs(request.param)
    assert jcfg.__dict__ == cfg.__dict__
    jparams = jax_ops_for(jcfg).init(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, jparams, cfg, params_from_numpy(tree, "cpu"), tree


def test_weight_bridge_roundtrip_is_bit_exact(model):
    *_, params, tree = model
    back = params_to_numpy(params)
    flat_a = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), path


def test_forward_matches_jax(model):
    jcfg, jparams, cfg, params, _ = model
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (2, 24),
                                               dtype=np.int32)
    want, _ = jdec.forward(jparams, jcfg, {"tokens": jnp.asarray(tokens)})
    got, _ = decoder.forward(params, cfg, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL,
                               rtol=0)


def test_prefill_and_greedy_decode_match_jax(model):
    jcfg, jparams, cfg, params, _ = model
    B, S, steps = 2, 11, 16
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (B, S),
                                               dtype=np.int32)
    jprefill = jax.jit(lambda p, b, c: jdec.prefill(p, jcfg, b, c))
    jdecode = jax.jit(lambda p, t, c: jdec.decode_step(p, jcfg, t, c))
    jcache = jdec.init_cache(jcfg, B, S + steps)
    jl, jcache = jprefill(jparams, {"tokens": jnp.asarray(tokens)}, jcache)
    cache = decoder.init_cache(cfg, B, S + steps, device="cpu")
    tl, cache = decoder.prefill(params, cfg, {"tokens": torch.from_numpy(tokens)},
                                cache)
    for _ in range(steps):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                                   rtol=0)
        jt = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        tt = torch.argmax(tl, dim=-1).to(torch.int32)
        np.testing.assert_array_equal(tt.numpy(), jt)
        jl, jcache = jdecode(jparams, jnp.asarray(jt), jcache)
        tl, cache = decoder.decode_step(params, cfg, tt, cache)
    assert cache["len"] == int(jcache["len"]) == S + steps


def test_long_prefill_takes_flash_branch_and_matches_jax(model):
    jcfg, jparams, cfg, params, _ = model
    S = FLASH_MIN_SEQ
    tokens = np.random.default_rng(2).integers(0, cfg.vocab, (1, S),
                                               dtype=np.int32)
    jl, _ = jax.jit(lambda p, b, c: jdec.prefill(p, jcfg, b, c))(
        jparams, {"tokens": jnp.asarray(tokens)}, jdec.init_cache(jcfg, 1, S + 1))
    tl, cache = decoder.prefill(params, cfg, {"tokens": torch.from_numpy(tokens)},
                                decoder.init_cache(cfg, 1, S + 1, device="cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL, rtol=0)
    assert cache["len"] == S


def test_cached_flash_prefill_refuses_a_nonempty_cache(model):
    """A block of FLASH_MIN_SEQ or more tokens takes the flash branch,
    which attends over the block alone from position 0: after cached
    tokens that would ignore them, so the port raises."""
    _, _, cfg, params, _ = model
    S = FLASH_MIN_SEQ
    cache = decoder.init_cache(cfg, 1, S + 1, device="cpu")
    _, cache = decoder.prefill(params, cfg,
                               {"tokens": torch.zeros((1, 1), dtype=torch.int32)},
                               cache)
    with pytest.raises(ValueError, match="empty cache"):
        decoder.apply_layers_cached(
            params["blocks"], cfg, torch.zeros((1, S, cfg.d_model)),
            torch.arange(1, S + 1)[None], cache)


def test_other_archs_are_not_ported_yet():
    """Kept under its first name: every arch serves, and every arch
    trains.  ``make_train_step`` takes every config of the registry, the
    xLSTM one (``tests/test_torch_xlstm_train.py``) and the hybrid, vlm
    and audio ones (``tests/test_torch_hybrid_train.py``,
    ``tests/test_torch_audio_vlm_train.py``) among them."""
    from repro_torch.configs import ARCH_IDS
    from repro_torch.optim import constant_schedule
    from repro_torch.train.step import make_train_step
    for arch in ARCH_IDS:
        for cfg in (get_config(arch), get_config(arch).reduced()):
            assert callable(make_train_step(cfg, constant_schedule(1e-3))), \
                cfg.name