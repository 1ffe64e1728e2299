"""The port's encoder-decoder (whisper-small) against the JAX package's,
on the CPU.

``models/encdec.py``: the sinusoidal table, the init and weight bridge of
the ``enc_blocks``/``dec_blocks`` tree, ``encode`` (RoPE off by position
0, bidirectional), ``forward`` and ``loss_fn``, ``prefill`` (one decoder
prompt of 2048 tokens, through the flash branch) with the cross K/V
written once into the cache, greedy ``decode_step``; ``GenerationEngine``
and ``launch.serve``; and the reference's hazard that no pipeline shard
can hold an encoder-decoder tree.  Inputs come from numpy seeds; JAX
weights cross over through ``params_from_numpy``.  Tolerances: 2e-5 on
the encoder output, 1e-4 on logits (``LOGIT_TOL`` of
``tests/test_torch_hybrid.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import encdec as jencdec
from repro.models import ops_for as jax_ops_for
from repro.serving.engine import GenerationEngine as JaxGenerationEngine
from repro.serving.sharded import plan_shards as jax_plan_shards
from repro.serving.sharded import split_params as jax_split_params
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import common, encdec, ops_for
from repro_torch.params import params_from_numpy, params_to_numpy
from repro_torch.serving import GenerationEngine, ShardModule
from repro_torch.serving.sharded import plan_shards, split_params

ENC_TOL = 2e-5
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


def _flat(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


@pytest.fixture(scope="module")
def model():
    jcfg = jax_get_config("whisper-small").reduced()
    cfg = get_config("whisper-small").reduced()
    assert jcfg.__dict__ == cfg.__dict__
    assert (cfg.n_layers, cfg.enc_layers, cfg.enc_seq) == (2, 2, 64)
    jparams = jax_ops_for(jcfg).init(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, jparams, cfg, params_from_numpy(tree, "cpu"), tree


def audio_batch(cfg, S, seed, B=2):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)
    return {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1),
            "frames": rng.standard_normal(
                (B, cfg.enc_seq, cfg.d_source)).astype(np.float32)}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: _t(v) for k, v in batch.items()}


@pytest.mark.parametrize("n,d", [(64, 256), (1500, 768)],
                         ids=["reduced", "whisper_small"])
def test_sinusoidal_matches_jax(n, d):
    """The fp32 tables agree within one ulp of the largest angle (n - 1
    radians at the first frequency), which is how far the two libraries'
    fp32 angles and sines may part."""
    got = encdec._sinusoidal(n, d, torch.device("cpu")).numpy()
    np.testing.assert_allclose(got, np.asarray(jencdec._sinusoidal(n, d)),
                               atol=float(np.spacing(np.float32(n - 1))),
                               rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_and_weight_bridge_match_the_jax_tree(model, dtype):
    """The port's init builds JAX's tree (``enc_blocks`` and
    ``dec_blocks`` stacked on the layer axis; keys, shapes, dtypes), and
    the bridge carries JAX's bit-exactly both ways."""
    jcfg, _, cfg, _, _ = model
    jtree = jax.tree.map(np.asarray, jax_ops_for(jcfg).init(
        jcfg, jax.random.PRNGKey(1), getattr(jnp, dtype)))
    mine = params_to_numpy(encdec.init_params(
        cfg, torch.Generator().manual_seed(0), "cpu", getattr(torch, dtype)))
    assert ([(p, a.shape, a.dtype) for p, a in _flat(jtree)]
            == [(p, a.shape, a.dtype) for p, a in _flat(mine)])
    assert mine["dec_blocks"]["xattn"]["wk"].shape == (
        cfg.n_layers, cfg.d_model, cfg.kv_dim)
    back = _flat(params_to_numpy(params_from_numpy(jtree, "cpu")))
    for (path, a), (_, b) in zip(_flat(jtree), back):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), path


def test_encoder_position_zero_is_an_exact_identity():
    x = _t(np.random.default_rng(0).standard_normal((2, 9, 3, 64)
                                                    ).astype(np.float32))
    assert torch.equal(common.apply_rope(x, torch.zeros((2, 9),
                                                        dtype=torch.int32),
                                         1e4), x)


def test_encode_matches_jax(model):
    """Bidirectional and kernel-free: the encoder output within 2e-5, and
    no kernel launched, whatever ``FLASH_MIN_SEQ`` says."""
    jcfg, jparams, cfg, params, _ = model
    frames = audio_batch(cfg, 4, 2)["frames"]
    want = jencdec.encode(jparams, jcfg, jnp.asarray(frames))
    ops.reset_launch_counts()
    got = encdec.encode(params, cfg, _t(frames))
    assert not any(ops.launch_counts().values())
    _close(got, want, ENC_TOL)


def test_forward_and_loss_match_jax(model):
    jcfg, jparams, cfg, params, _ = model
    batch = audio_batch(cfg, 40, 3)
    want, _ = jencdec.forward(jparams, jcfg, _jax(batch))
    got, aux = encdec.forward(params, cfg, _torch(batch))
    assert got.shape == (2, 40, cfg.vocab) and float(aux) == 0.0
    _close(got, want)
    jloss, jm = jencdec.loss_fn(jparams, jcfg, _jax(batch))
    loss, m = encdec.loss_fn(params, cfg, _torch(batch))
    assert float(loss) == pytest.approx(float(jloss), abs=LOGIT_TOL)
    assert int(m["n_tokens"]) == int(jm["n_tokens"]) == 80


@pytest.mark.parametrize("S", [37, 2048])
def test_prefill_and_greedy_decode_match_jax(model, S, monkeypatch):
    """Prefill, then greedy decode: the port replays JAX's tokens, logits
    within 1e-4, caches within 1e-4.  The cross K/V in the cache is
    ``cross_kv`` of the encoder output, written once by the prefill and
    left unchanged by every step.  The 2048-token prompt runs the flash
    branch once per decoder layer (its plain version here); the encoder
    never does."""
    calls = []
    real = ops.flash_attention

    def spy(*a, **k):
        calls.append(k)
        return real(*a, **k)

    monkeypatch.setattr(ops, "flash_attention", spy)
    jcfg, jparams, cfg, params, _ = model
    B, steps = 2, 6
    batch = audio_batch(cfg, S, S)
    del batch["labels"]
    jl, jcache = jax.jit(lambda p, b, c: jencdec.prefill(p, jcfg, b, c))(
        jparams, _jax(batch), jencdec.init_cache(jcfg, B, S + steps))
    cache = encdec.init_cache(cfg, B, S + steps, device="cpu")
    tl, cache = encdec.prefill(params, cfg, _torch(batch), cache)
    assert calls == [{"causal": True, "window": 0}] * (
        cfg.n_layers * (S >= common.FLASH_MIN_SEQ))
    enc_out = encdec.encode(params, cfg, _t(batch["frames"]))
    xk0 = cache["layers"]["xk"].clone()
    xv0 = cache["layers"]["xv"].clone()
    for j in range(cfg.n_layers):
        p = {k: v[j] for k, v in params["dec_blocks"]["xattn"].items()}
        k, v = encdec.cross_kv(p, cfg, enc_out)
        assert torch.equal(xk0[j], k) and torch.equal(xv0[j], v)
    jdecode = jax.jit(lambda p, t, c: jencdec.decode_step(p, jcfg, t, c))
    for _ in range(steps):
        _close(tl, jl)
        jt = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        np.testing.assert_array_equal(torch.argmax(tl, -1).numpy(), jt)
        jl, jcache = jdecode(jparams, jnp.asarray(jt), jcache)
        tl, cache = encdec.decode_step(params, cfg, _t(jt), cache)
    _close(tl, jl)
    assert cache["len"] == int(jcache["len"]) == S + steps
    assert torch.equal(cache["layers"]["xk"], xk0)
    assert torch.equal(cache["layers"]["xv"], xv0)
    for key, a in params_to_numpy(cache["layers"]).items():
        np.testing.assert_allclose(a, np.asarray(jcache["layers"][key]),
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)


def test_generation_engine_greedy_matches_jax(model):
    jcfg, jparams, cfg, params, _ = model
    batch = audio_batch(cfg, 30, 8)
    del batch["labels"]
    want, _ = JaxGenerationEngine(jcfg, jparams, max_len=64).generate(
        _jax(batch), 16)
    got, stats = GenerationEngine(cfg, params, max_len=64,
                                  device="cpu").generate(batch, 16)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert stats == {"generated": 32}


def test_cli_serves_whisper_on_the_cpu_when_asked(capsys):
    out = serve.main(["--arch", "whisper-small", "--reduced", "--device",
                      "cpu", "--batch", "2", "--prompt-len", "20", "--gen",
                      "4"])
    vocab = get_config("whisper-small").reduced().vocab
    assert out.shape == (2, 4) and (out >= 0).all() and (out < vocab).all()
    text = capsys.readouterr().out
    assert "arch=whisper-small" in text and "8 tokens" in text


def test_no_pipeline_shard_holds_an_encoder_decoder_tree(model):
    """The reference's hazard, kept: its engine names ``audio`` among the
    fused archs, but ``split_params`` reads ``params["blocks"]``, which an
    encoder-decoder tree lacks, so no shard, and no ``BatchEngine``,
    serves whisper in either package; ``GenerationEngine`` does."""
    jcfg, jparams, cfg, params, _ = model
    with pytest.raises(KeyError, match="blocks"):
        jax_split_params(jcfg, jparams, jax_plan_shards(jcfg, 2))
    with pytest.raises(ValueError, match="'audio' \\(whisper-small\\)"):
        split_params(cfg, params, plan_shards(cfg, 2))
    with pytest.raises(ValueError, match="'audio'"):
        ShardModule(cfg, params, (0, cfg.n_layers), True, True)


def test_ops_for_serves_the_full_config():
    cfg = get_config("whisper-small")
    ops_ = ops_for(cfg)
    assert ops_.prefill is encdec.prefill and ops_.init is encdec.init_params
    tree = jax.eval_shape(lambda: jax_ops_for(jax_get_config("whisper-small"))
                          .init(jax_get_config("whisper-small"),
                                jax.random.PRNGKey(0)))
    assert sum(int(np.prod(a.shape)) for a in jax.tree.leaves(tree)) \
        == 335_106_048


# ---------------------------------------------- the smoke's audio phases

def test_audio_phases_rehearse_on_the_cpu(monkeypatch):
    """``chip_smoke.audio_parity_phase`` (gate A1) and
    ``serving_audio_phase`` (A2, A3 and ``launch.serve``) end to end on
    the CPU at the reduced whisper, ``FLASH_MIN_SEQ`` cut to 128: A1
    holds, the encoder runs once a generation, the cross K/V is
    unchanged by decode, and A3's float64 form holds."""
    import chip_smoke

    lines = []
    monkeypatch.setattr(chip_smoke, "emit", lines.append)
    monkeypatch.setattr(common, "FLASH_MIN_SEQ", 128)
    a1 = chip_smoke.audio_parity_phase(torch, "cpu", prompts=[128, 37])
    assert a1["max_abs_logit_err"]["card32_vs_cpu64"] <= a1["a1_limit"]
    cfg = get_config("whisper-small").reduced()
    chip_smoke.serving_audio_phase(torch, "cpu", cfg, prompts=[40, 128],
                                   cli_prompt=40)
    by = {ln["phase"]: ln for ln in lines}
    for run in by["serving_audio"]["runs"]:
        assert run["encoder_runs"] == 1 and run["cross_kv_unchanged"]
        assert run["cross_kv_bytes_per_session"] == 2 * 2 * 64 * 4 * 64 * 4
        assert run["decode_steps"] == chip_smoke.AUDIO_STEPS
    hand = by["audio_handoff"]
    assert hand["route64_max_abs_diff"] <= 1e-10 * hand["max_abs_logit64"]
    assert hand["handoff32_vs_64"] <= hand["a3_limit"]
    assert hand["bf16_kv_handoff32_vs_64"] > hand["a3_limit"]
    assert "seconds" in by["serving_audio_done"]
