"""The port's vlm (qwen2-vl) and audio (whisper) training paths against
the JAX package's, on the CPU.

Inputs come from numpy seeds; JAX weights and optimizer states cross over
through ``train_state_from_numpy``.  The configs are a reduced
qwen2-vl-7b (L=2, d=64, H=4, Hk=1, M-RoPE sections (2, 3, 3), 16 patch
embeddings on a 4 x 4 grid before the text) and a reduced whisper-small
(L=2, enc_layers 2, enc_seq 64, d=64, H=Hk=4, frames of d_source 768).
Tolerances, fixed before this file's first run
(``tests/test_torch_moe_train.py``'s):

* ``loss_fn`` and its gradient from one state: loss 1e-5 relative, each
  gradient leaf within 1e-5 of its largest |JAX| entry;
* ``make_train_step`` against JAX's jitted one, three steps from one
  state (lr 3e-3, cosine, no warmup), at micro-batches 1 and 2; at each
  step the port steps from JAX's state before it (parameters and AdamW
  moments crossed over), for the reason ``tests/
  test_torch_hybrid_train.py`` gives: loss, grad norm and lr 1e-5
  relative; the parameters after the step within 1e-2 of that step's lr
  in each leaf's root mean square difference.  One case per arch runs at
  S=2048, B=1 (qwen2-vl: 16 patches + 2032 text tokens; whisper: the
  decoder's 2048 tokens), so that both packages take their flash path
  (the JAX custom VJP, the port's ``FlashAttention``), in one
  micro-batch; S=256 runs at B=2 in two;
* ``_micro_split`` equal to JAX's, element for element.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro.configs import get_config as jax_get_config
from repro.data import make_batch_iterator as jax_batches
from repro.models import ops_for as jax_ops_for
from repro.optim import schedules as jsched
from repro.train import step as jstep
from repro_torch.configs import get_config
from repro_torch.optim import constant_schedule, cosine_schedule
from repro_torch.params import train_state_from_numpy
from repro_torch.train import make_train_step
from repro_torch.train import step as tstep
from repro_torch.tree import leaves

GRAD_TOL = 1e-5
STEP_RTOL = 1e-5
PARAM_TOL_LR = 1e-2
SMALL = {"n_layers": 2, "d_model": 64, "vocab": 256}
ARCHS = {"vlm": "qwen2-vl-7b", "audio": "whisper-small"}



@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and this file's small tensor ops run no slower on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _t(x):
    return torch.from_numpy(np.array(x))


def _np(t):
    return t.detach().numpy()


@pytest.fixture(scope="module", params=sorted(ARCHS))
def jax_state(request):
    name = ARCHS[request.param]
    jcfg = jax_get_config(name).reduced(**SMALL)
    cfg = get_config(name).reduced(**SMALL)
    assert jcfg.__dict__ == cfg.__dict__ and cfg.arch == request.param
    state = jax.jit(jstep.train_state_init, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, state, jax.tree.map(np.asarray, state)


def _batch(cfg, B, S, seed):
    """A training batch of ``S`` positions: for vlm, 16 patch embeddings
    ~ N(0, 1) on a 4 x 4 grid before S - 16 text tokens (the labels are
    the text's); for audio, S decoder tokens and frames ~ N(0, 1)."""
    n_text = S - cfg.n_patches if cfg.arch == "vlm" else S
    batch = next(jax_batches(cfg.vocab, n_text, B, seed=seed))
    rng = np.random.default_rng(seed + 1)
    if cfg.arch == "vlm":
        batch["vision_embeds"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model), dtype=np.float32)
        batch["positions3"] = chip_smoke.grid_positions3(cfg.n_patches,
                                                         n_text, B)
    else:
        batch["frames"] = rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_source), dtype=np.float32)
    return batch


def test_loss_fn_and_its_gradient_match_jax(jax_state):
    jcfg, cfg, state, np_state = jax_state
    batch = _batch(cfg, 2, 200, seed=4)
    batch["labels"][0, :7] = -1
    (want, _), want_g = jax.jit(jax.value_and_grad(
        jax_ops_for(jcfg).loss_fn, has_aux=True), static_argnums=1)(
        state.params, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    params = train_state_from_numpy(np_state, "cpu").params
    got, _, grads = make_train_step(cfg, constant_schedule(1e-3)).grads_of(
        params, {k: _t(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=STEP_RTOL)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(want_g)[0]]
    for name, a, b in zip(paths, leaves(grads), jax.tree.leaves(want_g)):
        b = np.asarray(b)
        assert np.abs(b).max() > 0, name
        np.testing.assert_allclose(_np(a), b, rtol=0, err_msg=name,
                                   atol=GRAD_TOL * np.abs(b).max())


#: (S, B, micro-batches)
STEP_CASES = [(256, 2, 2), (2048, 1, 1)]


@pytest.mark.parametrize("S,B,mb", STEP_CASES,
                         ids=[f"S{s}-B{b}-mb{m}" for s, b, m in STEP_CASES])
def test_train_step_matches_jax(jax_state, S, B, mb):
    """Three steps from one state; S=2048 takes both packages' flash
    path (the decoder's self-attention; whisper's encoder and
    cross-attention stay plain ``attention_scores`` in both)."""
    jcfg, cfg, state, np_state = jax_state
    sched = (jsched.cosine_schedule(3e-3, 0, 3), cosine_schedule(3e-3, 0, 3))
    jfn = jax.jit(jstep.make_train_step(jcfg, sched[0], microbatches=mb))
    fn = make_train_step(cfg, sched[1], microbatches=mb)
    theirs = state
    for i in range(3):
        batch = _batch(cfg, B, S, seed=20 + i)
        mine = train_state_from_numpy(jax.tree.map(np.asarray, theirs), "cpu")
        theirs, wm = jfn(theirs, {k: jnp.asarray(v) for k, v in batch.items()})
        mine, m = fn(mine, batch)
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[key]), float(wm[key]),
                                       rtol=STEP_RTOL, err_msg=f"{key} step {i}")
        for a, b in zip(leaves(mine.params), jax.tree.leaves(theirs.params)):
            rms = float(np.sqrt(np.mean((_np(a) - np.asarray(b)) ** 2)))
            assert rms <= PARAM_TOL_LR * float(wm["lr"]), (i, a.shape, rms)
        assert mine.opt.step == int(theirs.opt.step) == i + 1


def test_micro_split_splits_every_input_on_its_batch_axis():
    """``vision_embeds`` (B, n_patches, D), ``frames`` (B, enc_seq,
    d_source), tokens and labels on axis 0, ``positions3`` (3, B, S) on
    axis 1: the port's split equals JAX's."""
    cfg = get_config("qwen2-vl-7b").reduced(**SMALL)
    batch = _batch(cfg, 4, 48, seed=3)
    batch["frames"] = np.random.default_rng(2).standard_normal(
        (4, 8, 5), dtype=np.float32)
    want = jstep._micro_split({k: jnp.asarray(v) for k, v in batch.items()}, 2)
    got = tstep._micro_split({k: _t(v) for k, v in batch.items()}, 2)
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].shape[0] == 2, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


# ------------------------------------------- the smoke's phases, rehearsed

@pytest.mark.parametrize("name", ["qwen2-vl-7b", "whisper-small"])
def test_train_parity_phases_rehearse_on_the_cpu(monkeypatch, name):
    """``chip_smoke.arch_train_parity_phase`` (gates T2v, T2a) end to end
    on the CPU at narrow configs: qwen2-vl's 16 patches on their grid
    before 48 text tokens, whisper's 48 tokens after 64 frames; the
    "card" run is a CPU fp32 run held to cpu64 under T2's bound; no
    kernel launches."""
    lines = []
    monkeypatch.setattr(chip_smoke, "emit", lines.append)
    cfg = get_config(name).reduced(**SMALL)
    out = chip_smoke.arch_train_parity_phase(torch, name, "cpu", n_text=48,
                                             cfg=cfg)
    assert lines == [out]
    assert out["gate"] == chip_smoke.T2_ARCHS[name][0]
    assert out["seq"] == 48 + (16 if cfg.arch == "vlm" else 0)
    for mb in (1, 2):
        r = out[f"mb{mb}"]
        assert r["grad_leaf_ratio_to_bound_max"] <= 1.0
        assert max(max(s) for s in r["step_ratio_to_bound"]) <= 1.0
        assert not any(r["launches_cuda"].values())


@pytest.mark.parametrize("name", ["qwen2-vl-7b", "whisper-small"])
def test_training_phases_rehearse_on_the_cpu(monkeypatch, name):
    """``chip_smoke.arch_training_phase`` (gates T3v, T3a) end to end on
    the CPU at narrow configs through ``Trainer`` over
    ``chip_smoke.train_batches``: the gradient pass holds every leaf,
    whisper's encoder layers among them, nonzero in every layer."""
    lines = []
    monkeypatch.setattr(chip_smoke, "emit", lines.append)
    cfg = get_config(name).reduced(**SMALL)
    chip_smoke.arch_training_phase(torch, name, "cpu", cfg=cfg, n_text=48)
    (line,) = lines
    assert line["gate"] == chip_smoke.T3_ARCHS[name][0]
    assert line["phase"] == f"{cfg.arch}_training"
    assert not any(line["launches"].values())
    assert len(line["loss"]) == chip_smoke.TRAIN_STEPS
    assert len(line["timed_steps"]) == 1


def test_train_batches_carry_each_arch_s_stub_inputs():
    """``chip_smoke.train_batches``: ``launch.train``'s tokens and labels,
    with qwen2-vl's patch embeddings and grid positions, or whisper's
    frames, of the shapes the models take."""
    for name in ARCHS.values():
        cfg = get_config(name).reduced(**SMALL)
        b = next(chip_smoke.train_batches(cfg, 32, 2, seed=1))
        assert b["tokens"].shape == b["labels"].shape == (2, 32)
        if cfg.arch == "vlm":
            assert b["vision_embeds"].shape == (2, 16, cfg.d_model)
            assert b["positions3"].shape == (3, 2, 48)
        else:
            assert b["frames"].shape == (2, cfg.enc_seq, cfg.d_source)


def test_cut_depth_cuts_what_the_launchers_build():
    """``chip_smoke.cut_depth`` (the checkpoint, mesh and fleet phases'
    minicpm-2b) cuts the registry's config, so ``launch.train`` and
    ``launch.serve`` build the cut model, and puts it back after, also
    when the block raises."""
    full = get_config("minicpm-2b")
    with chip_smoke.cut_depth("minicpm-2b", chip_smoke.CKPT_LAYERS) as cut:
        assert get_config("minicpm-2b") is cut
        assert cut.n_layers == chip_smoke.CKPT_LAYERS < full.n_layers
        assert cut.d_model == full.d_model and cut.vocab == full.vocab
    assert get_config("minicpm-2b") is full
    with pytest.raises(KeyError):
        with chip_smoke.cut_depth("minicpm-2b", 3):
            raise KeyError("x")
    assert get_config("minicpm-2b") is full


def test_t2_runs_keep_step_one_s_gradients_before_clipping():
    """``chip_smoke.t2_run`` keeps step 1's gradient leaves as the step
    computed them, before its update clips them in place, in float32 and
    in float64 (where ``.double().cpu()`` of a CPU leaf is the leaf
    itself): equal to ``grads_of`` on the same state and batch."""
    from repro_torch.optim import constant_schedule

    cfg = get_config("whisper-small").reduced(**SMALL)
    cfg, base, batches = chip_smoke.t2_inputs(torch, "whisper-small", 32,
                                             cfg)
    for dt in (np.float32, np.float64):
        first, hist, _ = chip_smoke.t2_run(torch, cfg, base, batches[:1], 1,
                                           dt, "cpu")
        assert hist[0][1] > 1.0          # the step clipped its gradients
        _, _, want = make_train_step(cfg, constant_schedule(1e-3)).grads_of(
            chip_smoke.t2_state(base, dt, "cpu").params,
            {k: _t(v) for k, v in batches[0].items()})
        for a, b in zip(first, leaves(want)):
            np.testing.assert_array_equal(a, b.double().numpy())
