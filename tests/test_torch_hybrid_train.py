"""The port's hybrid (hymba) training path against the JAX package's, on
the CPU.

Inputs come from numpy seeds; JAX weights and optimizer states cross over
through ``params_from_numpy`` / ``train_state_from_numpy``.  The config is
a reduced hymba-1.5b (L=2, d=64, H=4, Hk=1, window 64, ssm_state 8,
d_inner 128, vocab 256).  Tolerances, fixed before this file's first run
(``tests/test_torch_moe_train.py``'s):

* ``run_mamba``'s gradients against ``jax.vjp`` of JAX's ``run_mamba``
  with random cotangents, at S=256 (two chunks of ``MAMBA_CHUNK``) and
  S=100 (one chunk of S), fp32: dx and each weight's gradient within
  1e-5 of its largest |JAX| entry;
* under grad, ``run_mamba``'s forward equal to its no-grad forward to
  the bit;
* the recompute, held by bytes: ``run_mamba`` under grad at B=1, S=1024
  (eight chunks), d_in=128, N=8, keeps no more than 16 x B·S·d_in·4
  bytes for its backward: the unique storages of every tensor autograd
  saves (``saved_tensors_hooks``) and of every input a chunk's
  ``checkpoint`` holds.  The same loop without the recompute (the
  checkpoint called through, today's loop before the recompute) is the
  negative control and must read over that limit;
* ``loss_fn`` and its gradient from one state: loss 1e-5 relative, each
  gradient leaf within 1e-5 of its largest |JAX| entry;
* ``make_train_step`` against JAX's jitted one, three steps from one
  state (lr 3e-3, cosine, no warmup), at micro-batches 1 and 2; at each
  step the port steps from JAX's state before it (parameters and AdamW
  moments crossed over): loss, grad norm and lr 1e-5 relative; the
  parameters after the step within 1e-2 of that step's lr in each leaf's
  root mean square difference.  (On separate trajectories, as
  ``tests/test_torch_moe_train.py`` runs them, fp32 rounding of a
  gradient element far below its leaf's largest compounds: AdamW divides
  each element by its own magnitude plus 1e-8, so a qwen2-vl ``wo``
  element at 3.3e-7 of its leaf, -8.88e-8 in JAX and -6.75e-8 in the
  port, moved 0.06 of the lr apart in one step, and a later step's grad
  norm then read 1.08e-5 apart while step 1's agreed to 3.2e-7.)  S=2048
  (B=1, one micro-batch) takes both packages' flash path under the
  window (the JAX custom VJP, the port's ``FlashAttention``); S=256 runs
  at B=2 in two micro-batches.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro.configs import get_config as jax_get_config
from repro.data import make_batch_iterator as jax_batches
from repro.models import decoder as jdec
from repro.models import ssm as jssm
from repro.optim import schedules as jsched
from repro.train import step as jstep
from repro_torch.configs import get_config
from repro_torch.launch import train as launch_train
from repro_torch.models import ssm
from repro_torch.optim import constant_schedule, cosine_schedule
from repro_torch.params import params_from_numpy, train_state_from_numpy
from repro_torch.train import make_train_step, train_state_init
from repro_torch.tree import leaves

VJP_TOL = 1e-5
GRAD_TOL = 1e-5
STEP_RTOL = 1e-5
PARAM_TOL_LR = 1e-2
#: the recompute's limit in units of B·S·d_in·4 bytes
SAVED_LIMIT = 16
HYB_KW = {"n_layers": 2, "d_model": 64, "vocab": 256}



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


def _reduced(**kw):
    kw = {**HYB_KW, **kw}
    jcfg = jax_get_config("hymba-1.5b").reduced(**kw)
    cfg = get_config("hymba-1.5b").reduced(**kw)
    assert jcfg.__dict__ == cfg.__dict__ and cfg.window == 64
    return jcfg, cfg


@pytest.fixture(scope="module")
def jax_state():
    jcfg, cfg = _reduced()
    state = jax.jit(jstep.train_state_init, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, state, jax.tree.map(np.asarray, state)


def _mamba(jax_state, layer=0):
    """Layer ``layer``'s Mamba weights of the shared state, in both
    packages."""
    jcfg, cfg, state, np_state = jax_state
    jp = jax.tree.map(lambda a: a[layer], state.params["blocks"]["mamba"])
    tree = jax.tree.map(lambda a: a[layer],
                        np_state.params["blocks"]["mamba"])
    p = {k: v.requires_grad_(True)
         for k, v in params_from_numpy(tree, "cpu").items()}
    return jcfg, cfg, jp, p


# ------------------------------------------------------------------ Mamba

@pytest.mark.parametrize("S", [256, 100], ids=["two_chunks", "one_chunk"])
def test_run_mamba_gradients_match_jax(jax_state, S):
    jcfg, cfg, jp, p = _mamba(jax_state)
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    cot = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)

    @jax.jit
    def vjp(a, b, c):
        y, back = jax.vjp(lambda a, b: jssm.run_mamba(a, jcfg, b)[0], a, b)
        return y, back(c)

    want, (dp_j, dx_j) = vjp(jp, jnp.asarray(x), jnp.asarray(cot))
    xt = _t(x).requires_grad_(True)
    y, _ = ssm.run_mamba(p, cfg, xt)
    np.testing.assert_allclose(_np(y), np.asarray(want), atol=2e-4, rtol=2e-4)
    names = sorted(p)
    got = torch.autograd.grad(y, [xt] + [p[k] for k in names], _t(cot))
    for name, a, b in zip(["x"] + names, got, [dx_j] + [dp_j[k]
                                                     for k in names]):
        b = np.asarray(b)
        assert np.abs(b).max() > 0, name
        np.testing.assert_allclose(_np(a), b, rtol=0, err_msg=name,
                                   atol=VJP_TOL * np.abs(b).max())


@pytest.mark.parametrize("S", [256, 100], ids=["two_chunks", "one_chunk"])
def test_run_mamba_forward_under_grad_is_the_no_grad_forward(jax_state, S):
    _, cfg, _, p = _mamba(jax_state, layer=1)
    x = _t(np.random.default_rng(S + 1).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        plain, _ = ssm.run_mamba(p, cfg, x)
    y, _ = ssm.run_mamba(p, cfg, x.clone().requires_grad_(True))
    assert y.requires_grad and torch.equal(y.detach(), plain)


def _saved_bytes(p, cfg, x, monkeypatch, recompute):
    """Bytes of the unique storages that ``run_mamba`` under grad keeps
    for its backward: what autograd saves outside a chunk's checkpoint,
    and the inputs each checkpoint holds for its recompute.  Without
    ``recompute`` the checkpoint is called through, as the loop ran
    before it had one."""
    seen = {}

    def keep(t):
        st = t.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()

    real = ssm.checkpoint

    def held(fn, *args, **kw):
        if not recompute:
            return fn(*args)
        for a in args:
            if isinstance(a, torch.Tensor):
                keep(a)
        return real(fn, *args, **kw)

    monkeypatch.setattr(ssm, "checkpoint", held)

    def pack(t):
        keep(t)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y, _ = ssm.run_mamba(p, cfg, x)
    y.sum().backward()                  # the recompute runs and agrees
    return sum(seen.values())


@pytest.mark.parametrize("recompute", [True, False],
                         ids=["recompute", "control_without_it"])
def test_the_recompute_keeps_saved_bytes_under_the_limit(jax_state,
                                                         monkeypatch,
                                                         recompute):
    _, cfg, _, p = _mamba(jax_state)
    B, S = 1, 1024
    assert S // ssm.MAMBA_CHUNK == 8 and (cfg.d_in, cfg.ssm_state) == (128, 8)
    x = _t(np.random.default_rng(5).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)).requires_grad_(True)
    unit = B * S * cfg.d_in * 4
    ratio = _saved_bytes(p, cfg, x, monkeypatch, recompute) / unit
    print(f"saved {ratio:.3f} x B*S*d_in*4 bytes (recompute={recompute})")
    if recompute:
        assert ratio <= SAVED_LIMIT, ratio
    else:
        assert ratio > SAVED_LIMIT, ratio


# ------------------------------------------------------------- train step

def _batch(vocab, B, S, seed):
    return next(jax_batches(vocab, S, B, seed=seed))


def test_loss_fn_and_its_gradient_match_jax(jax_state):
    jcfg, cfg, state, np_state = jax_state
    batch = _batch(cfg.vocab, 2, 200, seed=4)
    batch["labels"][0, :7] = -1
    (want, _), want_g = jax.jit(jax.value_and_grad(
        jdec.loss_fn, has_aux=True), static_argnums=1)(
        state.params, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    params = train_state_from_numpy(np_state, "cpu").params
    got, _, grads = make_train_step(cfg, constant_schedule(1e-3)).grads_of(
        params, {k: _t(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=STEP_RTOL)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(want_g)[0]]
    assert any("mamba" in p for p in paths)
    for name, a, b in zip(paths, leaves(grads), jax.tree.leaves(want_g)):
        b = np.asarray(b)
        np.testing.assert_allclose(_np(a), b, rtol=0, err_msg=name,
                                   atol=GRAD_TOL * np.abs(b).max())


#: (S, B, micro-batches)
STEP_CASES = [(256, 2, 2), (2048, 1, 1)]


@pytest.mark.parametrize("S,B,mb", STEP_CASES,
                         ids=[f"S{s}-B{b}-mb{m}" for s, b, m in STEP_CASES])
def test_train_step_matches_jax(jax_state, S, B, mb):
    """Three steps from one state; S=2048 takes the flash path under the
    window in both packages."""
    jcfg, cfg, state, np_state = jax_state
    sched = (jsched.cosine_schedule(3e-3, 0, 3), cosine_schedule(3e-3, 0, 3))
    jfn = jax.jit(jstep.make_train_step(jcfg, sched[0], microbatches=mb))
    fn = make_train_step(cfg, sched[1], microbatches=mb)
    theirs = state
    for i in range(3):
        batch = _batch(cfg.vocab, B, S, seed=20 + i)
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


def test_remat_wraps_a_hybrid_block_and_keeps_its_gradients(monkeypatch):
    """``cfg.remat`` recomputes each hybrid block (its Mamba chunks
    recomputed inside) and gives the same loss and, within ``GRAD_TOL``
    of each leaf's largest entry, the same gradients (the embedding's
    scatter-add need not repeat to the bit on this CPU, even between two
    plain passes); every layer of every Mamba leaf gets a gradient."""
    from repro_torch.models import decoder

    _, cfg = _reduced()
    state = train_state_init(cfg, torch.Generator().manual_seed(2), "cpu")
    batch = {k: _t(v) for k, v in _batch(cfg.vocab, 2, 256, seed=2).items()}
    plain = make_train_step(cfg, constant_schedule(1e-3)).grads_of
    remat = make_train_step(dataclasses.replace(cfg, remat=True),
                            constant_schedule(1e-3)).grads_of
    la, _, ga = plain(state.params, batch)
    calls, real = [], decoder.checkpoint

    def counted(fn, *a, **kw):
        calls.append(fn.__name__)
        return real(fn, *a, **kw)

    monkeypatch.setattr(decoder, "checkpoint", counted)
    lb, _, gb = remat(state.params, batch)
    assert calls == ["run_block"] * cfg.n_layers
    assert torch.equal(la, lb)
    for a, b in zip(leaves(ga), leaves(gb)):
        np.testing.assert_allclose(_np(b), _np(a), rtol=0,
                                   atol=GRAD_TOL * a.abs().max().item())
    for name, g in ga["blocks"]["mamba"].items():
        assert all(g[j].abs().sum() > 0 for j in range(cfg.n_layers)), name


def test_launch_train_runs_hymba_on_the_cpu():
    hist = launch_train.main(["--arch", "hymba-1.5b", "--reduced", "--device",
                              "cpu", "--steps", "2", "--seq", "256",
                              "--batch", "2", "--d-model", "64",
                              "--microbatches", "2"])
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    assert all(np.isfinite(h["grad_norm"]) and h["grad_norm"] > 0
               for h in hist)


# ------------------------------------------- the smoke's phases, rehearsed

def test_hybrid_train_parity_phase_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.arch_train_parity_phase`` (gate T2h) end to end on the
    CPU at a narrow hymba and S=48: the "card" run is a CPU fp32 run, held
    to cpu64 under T2's bound; no kernel launches."""
    lines = []
    monkeypatch.setattr(chip_smoke, "emit", lines.append)
    _, cfg = _reduced()
    out = chip_smoke.arch_train_parity_phase(torch, "hymba-1.5b", "cpu",
                                             n_text=48, cfg=cfg)
    assert lines == [out] and out["gate"] == "T2h" and out["seq"] == 48
    for mb in (1, 2):
        r = out[f"mb{mb}"]
        assert r["grad_leaf_ratio_to_bound_max"] <= 1.0
        assert max(max(s) for s in r["step_ratio_to_bound"]) <= 1.0
        assert len(r["step_ratio_to_bound"]) == chip_smoke.T2_STEPS
        assert not any(r["launches_cuda"].values())


def test_hybrid_training_phase_rehearses_on_the_cpu(monkeypatch, capsys):
    """``chip_smoke.arch_training_phase`` (gate T3h) end to end on the CPU:
    ``launch.train.main`` at a narrow hymba, then the gradient pass that
    holds every Mamba leaf nonzero in every layer, and a timed step."""
    lines = []
    monkeypatch.setattr(chip_smoke, "emit", lines.append)
    _, cfg = _reduced()
    chip_smoke.arch_training_phase(torch, "hymba-1.5b", "cpu", cfg=cfg,
                                   n_text=64)
    (line,) = lines
    assert line["phase"] == "hybrid_training" and line["gate"] == "T3h"
    assert "family=hybrid" in capsys.readouterr().out
    assert not any(line["launches"].values())
    assert len(line["loss"]) == chip_smoke.TRAIN_STEPS
    assert len(line["timed_steps"]) == 1 and line["seq"] == 64
