"""The port's training path against the JAX package's, on the CPU.

Inputs come from numpy seeds; JAX weights and optimizer states cross over
through ``params_from_numpy`` / ``train_state_from_numpy``.  Tolerances,
fixed before this file's first run:

* ``FlashAttention`` (plain route) against ``jax.vjp`` of
  ``flash_attention_jnp``: out 2e-5, lse 1e-5 (against
  ``_flash_fwd_impl``'s), dq/dk/dv atol = rtol = 1e-4;
* the plain backward in float64 against float64 autograd of the naive
  S x S attention: 1e-9;
* ``cross_entropy`` / ``loss_fn``: 1e-6; the schedules: 1e-7 of the
  schedule's peak lr (first stated as 1e-7 of each value: XLA's float32
  cos and exp differ from torch's by an ulp on some inputs, and where
  1 + cos is small, near a cosine's end, that ulp is up to 2.7e-7 of the
  value); ``adamw_update`` and ``clip_by_global_norm``: 1e-6;
* the batch iterator: bit-equal;
* ``make_train_step`` on a reduced minicpm-2b (L=2, d=256, H=4, hd=64,
  vocab 256) from one state: losses, ce, grad norm and lr 1e-5 relative
  over five steps; parameters after one step within 1e-2 * lr.
"""

import dataclasses
import math
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data import make_batch_iterator as jax_batches
from repro.models import decoder as jdec
from repro.models.chunked import _flash_fwd_impl, flash_attention_jnp
from repro.optim import adamw as jadamw
from repro.optim import clip as jclip
from repro.optim import schedules as jsched
from repro.train import step as jstep
from repro_torch.configs import get_config
from repro_torch.data import make_batch_iterator
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (flash_attention_bwd_plain,
                                                 flash_attention_plain)
from repro_torch.launch import train as launch_train
from repro_torch.models import decoder
from repro_torch.models.chunked import FlashAttention
from repro_torch.optim import (AdamWState, adamw_update, clip_by_global_norm,
                               constant_schedule, cosine_schedule,
                               wsd_schedule)
from repro_torch.tree import leaves
from repro_torch.params import (params_from_numpy, train_state_from_numpy,
                                train_state_to_numpy)
from repro_torch.train import Trainer, make_train_step, train_state_init

ROOT = Path(__file__).resolve().parents[1]
OUT_TOL, LSE_TOL, GRAD_TOL = 2e-5, 1e-5, 1e-4
F64_TOL = 1e-9
LOSS_TOL = 1e-6
SCHED_RTOL = 1e-7
OPT_TOL = 1e-6
STEP_RTOL = 1e-5
#: parameters after one step, in units of that step's lr
PARAM_TOL_LR = 1e-2


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


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _np(t):
    return t.detach().numpy()


# --------------------------------------------------------- flash attention

def _qkvo(seed, B, S, H, hd):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, S, H, hd)).astype(np.float32)
            for _ in range(4)]


@pytest.mark.parametrize("B,S,H,hd,window", [
    (1, 2048, 2, 64, 0), (1, 2048, 2, 64, 256), (2, 1024, 2, 32, 0)])
def test_flash_function_matches_the_jax_vjp(B, S, H, hd, window):
    q, k, v, do = _qkvo(S + window, B, S, H, hd)
    out_j, vjp = jax.vjp(
        lambda a, b, c: flash_attention_jnp(a, b, c, True, window),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    dq_j, dk_j, dv_j = vjp(jnp.asarray(do))
    _, lse_j = _flash_fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               True, window, 0, 1024)          # (B, S, H)

    qt, kt, vt = (_t(x).transpose(1, 2).requires_grad_(True) for x in (q, k, v))
    out = FlashAttention.apply(qt, kt, vt, True, window)
    out.backward(_t(do).transpose(1, 2))
    _, lse = flash_attention_plain(qt.detach(), kt.detach(), vt.detach(),
                                   window=window, return_lse=True)
    np.testing.assert_allclose(_np(out.transpose(1, 2)), np.asarray(out_j),
                               atol=OUT_TOL, rtol=0)
    np.testing.assert_allclose(_np(lse.transpose(1, 2)), np.asarray(lse_j),
                               atol=LSE_TOL, rtol=0)
    for got, want in ((qt.grad, dq_j), (kt.grad, dk_j), (vt.grad, dv_j)):
        np.testing.assert_allclose(_np(got.transpose(1, 2)), np.asarray(want),
                                   atol=GRAD_TOL, rtol=GRAD_TOL)


def test_ops_flash_attention_is_differentiable_through_the_function():
    """Under grad the dispatcher routes through ``FlashAttention`` (the CPU
    counts no launch); without grad it returns the same forward."""
    q, k, v, do = _qkvo(3, 1, 96, 2, 32)
    before = ops.launch_counts()
    leaves_ = [_t(x).requires_grad_(True) for x in (q, k, v)]
    out = ops.flash_attention(*leaves_, causal=True, window=17)
    assert out.grad_fn is not None
    out.backward(_t(do))
    assert all(t.grad is not None and t.grad.abs().sum() > 0 for t in leaves_)
    with torch.no_grad():
        again = ops.flash_attention(*leaves_, causal=True, window=17)
    assert again.grad_fn is None and torch.equal(again, out.detach())
    assert ops.launch_counts() == before


def _naive(q, k, v, causal, window):
    Sq, Sk = q.shape[2], k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(q.shape[-1])
    if causal:
        qpos = Sk - Sq + torch.arange(Sq)[:, None]
        kpos = torch.arange(Sk)[None, :]
        ok = kpos <= qpos
        if window > 0:
            ok &= kpos > qpos - window
        s = s.masked_fill(~ok, -math.inf)
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1), v)


@pytest.mark.parametrize("B,H,Sq,Sk,causal,window", [
    (1, 2, 64, 64, True, 0), (2, 2, 97, 97, True, 0), (1, 2, 130, 130, True, 17),
    (1, 1, 40, 100, True, 0), (1, 2, 48, 80, False, 0), (1, 1, 60, 60, True, 1)])
def test_flash_bwd_plain_float64_matches_autograd_of_naive_attention(
        B, H, Sq, Sk, causal, window):
    rng = np.random.default_rng(Sq + Sk)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, H, S, 16))).requires_grad_(True)
               for S in (Sq, Sk, Sk))
    do = torch.from_numpy(rng.normal(size=(B, H, Sq, 16)))
    _naive(q, k, v, causal, window).backward(do)
    with torch.no_grad():
        out, lse = flash_attention_plain(q, k, v, causal=causal, window=window,
                                         return_lse=True)
        got = flash_attention_bwd_plain(q, k, v, out, lse, do, causal=causal,
                                        window=window)
    for g, t in zip(got, (q, k, v)):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), t.grad.numpy(), atol=F64_TOL,
                                   rtol=0)


# ------------------------------------------------------------ loss and optim

def test_cross_entropy_ignores_negative_labels_as_jax():
    rng = np.random.default_rng(0)
    logits = (3 * rng.normal(size=(2, 33, 257))).astype(np.float32)
    labels = rng.integers(0, 257, size=(2, 33)).astype(np.int32)
    labels[:, -1] = -1
    labels[1, :5] = -1
    want, n_want = jdec.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    got, n_got = decoder.cross_entropy(_t(logits), _t(labels))
    assert int(n_got) == int(n_want) == 2 * 33 - 7
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_TOL)
    none, n_none = decoder.cross_entropy(_t(logits), _t(np.full_like(labels, -1)))
    assert float(none) == 0.0 and int(n_none) == 1


def _reduced(**kw):
    kw = {"n_layers": 2, "d_model": 256, "vocab": 256, **kw}
    jcfg = jax_get_config("minicpm-2b").reduced(**kw)
    cfg = get_config("minicpm-2b").reduced(**kw)
    assert jcfg.__dict__ == cfg.__dict__ and cfg.hd == 64
    return jcfg, cfg


@pytest.fixture(scope="module")
def jax_state():
    jcfg, cfg = _reduced()
    state = jstep.train_state_init(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, state, jax.tree.map(np.asarray, state)


def _batch(vocab, B, S, seed):
    return next(jax_batches(vocab, S, B, seed=seed))


def test_loss_fn_matches_jax(jax_state):
    jcfg, cfg, state, np_state = jax_state
    batch = _batch(cfg.vocab, 2, 64, seed=4)
    batch["labels"][0, :7] = -1
    want, wm = jdec.loss_fn(state.params, jcfg,
                            {k: jnp.asarray(v) for k, v in batch.items()})
    params = params_from_numpy(np_state.params, "cpu")
    got, m = decoder.loss_fn(params, cfg, {k: _t(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_TOL)
    np.testing.assert_allclose(float(m["ce"]), float(wm["ce"]), rtol=LOSS_TOL)
    assert int(m["n_tokens"]) == int(wm["n_tokens"]) == 2 * 64 - 2 - 7


def test_schedules_match_jax():
    cases = [(3e-3, "constant_schedule", ()), (3e-3, "cosine_schedule", (10, 200)),
             (1e-3, "cosine_schedule", (0, 150, 0.05)),
             (1e-3, "wsd_schedule", (10, 140, 40)),
             (2e-3, "wsd_schedule", (20, 100, 60, 0.1))]
    schedules = {"constant_schedule": constant_schedule,
                 "cosine_schedule": cosine_schedule, "wsd_schedule": wsd_schedule}
    for lr, name, args in cases:
        mine, theirs = schedules[name](lr, *args), getattr(jsched, name)(lr, *args)
        got = np.array([mine(s) for s in range(201)])
        want = np.array([float(theirs(s)) for s in range(201)])
        np.testing.assert_allclose(got, want, rtol=0, atol=SCHED_RTOL * lr,
                                   err_msg=f"{name}{args}")


def _random_tree(rng, positive=False):
    mk = lambda *s: (np.abs(rng.normal(size=s)) * 1e-3 if positive
                     else rng.normal(size=s)).astype(np.float32)
    return {"a": mk(3, 5), "blocks": {"w": mk(2, 4, 6), "b": mk(2, 6)},
            "z": mk(7)}


def test_adamw_update_and_clip_match_jax():
    rng = np.random.default_rng(1)
    params, grads = _random_tree(rng), _random_tree(rng)
    mu, nu = _random_tree(rng), _random_tree(rng, positive=True)
    jp, jo = jadamw.adamw_update(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, grads),
        jadamw.AdamWState(jnp.int32(3), jax.tree.map(jnp.asarray, mu),
                          jax.tree.map(jnp.asarray, nu)),
        jnp.float32(2e-3), weight_decay=0.1)
    p, g = params_from_numpy(params, "cpu"), params_from_numpy(grads, "cpu")
    st = AdamWState(3, params_from_numpy(mu, "cpu"), params_from_numpy(nu, "cpu"))
    st = adamw_update(p, g, st, 2e-3, weight_decay=0.1)
    assert st.step == int(jo.step) == 4
    for got, want in ((p, jp), (st.mu, jo.mu), (st.nu, jo.nu)):
        for a, b in zip(leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=OPT_TOL,
                                       rtol=OPT_TOL)

    for max_norm in (0.5, 1e3):
        want, wn = jclip.clip_by_global_norm(jax.tree.map(jnp.asarray, grads),
                                             max_norm)
        got, n = clip_by_global_norm(params_from_numpy(grads, "cpu"), max_norm)
        np.testing.assert_allclose(float(n), float(wn), rtol=OPT_TOL)
        for a, b in zip(leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=OPT_TOL,
                                       rtol=OPT_TOL)


def test_batch_iterator_is_bit_equal_to_jax():
    for shards, shard in ((1, 0), (2, 0), (2, 1), (4, 3)):
        mine = make_batch_iterator(300, 48, 8, n_shards=shards, shard=shard,
                                   seed=7)
        theirs = jax_batches(300, 48, 8, n_shards=shards, shard=shard, seed=7)
        for _ in range(3):
            a, b = next(mine), next(theirs)
            assert a.keys() == b.keys()
            for key in a:
                assert a[key].dtype == b[key].dtype
                np.testing.assert_array_equal(a[key], b[key])


# ------------------------------------------------------------- train step

def test_train_state_crosses_over_bit_exactly(jax_state):
    *_, np_state = jax_state
    state = train_state_from_numpy(np_state, "cpu")
    assert all(p.requires_grad for p in leaves(state.params))
    back = train_state_to_numpy(state)
    assert back.opt.step == np_state.opt.step and back.opt.step.dtype == np.int32
    for tree in ("params", "mu", "nu"):
        a = back.params if tree == "params" else getattr(back.opt, tree)
        b = np_state.params if tree == "params" else getattr(np_state.opt, tree)
        fa, fb = jax.tree_util.tree_flatten_with_path(a)[0], \
            jax.tree_util.tree_flatten_with_path(b)[0]
        assert [p for p, _ in fa] == [p for p, _ in fb]
        for (_, x), (_, y) in zip(fa, fb):
            assert np.array_equal(x.view(np.uint8), y.view(np.uint8))


STEP_CASES = [(64, 1), (64, 2), (2048, 1), (2048, 2)]


@pytest.mark.parametrize("S,mb", STEP_CASES,
                         ids=[f"S{s}-mb{m}" for s, m in STEP_CASES])
def test_train_step_matches_jax(jax_state, S, mb):
    """One and five steps from one state; S=2048 takes the flash path in
    both packages (the JAX custom VJP, the port's FlashAttention)."""
    jcfg, cfg, state, np_state = jax_state
    sched = (jsched.cosine_schedule(3e-3, 2, 5), cosine_schedule(3e-3, 2, 5))
    jfn = jax.jit(jstep.make_train_step(jcfg, sched[0], microbatches=mb))
    fn = make_train_step(cfg, sched[1], microbatches=mb)
    mine = train_state_from_numpy(np_state, "cpu")
    theirs = state
    for i in range(5):
        batch = _batch(cfg.vocab, 2, S, seed=10 + i)
        theirs, wm = jfn(theirs, {k: jnp.asarray(v) for k, v in batch.items()})
        mine, m = fn(mine, batch)
        for key in ("loss", "ce", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[key]), float(wm[key]),
                                       rtol=STEP_RTOL, err_msg=f"{key} step {i}")
        if i == 0:
            lr = float(wm["lr"])
            for a, b in zip(leaves(mine.params), jax.tree.leaves(theirs.params)):
                np.testing.assert_allclose(_np(a), np.asarray(b), rtol=0,
                                           atol=PARAM_TOL_LR * lr)
    assert mine.opt.step == int(theirs.opt.step) == 5


def test_micro_batches_average_the_gradient():
    """Two micro-batches give the full batch's gradient (summed g/2)."""
    _, cfg = _reduced(n_layers=1)
    state = train_state_init(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = {k: _t(v) for k, v in _batch(cfg.vocab, 4, 32, seed=1).items()}
    one = make_train_step(cfg, constant_schedule(1e-3)).grads_of
    two = make_train_step(cfg, constant_schedule(1e-3), microbatches=2).grads_of
    # every micro-batch has the same number of valid labels, so the mean of
    # the two means is the full mean
    (l1, _, g1), (l2, _, g2) = one(state.params, batch), two(state.params, batch)
    np.testing.assert_allclose(float(l2), float(l1), rtol=1e-6)
    for a, b in zip(leaves(g1), leaves(g2)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-4, atol=1e-7)


def test_remat_gives_the_same_gradients():
    _, cfg = _reduced()
    state = train_state_init(cfg, torch.Generator().manual_seed(2), "cpu")
    batch = {k: _t(v) for k, v in _batch(cfg.vocab, 2, 48, seed=2).items()}
    plain = make_train_step(cfg, constant_schedule(1e-3)).grads_of
    remat = make_train_step(dataclasses.replace(cfg, remat=True),
                            constant_schedule(1e-3)).grads_of
    (la, _, ga), (lb, _, gb) = plain(state.params, batch), remat(state.params, batch)
    assert torch.equal(la, lb)
    assert all(torch.equal(a, b) for a, b in zip(leaves(ga), leaves(gb)))


def test_stacked_gradients_come_out_stacked():
    _, cfg = _reduced()
    state = train_state_init(cfg, torch.Generator().manual_seed(3), "cpu")
    batch = {k: _t(v) for k, v in _batch(cfg.vocab, 2, 16, seed=3).items()}
    _, _, grads = make_train_step(cfg, constant_schedule(1e-3)).grads_of(
        state.params, batch)
    for a, b in zip(leaves(grads), leaves(state.params)):
        assert a.shape == b.shape
    for name in ("wq", "wk", "wv", "wo"):
        g = grads["blocks"]["attn"][name]
        assert all(g[j].abs().sum() > 0 for j in range(cfg.n_layers)), name


def test_train_step_refuses_what_is_not_ported():
    """Kept under its first name: nothing is left to refuse.  Every config
    gives a train step, xLSTM (``tests/test_torch_xlstm_train.py``), MoE
    (``tests/test_torch_moe_train.py``), sliding windows and M-RoPE
    (``tests/test_torch_hybrid_train.py``,
    ``tests/test_torch_audio_vlm_train.py``) among them."""
    from repro_torch.configs import ARCH_IDS
    for arch in ARCH_IDS:
        assert callable(make_train_step(get_config(arch),
                                        constant_schedule(1e-3))), arch
    _, cfg = _reduced()
    for ok in (dict(window=64), dict(mrope=True)):
        assert callable(make_train_step(dataclasses.replace(cfg, **ok),
                                        constant_schedule(1e-3)))


def test_loss_decreases_on_synthetic_data():
    """The port's twin of ``tests/test_train.py``'s."""
    cfg = get_config("minicpm-2b").reduced(n_layers=2, d_model=128, vocab=256)
    data = make_batch_iterator(cfg.vocab, seq_len=64, global_batch=8, seed=0)
    state = train_state_init(cfg, torch.Generator().manual_seed(0), "cpu")
    hist = Trainer(cfg, state, cosine_schedule(3e-3, 10, 200), data).run(
        60, log=None)
    first = np.mean([h["loss"] for h in hist[:5]])
    last = np.mean([h["loss"] for h in hist[-5:]])
    assert last < first - 0.2, (first, last)


# ----------------------------------------------------------------- launcher

def test_launch_train_runs_on_the_cpu_when_asked():
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "minicpm-2b", "--reduced", "--device", "cpu", "--steps", "3",
         "--seq", "64", "--batch", "4"],
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "arch=minicpm-2b" in res.stdout and "device=cpu" in res.stdout
    hist = launch_train.main(["--arch", "minicpm-2b", "--reduced", "--device",
                              "cpu", "--steps", "2", "--seq", "32", "--batch",
                              "4", "--microbatches", "2", "--schedule", "wsd"])
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)


def test_launch_train_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--arch", "minicpm-2b", "--reduced", "--steps", "1"])


# ------------------------------------------- ops without a backward refuse

def test_ops_without_a_backward_raise_under_grad():
    """``router_gating`` differentiates through ``RouterGating``
    (``tests/test_torch_moe_train.py``) and the mLSTM scan through
    ``MLSTMScan`` (``tests/test_torch_xlstm_train.py``); the logits-in
    ``moe_gating`` and paged decode still refuse."""
    rng = np.random.default_rng(0)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    x, router = f(5, 16).requires_grad_(True), f(16, 8)
    q = f(2, 4, 16).requires_grad_(True)
    pool = f(3, 4, 2, 16)
    paged = (q, pool, pool, torch.zeros((2, 2), dtype=torch.int32),
             torch.tensor([3, 5], dtype=torch.int32), f(2, 2, 16), f(2, 2, 16))
    calls = {"paged_decode_attention": lambda: ops.paged_decode_attention(*paged),
             "moe_gating": lambda: ops.moe_gating(x @ router, 2)}
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=f"{name} has no backward"):
            call()
        with torch.no_grad():
            call()
