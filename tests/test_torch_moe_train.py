"""The port's MoE training path against the JAX package's, on the CPU.

Inputs come from numpy seeds; JAX weights and optimizer states cross over
through ``params_from_numpy`` / ``train_state_from_numpy``.  The configs
are a reduced qwen2-moe-a2.7b with 8 experts, top-2 and capacity factor
1.0, so that tokens really drop (each test that trains asserts it).
Tolerances, fixed before this file's first run:

* the gating's VJP (``router_gating_bwd_plain``) against ``jax.vjp`` of
  ``xt @ router`` then ``topk_gating``, with random cotangents: 1e-5
  absolute on dx and drouter; in float64 against ``torch.autograd`` of a
  naive float64 formula: 1e-12;
* ``RouterGating`` under grad: its forward equal to the no-grad forward
  to the bit; ``torch.autograd.gradcheck`` in float64 (its defaults);
* ``run_moe`` with drops under grad against ``jax.grad`` of a random
  projection of (y, aux): x, the router and the expert weights, each
  within 1e-5 of its leaf's largest |JAX| entry (first stated as 1e-5
  absolute: the gradients reach 58 on x and 417 on the router, where both
  packages' fp32 lie 1e-5 and 1.5e-4 from the float64 gradient, so an
  absolute 1e-5 is below fp32's own rounding at that scale);
* ``loss_fn`` and its gradient from one state: loss, ce and aux 1e-5
  relative, each gradient leaf within 1e-5 of its largest |JAX| entry;
* ``make_train_step`` against JAX's, three steps each on its own
  trajectory from one state (lr 3e-3, cosine, no warmup): loss, ce, aux,
  grad norm and lr 1e-5 relative at every step (``tests/
  test_torch_train.py``'s tolerance); the parameters after each step
  within 1e-2 of the lr summed so far in each leaf's root mean square
  difference.  The parameters were first held element by element at 1e-2
  of the lr, ``tests/test_torch_train.py``'s form, which holds there only
  because its schedule's lr is 0 at the step it checks: at a nonzero lr
  one step moved single elements 0.04 of the lr apart, each an element
  whose gradient was some 1e-7 of its leaf's largest (an embedding row at
  2.1e-7 against JAX's 2.8e-7, of 1.92), where AdamW's division by the
  element's own magnitude plus 1e-8 lifts fp32 rounding to a share of
  the lr; ``remat`` gives the same gradients to the bit;
* an MoE ``train_state_init`` of JAX crosses over to the bit.
"""

import dataclasses
import gc
import subprocess
import sys
import weakref
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro.configs import get_config as jax_get_config
from repro.data import make_batch_iterator as jax_batches
from repro.models import decoder as jdec
from repro.models import moe as jmoe
from repro.optim import schedules as jsched
from repro.train import step as jstep
from repro_torch.configs import get_config
from repro_torch.data import make_batch_iterator
from repro_torch.kernels import ops
from repro_torch.kernels.moe_gating import (moe_gating_plain,
                                           router_gating_bwd_plain,
                                           router_gating_plain)
from repro_torch.launch import train as launch_train
from repro_torch.models import decoder, moe
from repro_torch.models.moe import RouterGating
from repro_torch.optim import constant_schedule, cosine_schedule
from repro_torch.params import (params_from_numpy, train_state_from_numpy,
                                train_state_to_numpy)
from repro_torch.train import Trainer, make_train_step, train_state_init
from repro_torch.tree import leaves

ROOT = Path(__file__).resolve().parents[1]
VJP_TOL = 1e-5
F64_TOL = 1e-12
MOE_GRAD_TOL = 1e-5
STEP_RTOL = 1e-5
#: a leaf's root mean square parameter difference, in units of the lr
#: summed over the steps so far
PARAM_TOL_LR = 1e-2
#: the reduced qwen2-moe of this file: 8 experts, top-2, and a capacity
#: factor of 1.0 (``reduced`` sets 8.0, under which nothing drops)
MOE_KW = {"n_experts": 8, "moe_top_k": 2, "capacity_factor": 1.0}


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _np(t):
    return t.detach().numpy()


# ------------------------------------------------------------ gating VJP

def _router_case(T, D, E, seed, ties=False):
    """x ~ N(0, 1) (T, D), a router ~ N(0, (2 / sqrt(D))^2) (D, E); with
    ``ties`` the router's columns come in equal pairs (j and j + E/2) and
    x's row 0 is zero, so twin logits are equal and row 0 is uniform."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(T, D)).astype(np.float32)
    if ties:
        half = rng.normal(size=(D, E // 2)) * 2 / np.sqrt(D)
        router = np.concatenate([half, half], axis=1).astype(np.float32)
        x[0] = 0
    else:
        router = (rng.normal(size=(D, E)) * 2 / np.sqrt(D)).astype(np.float32)
    K_cot = rng.normal(size=(T, 8)).astype(np.float32)
    dprobs = rng.normal(size=(T, E)).astype(np.float32)
    return x, router, K_cot, dprobs


GATING_CASES = [(256, 64, 8, 2, False), (512, 128, 60, 4, False),
                (97, 64, 60, 4, False), (200, 64, 60, 4, True),
                (130, 64, 8, 2, True)]
GATING_IDS = ["E8K2", "E60K4", "ragged97", "ties_E60K4", "ties_E8K2"]


@pytest.mark.parametrize("T,D,E,K,ties", GATING_CASES, ids=GATING_IDS)
def test_gating_vjp_matches_jax(T, D, E, K, ties):
    x, router, cot, dprobs = _router_case(T, D, E, T + E, ties)
    dw = cot[:, :K].copy()

    def f(a, r):
        w, e, p = jmoe.topk_gating(a @ r, K)
        return (w, p), e

    (wj, pj), vjp, ej = jax.vjp(f, jnp.asarray(x), jnp.asarray(router),
                                has_aux=True)
    dx_j, dr_j = vjp((jnp.asarray(dw), jnp.asarray(dprobs)))

    w, ids, probs = router_gating_plain(_t(x), _t(router), K)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ej))
    if ties:
        assert ids[0].tolist() == list(range(K))      # the uniform row
    dx, dr = router_gating_bwd_plain(_t(x), _t(router), w, ids, probs,
                                     _t(dw), _t(dprobs))
    assert dx.dtype == dr.dtype == torch.float32
    assert dx.shape == (T, D) and dr.shape == (D, E)
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_j), atol=VJP_TOL,
                               rtol=0)
    np.testing.assert_allclose(dr.numpy(), np.asarray(dr_j), atol=VJP_TOL,
                               rtol=0)


@pytest.mark.parametrize("T,D,E,K,ties", GATING_CASES, ids=GATING_IDS)
def test_gating_vjp_float64_matches_autograd_of_the_naive_formula(
        T, D, E, K, ties):
    x, router, cot, dprobs = _router_case(T, D, E, T + D, ties)
    x64, r64 = (_t(a).double() for a in (x, router))
    dw64, dp64 = _t(cot[:, :K]).double(), _t(dprobs).double()
    with torch.no_grad():
        w, ids, probs = router_gating_plain(x64, r64, K)
        assert w.dtype == probs.dtype == torch.float64
        dx, dr = router_gating_bwd_plain(x64, r64, w, ids, probs, dw64, dp64)
    assert dx.dtype == dr.dtype == torch.float64

    xa, ra = x64.clone().requires_grad_(True), r64.clone().requires_grad_(True)
    p = torch.softmax(xa @ ra, dim=-1)
    sel = p.gather(1, ids.long())
    wa = sel / torch.clamp_min(sel.sum(dim=1, keepdim=True), 1e-9)
    torch.autograd.backward((wa, p), (dw64, dp64))
    np.testing.assert_allclose(dx.numpy(), xa.grad.numpy(), atol=F64_TOL,
                               rtol=0)
    np.testing.assert_allclose(dr.numpy(), ra.grad.numpy(), atol=F64_TOL,
                               rtol=0)


def test_float64_gating_stays_float64_and_float32_is_unchanged():
    """The plain forward computes in the promotion of its inputs with
    fp32: float64 in, float64 out; fp32 gives the fp64 sum rounded once."""
    x, router, *_ = _router_case(64, 32, 8, 5)
    w32, i32, p32 = router_gating_plain(_t(x), _t(router), 2)
    w64, i64, p64 = router_gating_plain(_t(x).double(), _t(router).double(), 2)
    assert w32.dtype == p32.dtype == torch.float32
    assert w64.dtype == p64.dtype == torch.float64
    assert torch.equal(i32, i64)
    old = moe_gating_plain((_t(x).double() @ _t(router).double()).float(), 2)
    assert all(torch.equal(a, b) for a, b in zip((w32, i32, p32), old))
    np.testing.assert_allclose(p64.numpy(), p32.double().numpy(), atol=1e-6)


# ------------------------------------------------------- RouterGating

def test_router_gating_function_forward_is_the_no_grad_forward():
    x, router, cot, dprobs = _router_case(300, 64, 60, 4, 3)
    xs, rs = _t(x).requires_grad_(True), _t(router).requires_grad_(True)
    before = ops.launch_counts()
    got = ops.router_gating(xs, rs, 4)
    assert got[0].grad_fn is not None and not got[1].requires_grad
    with torch.no_grad():
        want = ops.router_gating(xs, rs, 4)
    assert all(a.grad_fn is None for a in want)
    assert all(torch.equal(a.detach(), b) for a, b in zip(got, want))
    torch.autograd.backward((got[0], got[2]), (_t(cot[:, :4]), _t(dprobs)))
    dx, dr = router_gating_bwd_plain(xs.detach(), rs.detach(), *want,
                                     _t(cot[:, :4]), _t(dprobs))
    assert torch.equal(xs.grad, dx) and torch.equal(rs.grad, dr)
    assert ops.launch_counts() == before                # the CPU: plain only


def test_router_gating_function_passes_gradcheck():
    """Float64, at a size whose top-k gaps are far above gradcheck's
    step, so no perturbation changes the selection."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.normal(size=(6, 5))).requires_grad_(True)
    router = torch.from_numpy(rng.normal(size=(5, 7))).requires_grad_(True)
    with torch.no_grad():
        _, _, probs = router_gating_plain(x, router, 3)
    top = probs.topk(4, dim=1).values
    assert float((top[:, :-1] - top[:, 1:]).min()) > 1e-3

    def fn(a, r):
        w, _, p = RouterGating.apply(a, r, 3)
        return w, p

    assert torch.autograd.gradcheck(fn, (x, router))


# ------------------------------------------------------ run_moe under grad

def _moe_cfgs(groups):
    kw = dict(n_layers=1, d_model=64, vocab=64, d_expert=32, moe_groups=groups,
              **MOE_KW)
    return (jax_get_config("qwen2-moe-a2.7b").reduced(**kw),
            get_config("qwen2-moe-a2.7b").reduced(**kw))


def _drops(experts, cfg, groups):
    """(token, k) pairs past their expert's capacity, over the groups."""
    ids = np.asarray(experts).reshape(groups, -1)
    C = moe.capacity(cfg, ids.size // groups // cfg.moe_top_k, False)
    load = np.stack([np.bincount(g, minlength=cfg.n_experts) for g in ids])
    return int(np.maximum(load - C, 0).sum())


@pytest.mark.parametrize("groups", [1, 4])
def test_run_moe_gradients_match_jax(groups):
    jcfg, cfg = _moe_cfgs(groups)
    jp = jmoe.init_moe(jcfg, jax.random.PRNGKey(groups + 5), jnp.float32)
    rng = np.random.default_rng(groups + 5)
    x = rng.normal(size=(2, 32, jcfg.d_model)).astype(np.float32)
    ry = rng.normal(size=x.shape).astype(np.float32)
    ra = float(100 * rng.normal())

    def f(p, a):
        y, aux = jmoe.run_moe(p, jcfg, a, no_drop=False)
        return jnp.sum(y * ry) + ra * aux

    gp_j, gx_j = jax.grad(f, argnums=(0, 1))(jp, jnp.asarray(x))

    p = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    for leaf in leaves(p):
        leaf.requires_grad_(True)
    xs = _t(x).requires_grad_(True)
    y, probs, experts = moe.run_moe(p, cfg, xs, no_drop=False)
    assert _drops(experts.numpy(), cfg, groups) > 0
    loss = (y * _t(ry)).sum() + ra * moe.switch_aux(cfg, probs, experts)
    loss.backward()
    pairs = [("x", xs.grad, gx_j)]
    pairs += [(k, p[k].grad, gp_j[k]) for k in ("router", "w_gate", "w_up",
                                               "w_down")]
    pairs += [(f"shared.{k}", p["shared"][k].grad, gp_j["shared"][k])
              for k in ("w_gate", "w_up", "w_down")]
    for name, got, want in pairs:
        want = np.asarray(want)
        assert got.abs().sum() > 0, name
        np.testing.assert_allclose(_np(got), want, rtol=0, err_msg=name,
                                   atol=MOE_GRAD_TOL * np.abs(want).max())


# ------------------------------------------------------------- train step

def _reduced(**kw):
    kw = {"n_layers": 2, "d_model": 256, "vocab": 256, **MOE_KW, **kw}
    jcfg = jax_get_config("qwen2-moe-a2.7b").reduced(**kw)
    cfg = get_config("qwen2-moe-a2.7b").reduced(**kw)
    assert jcfg.__dict__ == cfg.__dict__ and cfg.hd == 64
    return jcfg, cfg


@pytest.fixture(scope="module")
def jax_state():
    jcfg, cfg = _reduced()
    state = jstep.train_state_init(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, state, jax.tree.map(np.asarray, state)


def _batch(vocab, B, S, seed):
    return next(jax_batches(vocab, S, B, seed=seed))


class _Recorded:
    """Every ``ops.router_gating`` call's expert ids, in call order."""

    def __init__(self, monkeypatch):
        self.ids = []
        real = ops.router_gating

        def record(x, router, k):
            out = real(x, router, k)
            self.ids.append(out[1].numpy().copy())
            return out

        monkeypatch.setattr(ops, "router_gating", record)


def test_loss_fn_and_its_gradient_match_jax(jax_state, monkeypatch):
    jcfg, cfg, state, np_state = jax_state
    batch = _batch(cfg.vocab, 2, 64, seed=4)
    batch["labels"][0, :7] = -1
    (want, wm), want_g = jax.value_and_grad(jdec.loss_fn, has_aux=True)(
        state.params, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    rec = _Recorded(monkeypatch)
    params = train_state_from_numpy(np_state, "cpu").params
    got, m, grads = make_train_step(cfg, constant_schedule(1e-3)).grads_of(
        params, {k: _t(v) for k, v in batch.items()})
    assert len(rec.ids) == cfg.n_layers
    assert sum(_drops(i, cfg, 1) for i in rec.ids) > 0
    for key, a, b in (("loss", got, want), ("ce", m["ce"], wm["ce"]),
                      ("aux", m["aux"], wm["aux"])):
        np.testing.assert_allclose(float(a), float(b), rtol=STEP_RTOL,
                                   err_msg=key)
    assert float(m["aux"]) > 0
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(want_g)[0]]
    for name, a, b in zip(paths, leaves(grads), jax.tree.leaves(want_g)):
        b = np.asarray(b)
        np.testing.assert_allclose(_np(a), b, rtol=0, err_msg=name,
                                   atol=MOE_GRAD_TOL * np.abs(b).max())


STEP_CASES = [(64, 1), (64, 2), (2048, 1), (2048, 2)]


@pytest.mark.parametrize("S,mb", STEP_CASES,
                         ids=[f"S{s}-mb{m}" for s, m in STEP_CASES])
def test_train_step_matches_jax(jax_state, monkeypatch, S, mb):
    """Three steps from one state; S=2048 takes the flash path in both
    packages (the JAX custom VJP, the port's FlashAttention)."""
    jcfg, cfg, state, np_state = jax_state
    sched = (jsched.cosine_schedule(3e-3, 0, 3), cosine_schedule(3e-3, 0, 3))
    jfn = jax.jit(jstep.make_train_step(jcfg, sched[0], microbatches=mb))
    fn = make_train_step(cfg, sched[1], microbatches=mb)
    rec = _Recorded(monkeypatch)
    mine, theirs = train_state_from_numpy(np_state, "cpu"), state
    lr_sum = 0.0
    for i in range(3):
        batch = _batch(cfg.vocab, 2, S, seed=20 + i)
        theirs, wm = jfn(theirs, {k: jnp.asarray(v) for k, v in batch.items()})
        mine, m = fn(mine, batch)
        for key in ("loss", "ce", "aux", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[key]), float(wm[key]),
                                       rtol=STEP_RTOL, err_msg=f"{key} step {i}")
        lr_sum += float(wm["lr"])
        for a, b in zip(leaves(mine.params), jax.tree.leaves(theirs.params)):
            rms = float(np.sqrt(np.mean((_np(a) - np.asarray(b)) ** 2)))
            assert rms <= PARAM_TOL_LR * lr_sum, (i, a.shape, rms, lr_sum)
    assert mine.opt.step == int(theirs.opt.step) == 3
    assert len(rec.ids) == 3 * mb * cfg.n_layers
    assert sum(_drops(i, cfg, 1) for i in rec.ids) > 0


def test_remat_gives_the_same_moe_gradients():
    _, cfg = _reduced()
    state = train_state_init(cfg, torch.Generator().manual_seed(2), "cpu")
    batch = {k: _t(v) for k, v in _batch(cfg.vocab, 2, 48, seed=2).items()}
    plain = make_train_step(cfg, constant_schedule(1e-3)).grads_of
    remat = make_train_step(dataclasses.replace(cfg, remat=True),
                            constant_schedule(1e-3)).grads_of
    (la, ma, ga), (lb, mb, gb) = (plain(state.params, batch),
                                  remat(state.params, batch))
    assert torch.equal(la, lb) and torch.equal(ma["aux"], mb["aux"])
    assert all(torch.equal(a, b) for a, b in zip(leaves(ga), leaves(gb)))
    g = ga["blocks"]["moe"]
    for name in ("router", "w_gate", "w_up", "w_down"):
        assert all(g[name][j].abs().sum() > 0 for j in range(cfg.n_layers))


# ------------------------------------------------ weights, trainer, launcher

def test_moe_train_state_crosses_over_bit_exactly(jax_state):
    *_, np_state = jax_state
    state = train_state_from_numpy(np_state, "cpu")
    assert all(p.requires_grad for p in leaves(state.params))
    assert state.params["blocks"]["moe"]["router"].shape == (2, 256, 8)
    back = train_state_to_numpy(state)
    assert back.opt.step == np_state.opt.step
    for tree in ("params", "mu", "nu"):
        a = back.params if tree == "params" else getattr(back.opt, tree)
        b = np_state.params if tree == "params" else getattr(np_state.opt, tree)
        fa, fb = (jax.tree_util.tree_flatten_with_path(t)[0] for t in (a, b))
        assert [p for p, _ in fa] == [p for p, _ in fb]
        for (_, x), (_, y) in zip(fa, fb):
            assert x.dtype == y.dtype
            assert np.array_equal(x.view(np.uint8), y.view(np.uint8))


def test_a_gradient_tree_dies_with_its_last_reference():
    """No reference cycle keeps a step's gradients alive until the cyclic
    collector runs: at full width each tree is 11.6 GB, and the card ran
    out with three of them waiting for a collection."""
    _, cfg = _reduced()
    state = train_state_init(cfg, torch.Generator().manual_seed(4), "cpu")
    batch = {k: _t(v) for k, v in _batch(cfg.vocab, 1, 32, seed=4).items()}
    grads_of = make_train_step(cfg, constant_schedule(1e-3)).grads_of
    gc.disable()
    try:
        refs = list(map(weakref.ref, leaves(grads_of(state.params, batch)[2])))
        assert refs and all(r() is None for r in refs)
    finally:
        gc.enable()


def test_moe_loss_decreases_on_synthetic_data():
    """The MoE twin of ``tests/test_train.py``'s synthetic-data test."""
    cfg = get_config("qwen2-moe-a2.7b").reduced(n_layers=2, d_model=128,
                                                vocab=256, **MOE_KW)
    data = make_batch_iterator(cfg.vocab, seq_len=64, global_batch=8, seed=0)
    state = train_state_init(cfg, torch.Generator().manual_seed(0), "cpu")
    hist = Trainer(cfg, state, cosine_schedule(3e-3, 10, 200), data).run(
        60, log=None)
    first = np.mean([h["loss"] for h in hist[:5]])
    last = np.mean([h["loss"] for h in hist[-5:]])
    assert last < first - 0.2, (first, last)
    assert all(np.isfinite(h["aux"]) and h["aux"] > 0 for h in hist)


def test_launch_train_runs_moe_on_the_cpu():
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen2-moe-a2.7b", "--reduced", "--device", "cpu", "--steps", "2",
         "--seq", "32", "--batch", "4"],
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "family=moe" in res.stdout and "device=cpu" in res.stdout
    hist = launch_train.main(["--arch", "qwen2-moe-a2.7b", "--reduced",
                              "--device", "cpu", "--steps", "2", "--seq", "32",
                              "--batch", "4", "--microbatches", "2"])
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    assert all(h["aux"] > 0 for h in hist)


# ------------------------------------------- the smoke's phases, rehearsed

@pytest.mark.parametrize("groups,ids,want", [
    (1, [[0]] * 8, 6),
    (1, [[0], [1], [2], [3], [0], [1], [2], [3]], 0),
    (1, [[0], [0], [0], [1], [1], [1], [2], [3]], 2),
    (1, [[0, 1]] * 8, 8),
    (2, [[0], [0], [1], [1], [2], [2], [3], [3]], 4),
], ids=["one_expert", "balanced", "two_over", "top2", "two_groups"])
def test_dropped_by_call_counts_slots_past_capacity(groups, ids, want):
    """``chip_smoke.dropped_by_call`` against counts made by hand: 8
    tokens, 4 experts, capacity factor 1.0, so each expert keeps
    int(K * Tg / 4) slots of its group (2 at top-1 in one group, 4 at
    top-2, 1 in each of two groups of 4 tokens)."""
    cfg = get_config("qwen2-moe-a2.7b").reduced(
        n_experts=4, moe_top_k=len(ids[0]), capacity_factor=1.0,
        moe_groups=groups)
    got = chip_smoke.dropped_by_call(cfg, [torch.tensor(ids,
                                                        dtype=torch.int32)])
    assert got == [want]


def test_replaying_gating_takes_the_recorded_ids():
    """Under ``chip_smoke.replaying_gating``, ``ops.router_gating`` under
    grad (``RouterGating``'s plain forward) returns the recorded ids, the
    plain probabilities, and the gathered probabilities over their sum in
    the recorded order; rows whose expert set the plain top-k would choose
    otherwise are reported with every row's top-k gap; a call past the
    records fails; the plain forward is put back afterwards."""
    from repro_torch.kernels import moe_gating as mg

    real = mg.router_gating_plain
    g = torch.Generator().manual_seed(3)
    x = torch.randn(16, 32, generator=g)
    router = torch.randn(32, 8, generator=g) * 0.3
    _, own, probs = real(x, router, 2)
    rec = own.clone()
    rec[:4] = (own[:4] + 1) % 8           # another expert set
    rec[4] = own[4].flip(0)               # the same set, the other order
    seen = []
    with chip_smoke.replaying_gating([rec], seen):
        w, ids, p = ops.router_gating(x.clone().requires_grad_(), router, 2)
        with pytest.raises(chip_smoke.SmokeFailure):
            ops.router_gating(x, router, 2)
    assert mg.router_gating_plain is real
    assert torch.equal(ids, rec) and torch.equal(p.detach(), probs)
    sel = probs.gather(1, rec.long())
    assert torch.equal(w.detach(), sel / (sel[:, :1] + sel[:, 1:]))
    differ, gap = seen[0]
    assert differ.tolist() == [0, 1, 2, 3]
    assert torch.equal(gap, chip_smoke.topk_gap(probs, 2))


def test_moe_train_parity_phase_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.moe_train_parity_phase`` (gate T2m) end to end on the
    CPU at its reduced config and S=64: the "card" run is a CPU fp32 run
    whose expert ids the cpu32 and cpu64 runs replay, every record's row
    count checked; tokens drop; no kernel launches."""
    lines = []
    monkeypatch.setattr(chip_smoke, "emit", lines.append)
    out = chip_smoke.moe_train_parity_phase(torch, device="cpu")
    (line,) = lines
    assert line["phase"] == "moe_train_parity" and line["seq"] == 64
    cfg = get_config("qwen2-moe-a2.7b").reduced(**chip_smoke.T2M_REDUCED)
    for mb in (1, 2):
        r = out[f"mb{mb}"]
        calls = cfg.n_layers * mb * (1 + chip_smoke.T2_STEPS)
        assert r["slots_by_call"] == [2 * 64 * cfg.moe_top_k // mb] * calls
        assert r["grad_leaf_ratio_to_bound_max"] <= 1.0
        assert max(max(s) for s in r["step_ratio_to_bound"]) <= 1.0
        assert r["rows"] == calls * 2 * 64 // mb
        assert r["rows_routed_otherwise"] <= \
            chip_smoke.T2M_TIE_SHARE * r["rows"]
        assert sum(map(sum, r["dropped_by_pass_and_layer"])) > 0
        assert not any(r["launches_cuda"].values())


def test_moe_training_phase_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.moe_training_phase`` (gate T3m) end to end on the CPU
    at a narrow qwen2-moe with 60 experts, top-2 and S=64, so that some
    experts keep no token and the per-expert gradient check meets both
    of its halves: nonzero where an expert kept a token, zero where it
    kept none."""
    lines = []
    monkeypatch.setattr(chip_smoke, "emit", lines.append)
    cfg = get_config("qwen2-moe-a2.7b").reduced(
        n_layers=2, d_model=64, vocab=256, n_experts=60, moe_top_k=2,
        capacity_factor=1.25)
    chip_smoke.moe_training_phase(torch, device="cpu", cfg=cfg)
    (line,) = lines
    assert line["phase"] == "moe_training" and line["seq"] == 64
    assert not any(line["launches"].values())
    assert all(0 < n < cfg.n_experts for n in line["experts_kept_by_layer"])
    for name in ("blocks.moe.w_gate", "blocks.moe.w_up", "blocks.moe.w_down"):
        assert line["expert_grads"][name]["nonzero"] == \
            sum(line["experts_kept_by_layer"])
    assert max(map(max, line["dropped_share_by_step_and_layer"])) > 0
    assert len(line["timed_steps"]) == 2
