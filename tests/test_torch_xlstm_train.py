"""The port's xLSTM training path against the JAX package's, on the CPU.

Inputs come from numpy seeds; weights and optimizer states cross between
the packages as numpy arrays (``params_from_numpy`` /
``train_state_from_numpy``), from the port's seeded init.  The config is
a reduced xlstm-1.3b with eight layers (layer 7 is the sLSTM layer), d=64,
H=4 (mLSTM hd 32, sLSTM hd 16), vocab 512.  JAX trains it through
``jax.value_and_grad``, whose chunkwise mLSTM is
``lax.scan(jax.checkpoint(chunk))``; it never reaches its Pallas mLSTM
kernel.  JAX runs float64 under ``jax.enable_x64`` with its modules'
float32 casts reading float64 (``_jax_in``: a test-side stand-in for the
``jnp`` of the reference modules a train step runs through).

The JAX package is the reference in float64.  At this config both
packages' fp32 gradients of the 8-layer stack lie up to ~7e-4 of a
leaf's largest entry from float64 (its grad norm at init is ~100-150),
and which package's fp32 lies closer changes from batch to batch (the
port's over JAX's error per leaf: median 0.66 and max 1.29 on this
file's loss batch, median 1.32 and max 3.6 on its step batch), so the
whole model is held against JAX in float64, and in fp32 one layer at a
time, where both lie within 1e-5.  A single layer's fp32 gradients are
held in T2's form (the smoke's) against JAX in float64 with JAX's own
fp32 error as the yardstick: per leaf, max|port32 - jax64| <= max(tol,
2 max|jax32 - jax64|), both over the leaf's largest |jax64| entry.
Tolerances:

* ``run_mlstm`` and ``run_slstm`` against ``jax.vjp`` of JAX's with random
  cotangents (of y, and of the end state where a start state is given):
  y, dx, each weight's gradient and the start state's, in fp32 T2's form
  with tol ``VJP_TOL`` = 1e-5, in float64 within ``VJP_TOL64`` = 1e-10
  of the largest |jax64| entry among the call's gradients (the one unit
  of rounding of a backward: the stateless sLSTM's ``b_i`` gradient is
  zero but for n0 = 1e-6, since its output does not move when log i
  shifts by a constant over time, so that leaf is rounding residue).  The
  mLSTM at S=512 (two chunks of 256), S=300 (one chunk of S) and S=128
  (the quadratic form without a state, one chunk with one), each with and
  without a start state; the sLSTM at S=64;
* ``MLSTMScan`` against autograd straight through ``mlstm_scan_plain``:
  the forward under grad equal to the no-grad forward to the bit; each
  of the eight gradients within 1e-5 of its largest entry in fp32 (1e-12
  in float64), and all zero where the plain one is;
* saved bytes: ``MLSTMScan`` keeps its eight inputs and nothing else;
  autograd through ``mlstm_scan_plain`` (the control) keeps more than 3x
  those bytes at B=1, H=4, S=1024, hd=64;
* ``loss_fn`` and its gradient from one state at S=512: the loss within
  1e-5 relative of jax32's in fp32 and 1e-10 of jax64's in float64, each
  float64 gradient leaf within ``VJP_TOL64`` of the largest |jax64| entry
  among the gradients; in both packages and both types the branch a
  layer does not run has an all-zero gradient, and every other leaf a
  nonzero one.  The fp32 leaves' errors over JAX's print with ``-s``;
* ``make_train_step`` against JAX's jitted one, three steps (lr 3e-3,
  cosine, no warmup) at S=512, micro-batches 1 (B=1) and 2 (B=2), along
  JAX's float64 trajectory, the port stepping from JAX's state before
  each step: in float64 the loss and grad norm within 1e-10 relative and
  each leaf within 1e-2 of the step's lr of JAX's (AdamW's first step
  moves an element by about lr whatever its gradient's size, so a leaf
  is held in units of the lr); in fp32 the loss within 1e-5 relative;
  in both the lr within 1e-5 relative (the port's schedule is float32,
  as JAX's fp32 one) and the leaves of the branch a layer does not run
  at ``p - lr·wd·p``, weight decay alone (1e-6 relative in fp32, 1e-12
  in float64).
"""

import contextlib
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro.configs import get_config as jax_get_config
from repro.data import make_batch_iterator as jax_batches
from repro.models import common as jcommon
from repro.models import decoder as jdec
from repro.models import ssm as jssm
from repro.optim import adamw as jadamw
from repro.optim import clip as jclip
from repro.optim import schedules as jsched
from repro.train import step as jstep
from repro_torch.configs import get_config
from repro_torch.kernels import mlstm_scan as ms
from repro_torch.kernels import ops
from repro_torch.launch import train as launch_train
from repro_torch.models import ssm
from repro_torch.models.decoder import _is_slstm
from repro_torch.optim import constant_schedule, cosine_schedule
from repro_torch.params import train_state_from_numpy, train_state_to_numpy
from repro_torch.train import make_train_step, train_state_init
from repro_torch.tree import leaves

VJP_TOL = 1e-5
VJP_TOL64 = 1e-10
STEP_RTOL = 1e-5
PARAM_TOL_LR = 1e-2
SCAN_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
#: the control's saved bytes over ``MLSTMScan``'s must exceed this
SAVED_RATIO = 3
XL_KW = {"n_layers": 8, "d_model": 64}
WEIGHT_DECAY = 0.1
#: the reference modules whose float32 casts ``_jax_in`` reads as float64
JAX_MODULES = (jssm, jcommon, jdec, jstep, jadamw, jclip, jsched)


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


def _reduced():
    jcfg = jax_get_config("xlstm-1.3b").reduced(**XL_KW)
    cfg = get_config("xlstm-1.3b").reduced(**XL_KW)
    assert jcfg.__dict__ == cfg.__dict__
    assert [_is_slstm(cfg, i) for i in range(8)] == [False] * 7 + [True]
    return jcfg, cfg


def _cast(tree, dtype):
    """Nested dicts, lists, tuples and dataclasses of arrays, the float
    ones cast."""
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _cast(getattr(tree, f.name), dtype)
            for f in dataclasses.fields(tree)})
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_cast(v, dtype) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cast(v, dtype) for v in tree)
    if tree is None:
        return None
    a = np.asarray(tree)
    return a.astype(dtype) if np.issubdtype(a.dtype, np.floating) else a


@pytest.fixture(scope="module")
def jax_state():
    """The port's seeded init as numpy, and as JAX's ``TrainState``."""
    jcfg, cfg = _reduced()
    np_state = train_state_to_numpy(
        train_state_init(cfg, torch.Generator().manual_seed(0), "cpu"))
    return jcfg, cfg, _jax_state(np_state, np.float32), np_state


def _jax_state(np_state, dtype):
    """A (params, opt) state of numpy leaves as JAX's ``TrainState`` with
    its float leaves in ``dtype``."""
    to_j = lambda t: jax.tree.map(jnp.asarray, _cast(t, dtype))
    return jstep.TrainState(params=to_j(np_state.params),
                            opt=jadamw.AdamWState(
                                step=jnp.asarray(np_state.opt.step),
                                mu=to_j(np_state.opt.mu),
                                nu=to_j(np_state.opt.nu)))


class _Float64Numpy:
    """``jax.numpy`` with ``float32`` reading ``float64``: the reference
    modules' float32 casts keep float64 inputs float64."""
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@contextlib.contextmanager
def _jax_in(dtype):
    """The JAX side in ``dtype``: fp32 as it is, or float64 (x64 on, the
    reference modules' ``jnp`` standing in) until the block ends."""
    if dtype == np.float32:
        with jax.enable_x64(False):
            yield
        return
    saved = [(m, m.jnp) for m in JAX_MODULES]
    try:
        for m, _ in saved:
            m.jnp = _Float64Numpy()
        with jax.enable_x64(True):
            yield
    finally:
        for m, j in saved:
            m.jnp = j


def _t2_hold(name, got, want64, want32, tol):
    """T2's form: max|got - want64| <= max(tol, 2 max|want32 - want64|),
    both over max|want64|; all zero where want64 is."""
    got, want64 = np.asarray(got, np.float64), np.asarray(want64)
    scale = np.abs(want64).max()
    if scale == 0:
        assert not np.any(got) and not np.any(want32), name
        return
    err = np.abs(got - want64).max() / scale
    bound = max(tol, 2 * np.abs(np.asarray(want32, np.float64)
                                - want64).max() / scale)
    assert err <= bound, (name, err, bound)


def _branch(np_state, layer, name):
    """Layer ``layer``'s ``name`` weights (numpy)."""
    return dict(np_state.params["blocks"][layer][name])


def _start(rng, kind, shapes):
    """A start state of ``shapes``: None, or the "warm" one."""
    if kind is None:
        return None
    out = []
    for name, shape in shapes:
        a = {"C": 0.1 * rng.standard_normal(shape),
             "n": 0.1 * rng.standard_normal(shape),
             "m": np.full(shape, 0.5),
             "sc": 0.5 * rng.standard_normal(shape),
             "sn": 1.0 + np.abs(rng.standard_normal(shape)),
             "sh": 0.1 * rng.standard_normal(shape),
             "sm": 0.1 * rng.standard_normal(shape)}[name]
        out.append(a.astype(np.float32))
    return out


def _jax_vjp(jfn, jcfg, tree, x, state, cots, dtype):
    """y and [dx, each weight's gradient in sorted order, the start
    state's] of JAX's ``jfn``, in ``dtype``."""
    tree, x, state, cots = _cast((tree, x, state, cots), dtype)
    with _jax_in(dtype):
        def f(a, b, st):
            y, new = jfn(a, jcfg, b, st)
            return y if st is None else (y, new)

        @jax.jit
        def vjp(a, b, st, cot):
            y, back = jax.vjp(f, a, b, st)
            return y, back(cot)

        to_j = lambda t: jax.tree.map(jnp.asarray, t)
        cot = cots[0] if state is None else (cots[0], tuple(cots[1:]))
        y, (dp, dx, dst) = vjp(to_j(tree), jnp.asarray(x),
                               None if state is None else to_j(tuple(state)),
                               to_j(cot))
        y = y if state is None else y[0]
        grads = [dx] + [dp[k] for k in sorted(tree)] + list(dst or [])
        out = np.asarray(y), [np.asarray(g) for g in grads]
    assert out[0].dtype == dtype
    return out


def _port_vjp(fn, cfg, tree, x, state, cots, dtype):
    """The same from the port's ``fn``."""
    tree, x, state, cots = _cast((tree, x, state, cots), dtype)
    p = {k: _t(v).requires_grad_(True) for k, v in tree.items()}
    xt = _t(x).requires_grad_(True)
    st = None if state is None else [_t(s).requires_grad_(True)
                                     for s in state]
    y, new = fn(p, cfg, xt, st)
    outs = [y] + (list(new) if st is not None else [])
    ins = [xt] + [p[k] for k in sorted(p)] + (st or [])
    grads = torch.autograd.grad(outs, ins, [_t(c) for c in cots])
    assert y.dtype == xt.dtype and all(g.dtype == xt.dtype for g in grads)
    return _np(y), [_np(g) for g in grads]


def _hold_vjp(jcfg, cfg, jfn, fn, tree, S, state, seed):
    """y and every gradient (x, each weight, the start state) of ``fn``
    against ``jax.vjp`` of ``jfn`` on one input and random cotangents: in
    fp32 in T2's form, in float64 within ``VJP_TOL64`` of the call's
    largest gradient entry."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    cots = [rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)]
    cots += [rng.standard_normal(s.shape).astype(np.float32)
             for s in state or []]
    args = (tree, x, state, cots)
    y32, g32 = _jax_vjp(jfn, jcfg, *args, np.float32)
    y64, g64 = _jax_vjp(jfn, jcfg, *args, np.float64)
    py32, pg32 = _port_vjp(fn, cfg, *args, np.float32)
    py64, pg64 = _port_vjp(fn, cfg, *args, np.float64)
    labels = ["x"] + sorted(tree) + [f"state{i}" for i in
                                     range(len(state or []))]
    _t2_hold("y", py32, y64, y32, VJP_TOL)
    np.testing.assert_allclose(py64, y64, rtol=0,
                               atol=VJP_TOL64 * np.abs(y64).max())
    unit = max(np.abs(g).max() for g in g64)
    for name, a, b, c, d in zip(labels, pg32, g32, g64, pg64):
        assert np.abs(c).max() > 0, name
        _t2_hold(name, a, c, b, VJP_TOL)
        np.testing.assert_allclose(d, c, rtol=0, atol=VJP_TOL64 * unit,
                                   err_msg=name)


# ----------------------------------------------- run_mlstm and run_slstm

#: (S, start state): two chunks of 256, one chunk of 300, and S=128 (the
#: quadratic form without a state; one chunk of 128 with one)
MLSTM_CASES = [(512, None), (512, "warm"), (300, None), (300, "warm"),
               (128, None), (128, "warm")]


@pytest.mark.parametrize("S,start", MLSTM_CASES,
                         ids=[f"S{s}-{k or 'no_state'}"
                              for s, k in MLSTM_CASES])
def test_run_mlstm_gradients_match_jax(jax_state, S, start):
    jcfg, cfg, _, np_state = jax_state
    H, hd = cfg.n_heads, 2 * cfg.d_model // cfg.n_heads
    state = _start(np.random.default_rng(S), start,
                   [("C", (2, H, hd, hd)), ("n", (2, H, hd)), ("m", (2, H))])
    _hold_vjp(jcfg, cfg, jssm.run_mlstm, ssm.run_mlstm,
              _branch(np_state, 2, "mlstm"), S, state, seed=S + 1)


@pytest.mark.parametrize("start", [None, "warm"], ids=["no_state", "warm"])
def test_run_slstm_gradients_match_jax(jax_state, start):
    jcfg, cfg, _, np_state = jax_state
    shape = (2, cfg.n_heads, cfg.d_model // cfg.n_heads)
    state = _start(np.random.default_rng(7), start,
                   [(k, shape) for k in ("sc", "sn", "sh", "sm")])
    _hold_vjp(jcfg, cfg, jssm.run_slstm, ssm.run_slstm,
              _branch(np_state, 7, "slstm"), 64, state, seed=8)


# ------------------------------------------------------------- MLSTMScan

def _scan_inputs(B, H, S, hd, start, dtype, seed):
    """``chip_smoke.mlstm_inputs``'s distributions, from a numpy seed."""
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s)).to(dtype)
    q, k, v = f(B, H, S, hd), f(B, H, S, hd) / hd ** 0.5, f(B, H, S, hd)
    li = f(B, H, S)
    lf = torch.nn.functional.logsigmoid(f(B, H, S) + 2.0)
    warm = start == "warm"
    C0 = 0.1 * f(B, H, hd, hd) if warm else torch.zeros((B, H, hd, hd),
                                                        dtype=dtype)
    n0 = 0.1 * f(B, H, hd) if warm else torch.zeros((B, H, hd), dtype=dtype)
    m0 = torch.full((B, H), {"empty": -1e30, "cache": 0.0, "warm": 0.5}[start],
                    dtype=dtype)
    return [q, k, v, li, lf, C0, n0, m0]


SCAN_CASES = [(1, 2, 512, 16, "empty"), (2, 2, 300, 16, "warm"),
              (1, 2, 512, 8, "cache")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["fp32", "fp64"])
@pytest.mark.parametrize("B,H,S,hd,start", SCAN_CASES,
                         ids=[f"S{c[2]}-{c[4]}" for c in SCAN_CASES])
def test_mlstm_scan_function_matches_autograd_through_the_plain_scan(
        B, H, S, hd, start, dtype):
    args = _scan_inputs(B, H, S, hd, start, dtype, seed=S)
    rng = np.random.default_rng(S + 1)
    xs = [a.clone().requires_grad_(True) for a in args]
    outs = ssm.MLSTMScan.apply(*xs)
    with torch.no_grad():
        plain = ms.mlstm_scan_plain(*args)
    assert all(torch.equal(a.detach(), b) for a, b in zip(outs, plain))
    cots = [torch.from_numpy(rng.standard_normal(o.shape)).to(dtype)
            for o in outs]
    got = torch.autograd.grad(outs, xs, cots)
    ys = [a.clone().requires_grad_(True) for a in args]
    want = torch.autograd.grad(ms.mlstm_scan_plain(*ys), ys, cots)
    zero = []
    for name, a, b in zip(chip_smoke.MLSTM_BWD_PARTS, got, want):
        assert a.dtype == b.dtype == dtype and a.shape == b.shape, name
        scale = b.abs().max().item()
        if scale == 0:
            zero.append(name)
            assert not a.ne(0).any(), name
            continue
        np.testing.assert_allclose(_np(a), _np(b), rtol=0, err_msg=name,
                                   atol=SCAN_TOL[dtype] * scale)
    # from m = -1e30 the start state's weight is exactly 0
    assert zero == (["dC0", "dn0", "dm0"] if start == "empty" else [])


def _saved(fn, args):
    """{storage: bytes} of every tensor autograd keeps for the backward of
    ``fn(*args)``."""
    seen = {}

    def pack(t):
        st = t.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        outs = fn(*args)
    torch.autograd.grad(outs[0].sum(), args)
    return seen


@pytest.mark.parametrize("function", [True, False],
                         ids=["mlstm_scan_function", "control_plain"])
def test_the_function_keeps_only_its_inputs(function):
    args = [a.requires_grad_(True)
            for a in _scan_inputs(1, 4, 1024, 64, "empty", torch.float32, 5)]
    inputs = {a.untyped_storage().data_ptr(): a.untyped_storage().nbytes()
              for a in args}
    fn = ssm.MLSTMScan.apply if function else ms.mlstm_scan_plain
    seen = _saved(fn, args)
    ratio = sum(seen.values()) / sum(inputs.values())
    print(f"saved {ratio:.3f} x the inputs' bytes (function={function})")
    if function:
        assert seen == inputs
    else:
        assert ratio > SAVED_RATIO, ratio


def test_ops_route_under_grad_through_the_function():
    args = _scan_inputs(1, 2, 300, 16, "cache", torch.float32, 3)
    ops.reset_launch_counts()
    with torch.no_grad():
        plain = ops.mlstm_scan(*args)
    assert all(t.grad_fn is None for t in ops.mlstm_scan(*args))
    xs = [a.clone() for a in args]
    xs[3].requires_grad_(True)                  # one input is enough
    outs = ops.mlstm_scan(*xs)
    assert type(outs[0].grad_fn).__name__ == "MLSTMScanBackward"
    assert all(torch.equal(a.detach(), b) for a, b in zip(outs, plain))
    (dli,) = torch.autograd.grad(outs[0].sum(), xs[3])
    assert dli.shape == xs[3].shape and dli.abs().max() > 0
    assert not any(ops.launch_counts().values())


# ------------------------------------------------------------- train step

def _batch(vocab, B, S, seed):
    return next(jax_batches(vocab, S, B, seed=seed))


def _idle(cfg, path):
    """True for a leaf of the branch its layer does not run, False for one
    it runs, None outside the two branches."""
    if path[0] != "blocks" or path[2] not in ("mlstm", "slstm"):
        return None
    return path[2] != ("slstm" if _is_slstm(cfg, int(path[1])) else "mlstm")


def _paths(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return [tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in p)
            for p, _ in flat]


def _fp32_ratios(got32, want32, want64):
    """Per leaf, max|port32 - jax64| over max|jax32 - jax64| (the port's
    fp32 error in units of JAX's own), for leaves where both differ."""
    out = []
    for a, b, c in zip(got32, want32, want64):
        ref = np.abs(np.asarray(b, np.float64) - c).max()
        if ref > 0:
            out.append(np.abs(np.asarray(a, np.float64) - c).max() / ref)
    return np.array(out)


def test_loss_fn_and_its_gradient_match_jax(jax_state):
    jcfg, cfg, _, np_state = jax_state
    batch = _batch(cfg.vocab, 2, 512, seed=4)
    batch["labels"][0, :7] = -1
    paths = _paths(np_state.params)
    idle = [_idle(cfg, p) for p in paths]
    assert idle.count(True) == 7 * len(np_state.params["blocks"][0]["slstm"]) \
        + len(np_state.params["blocks"][7]["mlstm"])
    want, got = {}, {}
    for dtype in (np.float32, np.float64):
        with _jax_in(dtype):
            (loss, _), g = jax.jit(jax.value_and_grad(
                jdec.loss_fn, has_aux=True), static_argnums=1)(
                _jax_state(np_state, dtype).params, jcfg,
                {k: jnp.asarray(v) for k, v in batch.items()})
            want[dtype] = float(loss), [np.asarray(a)
                                        for a in jax.tree.leaves(g)]
        params = train_state_from_numpy(_cast(np_state, dtype), "cpu").params
        loss, _, grads = make_train_step(
            cfg, constant_schedule(1e-3)).grads_of(
            params, {k: _t(v) for k, v in batch.items()})
        got[dtype] = float(loss), [_np(a) for a in leaves(grads)]
        assert all(a.dtype == dtype for a in got[dtype][1] + want[dtype][1])
        for path, off, a, b in zip(paths, idle, got[dtype][1], want[dtype][1]):
            assert (not np.any(a) and not np.any(b)) if off else \
                np.abs(b).max() > 0, (dtype, path)
    np.testing.assert_allclose(got[np.float32][0], want[np.float32][0],
                               rtol=STEP_RTOL)
    np.testing.assert_allclose(got[np.float64][0], want[np.float64][0],
                               rtol=VJP_TOL64)
    unit = max(np.abs(b).max() for b in want[np.float64][1])
    for path, a, b in zip(paths, got[np.float64][1], want[np.float64][1]):
        np.testing.assert_allclose(a, b, rtol=0, atol=VJP_TOL64 * unit,
                                   err_msg=".".join(path))
    r = _fp32_ratios(got[np.float32][1], want[np.float32][1],
                     want[np.float64][1])
    print(f"fp32 error over JAX's fp32 error, per leaf: median "
          f"{np.median(r):.2f}, max {r.max():.2f}")


@pytest.mark.parametrize("B,mb", [(1, 1), (2, 2)], ids=["mb1", "mb2"])
def test_train_step_matches_jax(jax_state, B, mb):
    """Three steps from one state at S=512 (two mLSTM chunks) on JAX's
    float64 trajectory, the port stepping from JAX's state before each
    step, in float64 and in fp32."""
    jcfg, cfg, _, np_state = jax_state
    with _jax_in(np.float64):
        jfn = jax.jit(jstep.make_train_step(
            jcfg, jsched.cosine_schedule(3e-3, 0, 3), microbatches=mb,
            weight_decay=WEIGHT_DECAY))
        theirs = _jax_state(np_state, np.float64)
    fn = make_train_step(cfg, cosine_schedule(3e-3, 0, 3), microbatches=mb,
                         weight_decay=WEIGHT_DECAY)
    idle = [_idle(cfg, p) for p in _paths(np_state.params)]
    for i in range(3):
        batch = _batch(cfg.vocab, B, 512, seed=30 + i)
        before = jax.tree.map(np.asarray, theirs)
        with _jax_in(np.float64):
            theirs, wm = jfn(theirs, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
            ref = [np.asarray(a) for a in jax.tree.leaves(theirs.params)]
        assert ref[0].dtype == np.float64
        lr = float(wm["lr"])
        for dtype in (np.float64, np.float32):
            mine, m = fn(train_state_from_numpy(_cast(before, dtype), "cpu"),
                         batch)
            assert mine.opt.step == int(theirs.opt.step) == i + 1
            # the port's schedule computes in float32 in both runs
            np.testing.assert_allclose(m["lr"], lr, rtol=STEP_RTOL)
            tol = VJP_TOL64 if dtype == np.float64 else STEP_RTOL
            keys = ("loss", "grad_norm") if dtype == np.float64 else ("loss",)
            for key in keys:
                np.testing.assert_allclose(float(m[key]), float(wm[key]),
                                           rtol=tol, err_msg=f"{key} {i}")
            for off, a, b, p0 in zip(idle, leaves(mine.params), ref,
                                     jax.tree.leaves(before.params)):
                a, p0 = _np(a), p0.astype(dtype)
                assert a.dtype == dtype
                if dtype == np.float64:
                    err = np.abs(a - b).max()
                    assert err <= PARAM_TOL_LR * lr, (i, a.shape, err)
                if off:                 # at the port's own lr
                    np.testing.assert_allclose(
                        a, p0 - dtype(float(m["lr"]) * WEIGHT_DECAY) * p0,
                        rtol=1e-6 if dtype == np.float32 else 1e-12, atol=0)


def test_launch_train_runs_xlstm_on_the_cpu(capsys):
    hist = launch_train.main(["--arch", "xlstm-1.3b", "--reduced", "--device",
                              "cpu", "--steps", "2", "--seq", "512",
                              "--batch", "2", "--layers", "8", "--d-model",
                              "64", "--vocab", "512", "--microbatches", "2"])
    assert "family=ssm" in capsys.readouterr().out
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    assert all(np.isfinite(h["grad_norm"]) and h["grad_norm"] > 0
               for h in hist)


# ------------------------------------------- the smoke's phases, rehearsed

def test_mlstm_backward_phase_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.mlstm_backward_phase`` (gate X1) end to end on the CPU
    at narrow heads: the forward under grad is the no-grad one to the bit,
    each gradient within X1's bound of float64 autograd through the plain
    scan, the empty start's state gradients all zero; no launches."""
    lines = []
    monkeypatch.setattr(chip_smoke, "emit", lines.append)
    cases = [("S512_cache", 1, 2, 512, 32, "cache"),
             ("B2_S300_warm", 2, 2, 300, 32, "warm"),
             ("S512_empty", 1, 2, 512, 32, "empty")]
    out = chip_smoke.mlstm_backward_phase(torch, None, "cpu", cases=cases)
    assert lines == [out] and out["gate"] == "X1"
    assert out["x1_ratio"] <= 1.0 and out["timed_S2048_empty"] is None
    empty = out["cases"]["S512_empty"]
    assert [p for p in chip_smoke.MLSTM_BWD_PARTS
            if empty[p]["g64_all_zero"]] == ["dC0", "dn0", "dm0"]
    assert not any(out["cases"]["B2_S300_warm"][p]["g64_all_zero"]
                   for p in chip_smoke.MLSTM_BWD_PARTS)


def test_xlstm_train_parity_phase_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.arch_train_parity_phase`` (gate T2x) end to end on the
    CPU at d=64 and S=300 (one chunk, through ``MLSTMScan``): the "card"
    run is a CPU fp32 run, held to cpu64 under T2's bound, the idle
    branches all zero in every run; no kernel launches."""
    lines = []
    monkeypatch.setattr(chip_smoke, "emit", lines.append)
    _, cfg = _reduced()
    out = chip_smoke.arch_train_parity_phase(torch, "xlstm-1.3b", "cpu",
                                             n_text=300, cfg=cfg)
    assert lines == [out] and out["gate"] == "T2x" and out["seq"] == 300
    assert out["k"] == 16
    blocks = train_state_init(cfg, torch.Generator().manual_seed(0),
                              "cpu").params["blocks"]
    # seven idle sLSTM trees, one idle mLSTM tree
    n_idle = 7 * len(blocks[0]["slstm"]) + len(blocks[7]["mlstm"])
    for mb in (1, 2):
        r = out[f"mb{mb}"]
        # the "card" run is cpu32's own arithmetic: 1/k of T2x's bound
        assert r["grad_leaf_ratio_to_bound_max"] <= 1 / 16
        assert max(max(s) for s in r["step_ratio_to_bound"]) <= 1 / 16
        assert r["grad_leaves_all_zero"] == n_idle
        assert not any(r["launches_cuda"].values())


def test_t2_form_holds_each_gate_to_its_multiple():
    """``chip_smoke.t2_ratios``: a leaf's and a step's error over k times
    cpu32's (floored at 1e-4 of the leaf's scale), so the reading scales
    as 1/k; a leaf zero in cpu64 reads 0 only if zero in every run.  T2h,
    T2v and T2a keep T2's multiple, 2, and T2x has 16."""
    def t(*x):
        return torch.tensor(x, dtype=torch.float64)

    c64 = ([t(1.0, -2.0), t(0.0, 0.0)], [(6.0, 80.0)])
    c32 = ([t(1.0, -2.0 + 2e-3), t(0.0, 0.0)], [(6.0 + 1e-3, 80.0)])
    card = ([t(1.0 + 8e-3, -2.0), t(0.0, 0.0)], [(6.0 - 4e-3, 80.0 + 2e-5)])
    for k in (2, 16):
        grad, step = chip_smoke.t2_ratios(card, c32, c64, k)
        # leaf: 8e-3 / 2 over k * 2e-3 / 2; loss: 4e-3 over k * 1e-3;
        # grad norm: 2e-5 over the 1e-4 floor
        assert grad == pytest.approx([4 / k, 0.0])
        assert step == [[pytest.approx(4 / k), pytest.approx(0.2)]]
    live = ([t(1.0, -2.0), t(0.0, 1e-30)], card[1])
    assert chip_smoke.t2_ratios(live, c32, c64)[0][1] == math.inf
    assert {a: v[3] for a, v in chip_smoke.T2_ARCHS.items()} == {
        "hymba-1.5b": 2, "qwen2-vl-7b": 2, "whisper-small": 2,
        "xlstm-1.3b": 16}


def test_xlstm_training_phase_rehearses_on_the_cpu(monkeypatch, capsys):
    """``chip_smoke.arch_training_phase`` (gate T3x) end to end on the CPU:
    ``launch.train.main`` at a narrow xlstm, then the gradient pass that
    holds each layer's running branch nonzero and its idle one zero, and
    a timed step."""
    lines = []
    monkeypatch.setattr(chip_smoke, "emit", lines.append)
    _, cfg = _reduced()
    chip_smoke.arch_training_phase(torch, "xlstm-1.3b", "cpu", cfg=cfg,
                                   n_text=300)
    (line,) = lines
    assert line["phase"] == "ssm_training" and line["gate"] == "T3x"
    assert line["lr"] == 3e-4
    assert "family=ssm" in capsys.readouterr().out
    assert not any(line["launches"].values())
    assert len(line["loss"]) == chip_smoke.TRAIN_STEPS
    assert len(line["timed_steps"]) == 1 and line["seq"] == 300


def test_t3x_leaf_check_flags_a_live_idle_branch_and_a_dead_running_one():
    """``chip_smoke.xlstm_dead_leaves`` passes a gradient of the right
    shape of zeros and flags each way it can be wrong."""
    _, cfg = _reduced()
    params = train_state_init(cfg, torch.Generator().manual_seed(0),
                              "cpu").params
    grads = [{k: {n: torch.zeros_like(t) if _is_slstm(cfg, i) != (k == "slstm")
                  else torch.ones_like(t) for n, t in v.items()}
              if isinstance(v, dict) else torch.ones_like(v)
              for k, v in blk.items()}
             for i, blk in enumerate(params["blocks"])]
    tree = {k: torch.ones_like(v) for k, v in params.items() if k != "blocks"}
    tree["blocks"] = grads
    assert chip_smoke.xlstm_dead_leaves(torch, cfg, tree) == {}
    tree["blocks"][0]["slstm"]["w_z"][0, 0] = 1e-30     # an idle leaf moves
    tree["blocks"][7]["slstm"]["r_f"].zero_()           # a running one dies
    tree["blocks"][3]["ln1"].zero_()
    tree["embed"][0, 0] = float("nan")
    assert sorted(chip_smoke.xlstm_dead_leaves(torch, cfg, tree)) == [
        "blocks.0.slstm.w_z", "blocks.3.ln1", "blocks.7.slstm.r_f", "embed"]
