"""The port's optimization methods, schedules, regularizers and the
train step's gradient legs, health probe, ``skip_nonfinite`` and
``EvalStep`` against the JAX package.

Inputs and weights come from a numpy seed; weights cross by key.
Tolerances: the methods and schedules agree to 1e-6 relative (f32
arithmetic in another order: fused multiply-adds, a host-side rate);
train steps to 1e-5 relative on the loss and rtol 1e-5 / atol 1e-6 on
the parameters; ``bf16_truncate`` and a skipped step bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bigdl_tpu.nn as jnn
import bigdl_tpu.optim as joptim
from bigdl_tpu.nn.module import state_dict as jax_state_dict
from bigdl_tpu.optim import regularizer as jreg
from bigdl_tpu.parallel.train_step import EvalStep as JaxEvalStep
from bigdl_tpu.parallel.train_step import TrainStep as JaxTrainStep
from bigdl_tpu.parallel.train_step import bf16_truncate as jax_bf16_truncate
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch import optim as toptim
from bigdl_tpu_torch.parallel import EvalStep, TrainStep, bf16_truncate
from bigdl_tpu_torch.utils.convert import from_jax_state, to_numpy_state
from test_torch_slice import one_thread  # noqa: F401


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# ---------------------------------------------------------------------------
# methods: three updates against the JAX functional core
# ---------------------------------------------------------------------------

METHODS = [
    ("SGD", dict(learning_rate=0.1, momentum=0.9, dampening=0.5,
                 weight_decay=0.01, learning_rate_schedule=None)),
    ("Adam", dict(learning_rate=0.01, learning_rate_decay=0.1)),
    ("Adamax", dict(learning_rate=0.02)),
    ("Adagrad", dict(learning_rate=0.1, learning_rate_decay=0.2,
                     weight_decay=0.05)),
    ("Adadelta", dict(decay_rate=0.8, epsilon=1e-6)),
    ("RMSprop", dict(learning_rate=0.01, learning_rate_decay=0.1,
                     decay_rate=0.9)),
]
SHAPES = {"a.weight": (3, 4), "a.bias": (3,), "b.weight": (2, 3)}


def _params(seed=0):
    return {k: _x(s, seed=seed + i) for i, (k, s) in enumerate(SHAPES.items())}


def _grads(step):
    return {k: _x(s, seed=100 + 10 * step + i)
            for i, (k, s) in enumerate(SHAPES.items())}


@pytest.mark.parametrize("name,kwargs", METHODS, ids=[m for m, _ in METHODS])
def test_method_matches_jax_over_three_updates(name, kwargs):
    jm, tm = getattr(joptim, name)(**kwargs), getattr(toptim, name)(**kwargs)
    jp = {k: jnp.asarray(v) for k, v in _params().items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in _params().items()}
    jst, tst = jm.init_state(jp), tm.init_state(tp)
    assert set(tst) == set(jst)
    update = jax.jit(jm.update)
    for step in range(3):
        g = _grads(step)
        jp, jst = update({k: jnp.asarray(v) for k, v in g.items()}, jp, jst)
        tst = tm.update({k: torch.from_numpy(v) for k, v in g.items()}, tp,
                        tst)
        for k in SHAPES:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
    for key, val in jst.items():
        if isinstance(val, dict):
            for k in SHAPES:
                np.testing.assert_allclose(tst[key][k].numpy(),
                                           np.asarray(val[k]), rtol=1e-6,
                                           atol=1e-7, err_msg=f"{key} {k}")
        else:
            assert tst[key] == int(val), key


@pytest.mark.parametrize("name,kwargs", METHODS, ids=[m for m, _ in METHODS])
def test_method_with_tensor_counters_equals_int_counters(name, kwargs):
    """The counters a ``skip_nonfinite`` step keeps on the device: the
    same updates, bit for bit, as with Python ints."""
    cls = getattr(toptim, name)
    runs = []
    for as_tensor in (False, True):
        m = cls(**kwargs)
        p = {k: torch.from_numpy(v.copy()) for k, v in _params().items()}
        st = m.init_state(p)
        if as_tensor:
            st["neval"] = torch.tensor(0, dtype=torch.int32)
        for step in range(3):
            st = m.update({k: torch.from_numpy(v)
                           for k, v in _grads(step).items()}, p, st)
        runs.append((p, int(st["neval"])))
    (p0, n0), (p1, n1) = runs
    assert n0 == n1 == 3
    for k in SHAPES:
        assert torch.equal(p0[k], p1[k]), k


# ---------------------------------------------------------------------------
# schedules: the rate over a sequence of states
# ---------------------------------------------------------------------------

def _schedules(lib):
    seq = lib.SequentialSchedule().add(lib.Warmup(0.01, 3), 3) \
        .add(lib.Poly(0.5, 6), 6).add(lib.Exponential(2, 0.5), 10)
    return {
        "Default": lib.Default(0.3),
        "Poly": lib.Poly(0.5, 8),
        "Step": lib.Step(3, 0.5),
        "MultiStep": lib.MultiStep([2, 5, 9], 0.3),
        "EpochDecay": lib.EpochDecay(lambda e: (e - 1) // 2),
        "EpochStep": lib.EpochStep(2, 0.5),
        "NaturalExp": lib.NaturalExp(2, 0.7),
        "Exponential": lib.Exponential(3, 0.6),
        "Exponential staircase": lib.Exponential(3, 0.6, staircase=True),
        "Warmup": lib.Warmup(0.02, 4, lib.Step(2, 0.5)),
        "SequentialSchedule": seq,
        "EpochSchedule": lib.EpochSchedule([
            lib.Regime(1, 2, {"learning_rate": 0.05}),
            lib.Regime(3, 5, {"learning_rate": 0.02})]),
    }


SCHEDULES = sorted(_schedules(toptim))


@pytest.mark.parametrize("name", SCHEDULES)
def test_schedule_rate_matches_jax(name):
    jsched, tsched = _schedules(joptim)[name], _schedules(toptim)[name]
    for neval in range(20):
        epoch = 1 + neval // 3
        want = jsched.rate(0.1, {"neval": jnp.int32(neval),
                                 "epoch": jnp.int32(epoch)})
        got = tsched.rate(0.1, {"neval": neval, "epoch": epoch})
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   err_msg=f"{name} at neval {neval}")


def test_plateau_rate_follows_the_scores_as_jax():
    kw = dict(factor=0.5, patience=2, mode="min", epsilon=1e-3, cooldown=1,
              min_lr=0.01)
    jp, tp = joptim.Plateau(**kw), toptim.Plateau(**kw)
    scores = [1.0, 0.9, 0.95, 0.9, 0.91, 0.92, 0.93, 0.8, 0.85, 0.86, 0.87,
              0.88, 0.89, 0.9]
    for s in scores:
        jp.on_metric(s)
        tp.on_metric(s)
        np.testing.assert_allclose(float(tp.rate(0.1, {})),
                                   float(jp.rate(0.1, {})), rtol=1e-6)
    assert tp.current_factor == jp.current_factor < 1.0


def test_lbfgs_solves_least_squares_as_jax():
    rng = np.random.RandomState(0)
    a = rng.randn(20, 5).astype(np.float32)
    b = rng.randn(20).astype(np.float32)
    solution = np.linalg.lstsq(a, b, rcond=None)[0]

    def feval_for(lib, asarray):
        am, bm = asarray(a), asarray(b)

        def feval(x):
            r = am @ x - bm
            return 0.5 * (r * r).sum(), am.T @ r
        return feval

    for line_search in (False, True):
        kw = dict(max_iter=50, tol_fun=1e-4, line_search=line_search)
        jx, jl = joptim.LBFGS(**kw).optimize(feval_for(jnp, jnp.asarray),
                                             jnp.zeros(5))
        tx, tl = toptim.LBFGS(**kw).optimize(
            feval_for(torch, torch.from_numpy), torch.zeros(5))
        np.testing.assert_allclose(tx.numpy(), solution, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-4,
                                   atol=1e-4)
        assert len(tl) == len(jl)
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        assert tl[-1] < tl[0]


# ---------------------------------------------------------------------------
# bf16_truncate
# ---------------------------------------------------------------------------

def test_bf16_truncate_is_bit_equal_to_jax():
    rng = np.random.RandomState(0)
    x = np.concatenate([
        rng.randn(1000).astype(np.float32)
        * 10.0 ** rng.randint(-30, 30, 1000),
        np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 1e-40, -1e-40,
                  np.float32(1.17549435e-38), 3.4028235e38, -3.4028235e38],
                 np.float32)]).astype(np.float32)
    x[:5] = -np.abs(x[:5])
    want = np.asarray(jax_bf16_truncate(jnp.asarray(x)))
    got = bf16_truncate(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    bf = torch.ones(3, dtype=torch.bfloat16)
    assert bf16_truncate(bf) is bf


# ---------------------------------------------------------------------------
# TrainStep: the gradient legs, health probe and skip_nonfinite
# ---------------------------------------------------------------------------

def _mlp(nn, bn=False, **layer_kw):
    model = nn.Sequential(nn.Linear(6, 8, **layer_kw.get("first", {})),
                          nn.ReLU())
    if bn:
        model.add(nn.BatchNormalization(8))
    model.add(nn.Linear(8, 4, **layer_kw.get("second", {})))
    model.add(nn.LogSoftMax())
    return model


def _mlp_pair(bn=False, jkw=None, tkw=None):
    jmodel, tmodel = _mlp(jnn, bn, **(jkw or {})), _mlp(tnn, bn, **(tkw or {}))
    state = {k: np.asarray(v) for k, v in jax_state_dict(jmodel).items()}
    tnn.load_state_dict(tmodel, from_jax_state(state, "cpu", tmodel))
    return jmodel, tmodel


def _batch(i):
    rng = np.random.RandomState(40 + i)
    return rng.randn(16, 6).astype(np.float32), rng.randint(0, 4, 16)


def _freeze(m):
    m.get(0).freeze()


def _scale(m):
    m.get(0).set_scale_w(0.5)
    m.get(2).set_scale_b(3.0)


LEGS = {
    "freeze": dict(setup=_freeze),
    "scale": dict(setup=_scale),
    "bf16": dict(step=dict(gradient_compression="bf16")),
    "clip": dict(step=dict(gradient_clipping=(-0.02, 0.03))),
    "max_norm": dict(step=dict(max_norm=0.05)),
    "regularizer": dict(layers=lambda lib: dict(
        first=dict(w_regularizer=lib.L1L2Regularizer(0.01, 0.02),
                   b_regularizer=lib.L2Regularizer(0.1)),
        second=dict(w_regularizer=lib.L1Regularizer(0.05)))),
    "all": dict(setup=_scale, step=dict(gradient_compression="bf16",
                                        gradient_clipping=(-0.05, 0.05),
                                        max_norm=0.08)),
}


@pytest.mark.parametrize("name", sorted(LEGS))
def test_gradient_legs_follow_the_jax_train_step(name):
    case = LEGS[name]
    layers = case.get("layers")
    jmodel, tmodel = _mlp_pair(
        jkw=layers(jreg) if layers else None,
        tkw=layers(toptim) if layers else None)
    w0 = tmodel.get(0).weight.detach().clone()
    for m in (jmodel, tmodel):
        case.get("setup", lambda m: None)(m)
    step_kw = case.get("step", {})
    sgd = dict(learning_rate=0.5, momentum=0.9)
    jstep = JaxTrainStep(jmodel, jnn.ClassNLLCriterion(), joptim.SGD(**sgd),
                         health_probe=True, **step_kw)
    tstep = TrainStep(tmodel, tnn.ClassNLLCriterion(), toptim.SGD(**sgd),
                      device="cpu", health_probe=True, **step_kw)
    for i in range(2):
        x, y = _batch(i)
        want = float(jstep.run(jnp.asarray(x), jnp.asarray(y),
                               jax.random.key(i)))
        got = tstep.run(x, y)
        np.testing.assert_allclose(got, want, rtol=1e-5)
        state = to_numpy_state(tstep.model)
        for k, v in jstep.params.items():
            np.testing.assert_allclose(state[k], np.asarray(v), rtol=1e-5,
                                       atol=1e-6, err_msg=f"{name} {k}")
        # the health vector: norms at 1e-5, counts exactly
        np.testing.assert_allclose(tstep.last_health.numpy(),
                                   np.asarray(jstep.last_health),
                                   rtol=1e-5, atol=1e-7)
    if name == "freeze":
        assert tstep.last_health[0] > 0
        # a frozen layer keeps its weights: its gradient is zero and
        # momentum SGD without weight decay does not move it
        np.testing.assert_array_equal(state["0.weight"], w0.numpy())


def test_skip_nonfinite_keeps_params_state_and_buffers_bit_equal():
    jmodel, tmodel = _mlp_pair(bn=True)
    sgd = dict(learning_rate=0.1, momentum=0.9)
    tstep = TrainStep(tmodel, tnn.ClassNLLCriterion(), toptim.SGD(**sgd),
                      device="cpu", skip_nonfinite=True)
    jstep = JaxTrainStep(jmodel, jnn.ClassNLLCriterion(), joptim.SGD(**sgd),
                         skip_nonfinite=True, health_probe=True)
    x, y = _batch(0)
    tstep.run(x, y)
    jstep.run(jnp.asarray(x), jnp.asarray(y), jax.random.key(0))
    before = {k: v.clone() for k, v in tmodel.state_dict().items()}
    vel = {k: v.clone() for k, v in tstep.opt_state["velocity"].items()}
    assert int(tstep.opt_state["neval"]) == 1
    bad = x.copy()
    bad[3, 2] = np.nan
    loss = tstep.run(bad, y)
    want = jstep.run(jnp.asarray(bad), jnp.asarray(y), jax.random.key(1))
    assert np.isnan(loss) and np.isnan(float(want))
    for k, v in tmodel.state_dict().items():
        assert torch.equal(v, before[k]), k
    for k, v in tstep.opt_state["velocity"].items():
        assert torch.equal(v, vel[k]), k
    assert int(tstep.opt_state["neval"]) == int(jstep.opt_state["neval"]) == 1
    assert tstep.last_health[3] > 0
    np.testing.assert_array_equal(tstep.last_health[3:].numpy(),
                                  np.asarray(jstep.last_health)[3:])
    # the next finite step trains on, as the JAX step does
    x, y = _batch(2)
    got = tstep.run(x, y)
    np.testing.assert_allclose(got, float(jstep.run(
        jnp.asarray(x), jnp.asarray(y), jax.random.key(2))), rtol=1e-5)
    assert int(tstep.opt_state["neval"]) == 2
    state = to_numpy_state(tmodel)
    for k, v in {**jstep.params, **jstep.buffers}.items():
        np.testing.assert_allclose(state[k], np.asarray(v), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("bf16", [False, True])
def test_eval_step_matches_jax(bf16):
    jmodel, tmodel = _mlp_pair(bn=True)
    # move the batch-norm buffers off their initial values first
    jstep = JaxTrainStep(jmodel, jnn.ClassNLLCriterion(),
                         joptim.SGD(learning_rate=0.1))
    x, y = _batch(0)
    jstep.run(jnp.asarray(x), jnp.asarray(y), jax.random.key(0))
    jstep.sync_to_model()
    state = {k: np.asarray(v) for k, v in jax_state_dict(jmodel).items()}
    tnn.load_state_dict(tmodel, from_jax_state(state, "cpu", tmodel))
    cdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (None, None)
    want = JaxEvalStep(jmodel, compute_dtype=cdt[0]).run(
        jnp.asarray(_batch(1)[0]))
    tmodel.training_mode()
    got = EvalStep(tmodel, compute_dtype=cdt[1], device="cpu").run(
        _batch(1)[0])
    assert tmodel.training  # the model's own mode is left as it was
    assert got.dtype == torch.float32
    tol = dict(rtol=2e-2, atol=2e-2) if bf16 else dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               **tol)
