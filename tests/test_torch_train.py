"""The training slice of the port against the JAX package: the
criterion, SGD, dropout, the ReLU and max-pool backwards, and
``TrainStep`` over a few SGD steps of the narrow Inception-v1 of
``test_torch_slice.py``, on weights copied by key.

Inputs and gradients come from a numpy seed.  Tolerances: the losses of
f32 steps agree to 1e-5 relative and the parameters to 1e-4 / 1e-6 (the
convolutions sum in another order, and three steps carry it on); a bf16
step's loss to 2e-2, the slack the kernel tests give bf16.
"""

import json
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bigdl_tpu.nn as jnn
import bigdl_tpu.optim as joptim
from bigdl_tpu.models.inception import build_inception_v1 as jax_build_v1
from bigdl_tpu.nn.module import state_dict as jax_state_dict
from bigdl_tpu.parallel.train_step import TrainStep as JaxTrainStep
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.models import cli, registry
from bigdl_tpu_torch.models.inception import build_inception_v1
from bigdl_tpu_torch.optim import SGD
from bigdl_tpu_torch.parallel import TrainStep
from bigdl_tpu_torch.utils.convert import from_jax_state, to_numpy_state
from test_torch_slice import copied_pair, narrow_inception, one_thread  # noqa: F401


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# ---------------------------------------------------------------------------
# ClassNLLCriterion
# ---------------------------------------------------------------------------

NLL_CASES = [
    # (kwargs, labels)
    ({}, [0, 3, 4, 1, 3]),
    ({"one_based": True}, [1, 4, 5, 2, 4]),
    ({"weights": [0.5, 1.0, 2.0, 0.25, 3.0]}, [0, 3, 4, 1, 2]),
    ({"size_average": False}, [2, 2, 0, 4, 1]),
    ({"weights": [0.5, 1.0, 2.0, 0.25, 3.0], "size_average": False},
     [0.0, 3.0, 4.0, 1.0, 2.0]),            # float labels become indices
]


@pytest.mark.parametrize("kwargs,labels", NLL_CASES)
def test_class_nll_matches_jax(kwargs, labels):
    logp = np.array(jax.nn.log_softmax(_x((5, 5), seed=1)))
    # the loss and its gradient (jax.grad of the same loss) in one jitted
    # call: eager dispatch compiles every small op on its own
    want, jgrad = jax.jit(jax.value_and_grad(
        lambda a: jnn.ClassNLLCriterion(**kwargs).forward(
            a, jnp.asarray(labels))))(jnp.asarray(logp))
    inp = torch.from_numpy(logp).requires_grad_()
    got = tnn.ClassNLLCriterion(**kwargs).forward(inp, np.asarray(labels))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    got.backward()
    np.testing.assert_allclose(inp.grad.numpy(), np.asarray(jgrad),
                               rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# SGD
# ---------------------------------------------------------------------------

SGD_CASES = [
    dict(learning_rate=0.1, momentum=0.9, dampening=0.5),  # first-step copy
    dict(learning_rate=0.05, momentum=0.8, nesterov=True),
    dict(learning_rate=0.1, weight_decay=0.01, momentum=0.9,
         learning_rate_decay=0.5),
    dict(learning_rate=0.2, weight_decay=0.1),             # no momentum
]


@pytest.mark.parametrize("kwargs", SGD_CASES)
def test_sgd_matches_jax_over_three_updates(kwargs):
    shapes = {"a.weight": (3, 4), "a.bias": (3,)}
    p0 = {k: _x(s, seed=i) for i, (k, s) in enumerate(shapes.items())}
    jm, tm = joptim.SGD(**kwargs), SGD(**kwargs)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    jst, tst = jm.init_state(jp), tm.init_state(tp)
    for step in range(3):
        g = {k: _x(s, seed=10 * step + i)
             for i, (k, s) in enumerate(shapes.items())}
        jp, jst = jm.update({k: jnp.asarray(v) for k, v in g.items()}, jp,
                            jst)
        tst = tm.update({k: torch.from_numpy(v) for k, v in g.items()}, tp,
                        tst)
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7)
    assert tst["neval"] == int(jst["neval"]) == 3


def test_nesterov_needs_momentum_and_no_dampening():
    with pytest.raises(ValueError, match="Nesterov"):
        SGD(momentum=0.9, dampening=0.5, nesterov=True)


# ---------------------------------------------------------------------------
# Dropout (the JAX mask comes from jax.random: held by its statistics)
# ---------------------------------------------------------------------------

def _dropout(p, seed, x, scale=True):
    layer = tnn.Dropout(p, scale=scale).training_mode()
    with tnn.dropout_generator(torch.Generator().manual_seed(seed)):
        return layer(x)


def test_dropout_keep_rate_and_scale():
    n, p = 200_000, 0.4
    out = _dropout(p, 0, torch.ones(n))
    kept = out != 0
    rate = kept.float().mean().item()
    assert abs(rate - (1 - p)) < 3 * np.sqrt(p * (1 - p) / n)
    assert torch.equal(out[kept], torch.full_like(out[kept], 1 / (1 - p)))
    unscaled = _dropout(p, 0, torch.ones(n), scale=False)
    assert torch.equal(unscaled, kept.float())


def test_dropout_reproduces_from_its_seed_and_is_identity_in_eval():
    x = torch.from_numpy(_x((64, 32)))
    assert torch.equal(_dropout(0.5, 3, x), _dropout(0.5, 3, x))
    assert not torch.equal(_dropout(0.5, 3, x), _dropout(0.5, 4, x))
    assert _dropout(0.5, 3, x.bfloat16()).dtype == torch.bfloat16
    assert torch.equal(tnn.Dropout(0.5).evaluate()(x), x)


# ---------------------------------------------------------------------------
# ReLU and max-pool backwards: exact against the JAX layers
# ---------------------------------------------------------------------------

def _vjp_pair(jlayer, tlayer, x, gy):
    _, vjp = jax.vjp(jlayer.update_output, jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(gy))[0])
    xt = torch.from_numpy(x).requires_grad_()
    (got,) = torch.autograd.grad(tlayer(xt), xt, torch.from_numpy(gy))
    return got.numpy(), want


def test_relu_backward_is_zero_at_the_origin():
    x = np.array([[-1.0, 0.0, 2.0, -0.0, 0.0, 3.5]], np.float32)
    got, want = _vjp_pair(jnn.ReLU(), tnn.ReLU(), x, np.ones_like(x))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [[0, 0, 1, 0, 0, 1]])


def test_max_pool_ties_go_to_the_first_maximum():
    # 3x3 s2 ceil on 6x6: the last window column overflows by one.  The
    # top-left window is all zeros (after a ReLU); the overflow window
    # of the first row ties 5.0 at columns 4 and 5.
    x = np.zeros((1, 1, 6, 6), np.float32)
    x[0, 0, 0, 4] = x[0, 0, 0, 5] = 5.0
    x[0, 0, 3:, 3:] = _x((3, 3), seed=2)
    gy = _x((1, 1, 3, 3), seed=3)
    got, want = _vjp_pair(jnn.SpatialMaxPooling(3, 3, 2, 2).ceil(),
                          tnn.SpatialMaxPooling(3, 3, 2, 2).ceil(), x, gy)
    np.testing.assert_array_equal(got, want)
    assert got[0, 0, 0, 0] == gy[0, 0, 0, 0]   # first of nine zeros
    # column 4 is the first maximum of windows (0, 1) and (0, 2)
    assert got[0, 0, 0, 5] == 0.0
    assert got[0, 0, 0, 4] == gy[0, 0, 0, 1] + gy[0, 0, 0, 2]


# ---------------------------------------------------------------------------
# the slice as a whole: TrainStep over SGD steps of the narrow model
# ---------------------------------------------------------------------------

def _step_pair(compute_dtype=None):
    jmodel, tmodel = copied_pair()
    sgd = dict(learning_rate=0.01, momentum=0.9)
    jstep = JaxTrainStep(jmodel, jnn.ClassNLLCriterion(), joptim.SGD(**sgd),
                         compute_dtype=None if compute_dtype is None
                         else jnp.bfloat16)
    tstep = TrainStep(tmodel, tnn.ClassNLLCriterion(), SGD(**sgd),
                      compute_dtype=compute_dtype, device="cpu")
    return jstep, tstep


def _batch(step):
    rng = np.random.RandomState(20 + step)
    return (rng.randn(2, 3, 32, 32).astype(np.float32),
            rng.randint(0, 10, 2))


def test_three_sgd_steps_follow_the_jax_train_step():
    jstep, tstep = _step_pair()
    for i in range(3):
        x, y = _batch(i)
        want = float(jstep.run(jnp.asarray(x), jnp.asarray(y),
                               jax.random.key(i)))
        got = tstep.run(x, y)
        np.testing.assert_allclose(got, want, rtol=1e-5)
    state = to_numpy_state(tstep.model)
    assert list(state) == list(tstep.params)  # state_dict order
    assert set(state) == set(jstep.params)
    for k, v in jstep.params.items():
        np.testing.assert_allclose(state[k], np.asarray(v), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_bf16_step_loss_follows_the_jax_train_step():
    jstep, tstep = _step_pair(torch.bfloat16)
    x, y = _batch(0)
    want = jstep.run(jnp.asarray(x), jnp.asarray(y), jax.random.key(0))
    got = tstep.run(x, y)
    assert want.dtype == jnp.bfloat16   # the port keeps its loss in f32
    np.testing.assert_allclose(got, float(want), rtol=2e-2)
    # the masters stay f32 and moved
    assert all(p.dtype == torch.float32 for p in tstep.params.values())
    assert tstep.opt_state["neval"] == 1


def test_train_step_drives_both_backward_functions(monkeypatch):
    """The narrow model's LRN and average pool reach their autograd
    functions (the CPU runs their plain versions)."""
    from bigdl_tpu_torch.ops import lrn, pool

    calls = {"lrn": 0, "pool": 0}

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(lrn, "cross_map_lrn_backward",
                        count("lrn", lrn.cross_map_lrn_backward))
    monkeypatch.setattr(pool, "avg_pool_backward",
                        count("pool", pool.avg_pool_backward))
    _, tstep = _step_pair()
    tstep.run(*_batch(0))
    assert calls == {"lrn": 2, "pool": 1}


# ---------------------------------------------------------------------------
# cli perf
# ---------------------------------------------------------------------------

def test_perf_arguments_parse_as_the_jax_cli():
    args = cli._parser().parse_args(["perf", "--model", "inception_v1",
                                     "-b", "256", "-i", "5", "--warmup", "2"])
    assert (args.model, args.batch_size, args.iteration, args.warmup,
            args.bf16, args.num_classes, args.device) \
        == ("inception_v1", 256, 5, 2, True, 0, "cuda")
    assert args.fn is cli.cmd_perf
    assert cli._parser().parse_args(["perf", "--no-bf16"]).bf16 is False


def test_perf_trains_on_the_cpu_and_reports(monkeypatch, capsys):
    """``perf`` end to end on a small registered model (the full-width
    model is too slow for the CPU suite)."""
    def narrow(num_classes=0, generator=None):
        torch.manual_seed(0)
        return narrow_inception(tnn, __import__(
            "bigdl_tpu_torch.models.inception",
            fromlist=["inception_layer_v1"]).inception_layer_v1)

    monkeypatch.setitem(registry.MODELS, "narrow",
                        registry.ModelEntry(narrow, (3, 32, 32), "float32"))
    cli.main(["perf", "--model", "narrow", "-b", "4", "-i", "2",
              "--warmup", "1", "--num-classes", "10", "--no-bf16",
              "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    report = json.loads(lines[-2])
    assert len(report["losses"]) == 3
    assert all(np.isfinite(report["losses"]))
    assert report["launches"] == {"cross_map_lrn_fwd": 0,
                                  "cross_map_lrn_bwd": 0,
                                  "avg_pool_fwd": 0, "avg_pool_bwd": 0,
                                  "flash_fwd": 0, "flash_dq": 0,
                                  "flash_dkv": 0, "maxpool_fwd": 0,
                                  "maxpool_tie_bwd": 0,
                                  "maxpool_argmax_bwd": 0,
                                  "within_channel_lrn_fwd": 0,
                                  "within_channel_lrn_bwd": 0,
                                  "smooth2d": 0}
    assert re.fullmatch(r"narrow: [0-9.]+ records/sec \(batch 4, 2 iters, "
                        r"[0-9.]+s\)", lines[-1])


# ---------------------------------------------------------------------------
# full width (slow)
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_full_width_inception_v1_train_step_matches_jax():
    jmodel = jax_build_v1(has_dropout=False)
    tmodel = build_inception_v1(has_dropout=False)
    state = {k: np.asarray(v) for k, v in jax_state_dict(jmodel).items()}
    tnn.load_state_dict(tmodel, from_jax_state(state, "cpu", tmodel))
    sgd = dict(learning_rate=0.01, momentum=0.9)
    jstep = JaxTrainStep(jmodel, jnn.ClassNLLCriterion(), joptim.SGD(**sgd))
    tstep = TrainStep(tmodel, tnn.ClassNLLCriterion(), SGD(**sgd),
                      device="cpu")
    rng = np.random.RandomState(0)
    x = rng.randn(2, 3, 224, 224).astype(np.float32)
    y = rng.randint(0, 1000, 2)
    want = float(jstep.run(jnp.asarray(x), jnp.asarray(y),
                           jax.random.key(0)))
    got = tstep.run(x, y)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    got_state = to_numpy_state(tstep.model)
    for k, v in jstep.params.items():
        np.testing.assert_allclose(got_state[k], np.asarray(v), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
