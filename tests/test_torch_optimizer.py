"""The training loop of the port against the JAX package: triggers,
validation methods, the health policy, the one-device
``LocalOptimizer`` over two epochs of ResNet-8 with validation, its
halt on non-finite steps, checkpoints and resume, the BTPU files, the
``.npz`` weights that cross to the JAX model, and ``cli train`` /
``cli test``.

Everything runs in f32 on the CPU from the same weights and seeds.
Tolerances: per-iteration losses 1e-5 relative, parameters and
batch-norm buffers 1e-4 (the convolutions sum in another order and two
epochs carry it on), validation counts equal and the loss 1e-5, the
JAX forward of weights the port saved 1e-5; resume and the BTPU round
trip are held bit for bit.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bigdl_tpu.nn as jnn
import bigdl_tpu.optim as joptim
from bigdl_tpu.dataset.sample import Sample as JSample
from bigdl_tpu.models.resnet import build_resnet_cifar as jax_resnet_cifar
from bigdl_tpu.nn.module import functional_call as jax_call
from bigdl_tpu.nn.module import load_state_dict as jax_load_state_dict
from bigdl_tpu.nn.module import state_dict as jax_state_dict
from bigdl_tpu.parallel.train_step import TrainStep as JaxTrainStep
from bigdl_tpu.telemetry import health as jhealth
from bigdl_tpu.utils import serializer as jax_serializer
from bigdl_tpu.utils.rng import RNG
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch import optim
from bigdl_tpu_torch.dataset import Sample, datasets
from bigdl_tpu_torch.models import cli, registry
from bigdl_tpu_torch.models.resnet import build_resnet_cifar
from bigdl_tpu_torch.optim import health
from bigdl_tpu_torch.utils import serializer
from bigdl_tpu_torch.utils.convert import from_jax_state, to_numpy_state
from test_torch_slice import one_thread  # noqa: F401

SEED = 7
N_TRAIN, N_VAL, BATCH = 16, 8, 8


# ---------------------------------------------------------------------------
# triggers and validation methods
# ---------------------------------------------------------------------------

def _states():
    """A run of 3 epochs of 4 iterations with losses, scores and epoch
    boundaries, as the training loop leaves them."""
    out = []
    for it in range(1, 13):
        ep = 1 + it // 4
        out.append({"neval": it, "epoch": ep, "_epoch_boundary": it % 4 == 0,
                    "loss": 2.0 / it, "score": 0.1 * it})
    return [{"neval": 0, "epoch": 1}] + out


TRIGGERS = {
    "every_epoch": lambda T: T.every_epoch(),
    "several_iteration": lambda T: T.several_iteration(3),
    "max_epoch": lambda T: T.max_epoch(2),
    "max_iteration": lambda T: T.max_iteration(7),
    "max_score": lambda T: T.max_score(0.55),
    "min_loss": lambda T: T.min_loss(0.3),
    "and": lambda T: T.and_(T.max_epoch(1), T.several_iteration(2)),
    "or": lambda T: T.or_(T.min_loss(0.2), T.max_iteration(5)),
}


@pytest.mark.parametrize("name", sorted(TRIGGERS))
def test_triggers_fire_as_jax_on_the_same_states(name):
    got, want = TRIGGERS[name](optim.Trigger), TRIGGERS[name](joptim.Trigger)
    fired = [got(s) for s in _states()]
    assert fired == [want(s) for s in _states()]
    assert any(fired)
    assert got.reads_loss == (name in ("min_loss", "or"))


@pytest.mark.parametrize("one_based", [False, True])
def test_validation_methods_match_jax(one_based):
    rng = np.random.RandomState(1)
    out = rng.randn(12, 7).astype(np.float32)
    out = out - np.log(np.exp(out).sum(1, keepdims=True))
    target = rng.randint(0, 7, 12) + (1 if one_based else 0)
    pairs = [(optim.Top1Accuracy(one_based), joptim.Top1Accuracy(one_based)),
             (optim.Top5Accuracy(one_based), joptim.Top5Accuracy(one_based)),
             (optim.MAE(one_based), joptim.MAE(one_based))]
    if not one_based:
        pairs.append((optim.Loss(), joptim.Loss()))
    for tm, jm in pairs:
        halves = [tm(torch.from_numpy(out[s]), target[s])
                  for s in (slice(0, 5), slice(5, 12))]
        got = optim.fetch([halves[0] + halves[1]])[0]
        want = jm(out, target)
        assert type(got).__name__ == type(want).__name__
        assert got.count == want.count == 12
        np.testing.assert_allclose(got.result()[0], want.result()[0],
                                   rtol=1e-6, atol=1e-6)
        if isinstance(want, joptim.AccuracyResult):
            assert got.correct == want.correct
            assert repr(got) == repr(want)


# ---------------------------------------------------------------------------
# the health policy
# ---------------------------------------------------------------------------

def _probe_stream():
    """(health 5-vector, loss) of a run: a falling loss, a spike with a
    gradient explosion, non-finite steps (one, then three in a row) and
    a plateau."""
    ok = lambda gn=1.0: [gn, 10.0, 0.01, 0.0, 0.0]  # noqa: E731
    bad = [float("nan"), float("nan"), float("nan"), 5.0, float("nan")]
    out = [(ok(), 2.0 - 0.01 * i + 0.003 * (i % 3)) for i in range(10)]
    out += [(ok(100.0), 10.0), (bad, float("nan")), (ok(), 1.9)]
    out += [(bad, float("nan"))] * 3
    out += [(ok(), 1.5)] * 60
    return out


POLICIES = {
    "default": {},
    "warn": dict(on_nonfinite="warn", max_grad_norm=50.0,
                 plateau_patience=3),
    "skip": dict(on_nonfinite="skip", halt_after=2),
    "halt_when": dict(on_nonfinite="warn",
                      halt_when=lambda s: s["spikes"] >= 1),
}


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_health_policy_decides_as_jax_on_the_same_probes(name):
    got = health.HealthPolicy(**POLICIES[name])
    want = jhealth.HealthPolicy(**POLICIES[name])
    runs = []
    for _ in range(2):  # fresh(): the same decisions from a clean state
        actions = []
        for n, (vec, loss) in enumerate(_probe_stream(), 1):
            stats = health.probe_stats(vec, loss)
            assert json.dumps(stats) == json.dumps(
                jhealth.probe_stats(vec, loss))
            action, findings = got.observe(n, stats)
            assert (action, findings) == want.observe(n, stats), n
            assert got.state == want.state
            assert got.evidence(n, stats) == want.evidence(n, stats)
            actions.append(action)
            if action == "halt":
                break
        runs.append((actions, dict(got.state)))
        got, want = got.fresh(), want.fresh()
        assert got.state == health.HealthPolicy().state
    assert runs[0] == runs[1]
    actions, state = runs[0]
    assert got.can_halt == (name != "warn")
    halt_at = {"default": 16, "skip": 15, "halt_when": 11}.get(name)
    assert ("halt" in actions) == bool(halt_at)
    assert len(actions) == (halt_at or len(_probe_stream()))
    if name == "warn":  # the spike, the explosion and the plateau
        assert (state["spikes"], state["grad_explosions"],
                state["plateaus"], state["nonfinite_steps"]) == (1, 1, 1, 4)
    if name == "skip":  # the halting step was skipped too
        assert actions.count("skip") == 2 and state["skipped_steps"] == 3


def test_health_policy_refuses_unknown_settings():
    with pytest.raises(ValueError, match="unknown on_nonfinite"):
        health.HealthPolicy(on_nonfinite="stop")
    with pytest.raises(ValueError, match="halt_after"):
        health.HealthPolicy(halt_after=0)
    assert not health.HealthPolicy(on_nonfinite="off").enabled


def _linear(jax_side):
    n = jnn if jax_side else tnn
    return n.Sequential().add(n.Linear(8, 4)).add(n.LogSoftMax())


@pytest.mark.parametrize("mode,halt_after,bad", [
    ("halt", 1, range(8, 16)),   # halts at the poisoned step 2
    ("skip", 2, range(8, 24)),   # skips steps 2 and 3 and halts at 3
])
def test_local_optimizer_halts_where_the_jax_optimizer_halts(mode,
                                                             halt_after,
                                                             bad):
    """Batches of 8 over 32 records in their base order: ``bad`` are
    NaN.  Both loops raise HealthError at the same step with the same
    evidence, state and weights; under ``skip`` the finite step 4 after
    the halt must not have been applied."""
    rng = np.random.RandomState(4)
    x = rng.randn(32, 8).astype(np.float32)
    x[list(bad)] = np.nan
    y = rng.randint(0, 4, 32)
    RNG.set_seed(SEED)
    jmodel = _linear(True)
    init = {k: np.asarray(v) for k, v in jax_state_dict(jmodel).items()}
    jo = joptim.LocalOptimizer(
        jmodel, [JSample(x[i], y[i]) for i in range(32)],
        jnn.ClassNLLCriterion(), batch_size=8,
        end_trigger=joptim.Trigger.max_epoch(2))
    jo.set_optim_method(joptim.SGD(learning_rate=0.1, momentum=0.9))
    jo.set_health_policy(jhealth.HealthPolicy(on_nonfinite=mode,
                                              halt_after=halt_after))
    with pytest.raises(jhealth.HealthError) as jerr:
        jo.optimize()
    model = _linear(False)
    tnn.load_state_dict(model, from_jax_state(init, "cpu", model))
    o = optim.LocalOptimizer(
        model, [Sample(x[i], y[i]) for i in range(32)],
        tnn.ClassNLLCriterion(), batch_size=8,
        end_trigger=optim.Trigger.max_epoch(2), device="cpu", seed=SEED)
    o.set_optim_method(optim.SGD(learning_rate=0.1, momentum=0.9))
    o.set_health_policy(optim.HealthPolicy(on_nonfinite=mode,
                                           halt_after=halt_after))
    with pytest.raises(optim.HealthError) as err:
        o.optimize()
    halt_at = 2 if mode == "halt" else 3
    assert err.value.step == jerr.value.step == halt_at
    assert err.value.reason == jerr.value.reason
    counters = ("nonfinite_steps", "consecutive_nonfinite", "skipped_steps",
                "step")
    assert {k: err.value.evidence[k] for k in counters} \
        == {k: jerr.value.evidence[k] for k in counters}
    assert {k: o.state[k] for k in ("neval", "epoch", "records")} \
        == {k: jo.state[k] for k in ("neval", "epoch", "records")} \
        == {"neval": halt_at, "epoch": 1, "records": 8 * halt_at}
    assert [n for n, *_ in o.history] == list(range(1, halt_at + 1))
    got = to_numpy_state(o.model)
    want = {k: np.asarray(v) for k, v in jax_state_dict(jmodel).items()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    if mode == "skip":  # the finite step 1 only
        assert all(np.isfinite(v).all() for v in got.values())
        assert any(not np.array_equal(got[k], init[k]) for k in init)


# ---------------------------------------------------------------------------
# LocalOptimizer against the JAX LocalOptimizer
# ---------------------------------------------------------------------------

def _data():
    x, y = cli._load_data("resnet", None, "train")
    return x[:N_TRAIN], y[:N_TRAIN], x[N_TRAIN:N_TRAIN + N_VAL], \
        y[N_TRAIN:N_TRAIN + N_VAL]


class _Recorder:
    """A JAX validation method that keeps what it returns."""

    def __init__(self, method):
        self.method, self.results = method, []

    def __call__(self, out, target):
        r = self.method(out, target)
        self.results.append(r)
        return r

    def __repr__(self):
        return repr(self.method)


@pytest.fixture(scope="module")
def jax_run():
    """Two epochs of the JAX LocalOptimizer: its weights before and
    after, its per-iteration losses, its state and its last
    validation."""
    x, y, xv, yv = _data()
    RNG.set_seed(SEED)
    jmodel = jax_resnet_cifar(8)
    init = {k: np.asarray(v) for k, v in jax_state_dict(jmodel).items()}
    losses = []
    orig = JaxTrainStep.run_sharded

    def recording(self, *a, **k):
        out = orig(self, *a, **k)
        losses.append(out)
        return out

    JaxTrainStep.run_sharded = recording
    try:
        RNG.set_seed(SEED)
        methods = [_Recorder(joptim.Top1Accuracy()), _Recorder(joptim.Loss())]
        o = joptim.LocalOptimizer(
            jmodel, [JSample(x[i], y[i]) for i in range(N_TRAIN)],
            jnn.ClassNLLCriterion(), batch_size=BATCH,
            end_trigger=joptim.Trigger.max_epoch(2))
        o.set_optim_method(joptim.SGD(learning_rate=0.1, momentum=0.9))
        o.set_validation(joptim.Trigger.every_epoch(),
                         [JSample(xv[i], yv[i]) for i in range(N_VAL)],
                         methods, batch_size=BATCH)
        o.optimize()
    finally:
        JaxTrainStep.run_sharded = orig
    final = {k: np.asarray(v) for k, v in jax_state_dict(jmodel).items()}
    last = [m.results[-1] for m in methods]  # one validation batch a pass
    return dict(init=init, final=final, losses=[float(v) for v in losses],
                state=dict(o.state), validation=last, jmodel=jmodel)


def _port_optimizer(init, end_trigger, ckpt=None, prefetch=2,
                    async_checkpoint=True):
    x, y, xv, yv = _data()
    model = build_resnet_cifar(8)
    tnn.load_state_dict(model, from_jax_state(init, "cpu", model))
    o = optim.LocalOptimizer(
        model, [Sample(x[i], y[i]) for i in range(N_TRAIN)],
        tnn.ClassNLLCriterion(), batch_size=BATCH, end_trigger=end_trigger,
        device="cpu", seed=SEED, prefetch=prefetch,
        async_checkpoint=async_checkpoint)
    o.set_optim_method(optim.SGD(learning_rate=0.1, momentum=0.9))
    o.set_validation(optim.Trigger.every_epoch(),
                     [Sample(xv[i], yv[i]) for i in range(N_VAL)],
                     [optim.Top1Accuracy(), optim.Loss()], batch_size=BATCH)
    if ckpt is not None:
        o.set_checkpoint(str(ckpt), optim.Trigger.several_iteration(1))
        o.overwrite_checkpoint()
    return o


def test_local_optimizer_two_epochs_follow_the_jax_optimizer(jax_run):
    o = _port_optimizer(jax_run["init"], optim.Trigger.max_epoch(2))
    model = o.optimize()
    assert (o.state["neval"], o.state["epoch"]) \
        == (jax_run["state"]["neval"], jax_run["state"]["epoch"]) == (4, 3)
    np.testing.assert_allclose([v for _, _, v in o.history],
                               jax_run["losses"], rtol=1e-5)
    assert [e for _, e, _ in o.history] == [1, 1, 2, 2]
    got = to_numpy_state(model)
    assert set(got) == set(jax_run["final"])
    for k, v in jax_run["final"].items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    (top1, vt), (loss, vl) = o.last_validation
    jt, jl = jax_run["validation"]
    assert (vt.correct, vt.count) == (jt.correct, jt.count)
    np.testing.assert_allclose(vl.result()[0], jl.result()[0], rtol=1e-5)


def _params_and_velocity(o):
    step = o.last_train_step
    return ({k: v.clone() for k, v in step.params.items()},
            {k: v.clone() for k, v in step.buffers.items()},
            {k: v.clone() for k, v in step.opt_state["velocity"].items()},
            {k: v for k, v in step.opt_state.items() if k != "velocity"})


@pytest.mark.parametrize("stop", ["epoch", "mid_epoch"])
def test_resume_is_bit_equal_to_an_uninterrupted_run(jax_run, tmp_path,
                                                     stop):
    straight = _port_optimizer(jax_run["init"], optim.Trigger.max_epoch(2),
                               tmp_path / "a")
    straight.optimize()
    want = _params_and_velocity(straight)
    first = optim.Trigger.max_epoch(1) if stop == "epoch" \
        else optim.Trigger.max_iteration(3)
    # the interrupted run writes its checkpoints on the loop's thread in
    # one case and on the writer thread in the other
    _port_optimizer(jax_run["init"], first, tmp_path / "b", prefetch=0,
                    async_checkpoint=stop == "epoch").optimize()
    # a fresh run from other weights: the checkpoint replaces them
    again = _port_optimizer({k: v * 0 for k, v in jax_run["init"].items()},
                            optim.Trigger.max_epoch(2), tmp_path / "b")
    again.optimize()
    done = 2 if stop == "epoch" else 3
    assert again.state["_resumed_from"] == str(tmp_path / "b")
    assert [n for n, _, _ in again.history] == list(range(done + 1, 5))
    assert [v for *_, v in again.history] \
        == [v for *_, v in straight.history[done:]]
    assert (again.state["neval"], again.state["epoch"]) == (4, 3)
    for a, b in zip(_params_and_velocity(again), want):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], torch.Tensor):
                assert torch.equal(a[k], b[k]), k
            else:
                assert a[k] == b[k], k


def test_a_corrupted_checkpoint_is_refused(jax_run, tmp_path):
    _port_optimizer(jax_run["init"], optim.Trigger.max_epoch(1),
                    tmp_path).optimize()
    assert sorted(f for f in os.listdir(tmp_path) if "." in f) == [
        "ckptmeta.1.json", "ckptmeta.2.json", "model.1", "model.2",
        "optimMethod.1", "optimMethod.2"]
    with open(tmp_path / "model.2", "r+b") as f:
        f.seek(200)
        byte = f.read(1)
        f.seek(200)
        f.write(bytes([byte[0] ^ 1]))
    ok, problems = optim.Optimizer._verify(str(tmp_path), 2)
    assert not ok and "digest mismatch on model.2" in problems[0]
    o = _port_optimizer(jax_run["init"], optim.Trigger.max_iteration(1),
                        tmp_path)
    o._ckpt_dir = str(tmp_path)
    assert o._restore_from(str(tmp_path))
    assert o.state["neval"] == 1
    assert os.path.exists(tmp_path / "model.2.corrupt")
    assert not os.path.exists(tmp_path / "model.2")


def test_btpu_round_trips_resnet8_and_sgd_bit_for_bit(tmp_path):
    model = build_resnet_cifar(8, generator=torch.Generator().manual_seed(3))
    method = optim.SGD(learning_rate=0.1, momentum=0.9, weight_decay=1e-4,
                       learning_rate_schedule=optim.Step(2, 0.5))
    method.state = {"func_state": method.init_state(
        tnn.parameters(model)), "driver_state": {"epoch": 2, "neval": 5}}
    serializer.save_module(model, str(tmp_path / "m"))
    serializer.save_optim_method(method, str(tmp_path / "o"))
    with pytest.raises(FileExistsError):
        serializer.save_module(model, str(tmp_path / "m"))
    back = serializer.load_module(str(tmp_path / "m"))
    assert [type(m).__name__ for m in back.modules()] \
        == [type(m).__name__ for m in model.modules()]
    a, b = model.state_dict(), back.state_dict()
    assert list(a) == list(b)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(p.requires_grad for p in back.parameters())
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 3, 32, 32)
                         .astype(np.float32))
    model.evaluate(), back.evaluate()
    assert torch.equal(model(x), back(x))
    m2 = serializer.load_optim_method(str(tmp_path / "o"))
    assert type(m2) is optim.SGD and type(m2.schedule) is optim.Step
    assert (m2.learning_rate, m2.momentum, m2.weight_decay,
            m2.schedule.gamma) == (0.1, 0.9, 1e-4, 0.5)
    assert m2.state["driver_state"] == {"epoch": 2, "neval": 5}
    v1, v2 = method.state["func_state"], m2.state["func_state"]
    assert all(torch.equal(v1["velocity"][k], v2["velocity"][k])
               for k in v1["velocity"])
    with pytest.raises(serializer.SerializationError, match="expected"):
        serializer.load_module(str(tmp_path / "o"))


def test_npz_weights_give_the_jax_forward(jax_run, tmp_path):
    o = _port_optimizer(jax_run["init"], optim.Trigger.max_iteration(2))
    model = o.optimize()
    path = str(tmp_path / "w.npz")
    serializer.save_state_dict(model.state_dict(), path)
    jmodel = jax_run["jmodel"]
    jax_load_state_dict(jmodel, jax_serializer.load_state_dict_file(path))
    _, _, xv, _ = _data()
    want = jax.jit(lambda s, x: jax_call(jmodel, s, x, training=False)[0])(
        jax_state_dict(jmodel), jnp.asarray(xv))
    model.evaluate()
    with torch.no_grad():
        got = model(torch.from_numpy(xv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# cli train / cli test
# ---------------------------------------------------------------------------

def test_cli_train_then_test(monkeypatch, tmp_path, capsys):
    small = registry.ModelEntry(
        lambda n=0, g=None: build_resnet_cifar(8, n or 10, generator=g),
        (3, 32, 32), "float32")
    monkeypatch.setitem(registry.MODELS, "resnet", small)
    load = datasets.load_cifar10
    monkeypatch.setattr(datasets, "load_cifar10",
                        lambda folder, split: load(folder, split,
                                                   synthetic_size=16))
    ckpt = str(tmp_path / "ck")
    cli.main(["train", "--device", "cpu", "--model", "resnet", "-b", "8",
              "--max-epoch", "1", "--checkpoint", ckpt])
    lines = capsys.readouterr().out.strip().splitlines()
    report = json.loads(lines[-3])
    assert (report["neval"], report["epoch"], report["steps"]) == (2, 2, 2)
    assert all(np.isfinite(v) for *_, v in report["iterations"])
    assert report["launches"] and not any(report["launches"].values())
    assert report["validation"]["Top1Accuracy"]["count"] == 16
    assert lines[-2].startswith("final Top1Accuracy: Accuracy(")
    assert lines[-1].startswith("final Top5Accuracy: Accuracy(")
    stamp = os.listdir(ckpt)[0]
    assert sorted(os.listdir(os.path.join(ckpt, stamp))) == [
        "ckptmeta.2.json", "model.2", "optimMethod.2"]
    cli.main(["test", "--device", "cpu", "--model", "resnet", "-b", "8",
              "--checkpoint", ckpt])
    test_lines = capsys.readouterr().out.strip().splitlines()
    assert test_lines == [ln[len("final "):] for ln in lines[-2:]]
    if not torch.cuda.is_available():  # no --device: cuda or raise
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["test", "--model", "resnet", "--checkpoint", ckpt])


def test_local_predictor_and_evaluator_batch_as_the_model_runs():
    model = build_resnet_cifar(8, generator=torch.Generator().manual_seed(5))
    x = np.random.RandomState(2).randn(5, 3, 32, 32).astype(np.float32)
    y = np.array([1, 0, 3, 3, 9])
    model.evaluate()
    with torch.no_grad():
        want = model(torch.from_numpy(x)).numpy()
    pred = optim.LocalPredictor(model, batch_size=2, device="cpu")
    samples = [Sample(x[i], y[i]) for i in range(5)]
    for data in (x, samples):  # batches of 2: the CPU conv may round
        np.testing.assert_allclose(pred.predict(data), want, rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_array_equal(pred.predict_class(x, one_based=True),
                                  want.argmax(-1) + 1)
    (r1, m1), = optim.Evaluator(model, 2, device="cpu").evaluate(
        samples, [optim.Top1Accuracy()])
    assert (r1.correct, r1.count) == (int((want.argmax(-1) == y).sum()), 5)
