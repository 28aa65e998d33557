"""The transformer LM slice of the port against the JAX package: each
layer (LayerNorm, MultiHeadAttention in its input forms, TransformerBlock,
LookupTable, TimeDistributed, TimeDistributedCriterion), a narrow
``build_transformer_lm`` through the flash path over three SGD steps of
``TrainStep``, ``cli perf --model transformer`` and ``make_step``.

Weights cross by key (``from_jax_state``); inputs and output gradients
come from a numpy seed, f32.  Tolerances: layer outputs to rtol 1e-5 /
atol 1e-6 and their gradients to 1e-5 / 1e-5 (matmuls sum in another
order); the narrow LM's log-probs to 1e-5, its three-step losses to 1e-5
relative and parameters to 1e-4 / 1e-6.  The JAX flash kernels run in
Pallas interpret mode, the port's on their plain versions.
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
from bigdl_tpu.models.transformer import build_transformer_lm as jax_build_lm
from bigdl_tpu.nn.module import functional_call
from bigdl_tpu.nn.module import state_dict as jax_state_dict
from bigdl_tpu.parallel.train_step import TrainStep as JaxTrainStep
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.bench_configs import make_step
from bigdl_tpu_torch.models import cli, registry
from bigdl_tpu_torch.models.transformer import build_transformer_lm
from bigdl_tpu_torch.optim import SGD
from bigdl_tpu_torch.parallel import TrainStep
from bigdl_tpu_torch.utils.convert import from_jax_state, to_numpy_state
from test_torch_slice import one_thread  # noqa: F401

OUT_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)


def _copy_weights(jmodel, tmodel):
    state = {k: np.asarray(v) for k, v in jax_state_dict(jmodel).items()}
    tnn.load_state_dict(tmodel, from_jax_state(state, "cpu", tmodel))
    return state


def _layer_parity(jlayer, tlayer, inputs, seed=0):
    """Forward and gradients (parameters and float inputs) of one layer
    in both packages on the same weights; ``inputs`` is a list of numpy
    arrays, the layer's input is the one array or their tuple."""
    state = _copy_weights(jlayer, tlayer)
    floats = [i for i, a in enumerate(inputs) if a.dtype == np.float32]

    def pack(xs, fl):
        xs = list(xs)
        for i, a in zip(floats, fl):
            xs[i] = a
        return xs[0] if len(xs) == 1 else tuple(xs)

    def jloss(p, fl, gy):
        out, _ = functional_call(jlayer, p, pack(map(jnp.asarray, inputs),
                                                 fl))
        return jnp.sum(out * gy), out

    jp = {k: jnp.asarray(v) for k, v in state.items()}
    jfl = [jnp.asarray(inputs[i]) for i in floats]
    shape = jax.eval_shape(lambda p, fl: jloss(p, fl, 0.0)[1], jp, jfl).shape
    gy = np.random.RandomState(seed + 100).randn(*shape).astype(np.float32)
    (_, want), (gp, gx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jp, jfl, jnp.asarray(gy))

    tin = [torch.from_numpy(a.copy()) for a in inputs]
    for i in floats:
        tin[i].requires_grad_()
    out = tlayer(pack(tin, [tin[i] for i in floats]))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               **OUT_TOL)
    (out * torch.from_numpy(gy)).sum().backward()
    for name, p in tlayer.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(gp[name]),
                                   err_msg=name, **GRAD_TOL)
    for i, g in zip(floats, gx):
        np.testing.assert_allclose(tin[i].grad.numpy(), np.asarray(g),
                                   err_msg=f"input {i}", **GRAD_TOL)
    return out


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _mask():
    m = np.random.RandomState(7).rand(2, 1, 5, 5) > 0.3
    m[..., 0] = True  # every row sees at least one key
    return m


LAYER_CASES = {
    "layer_norm": lambda nn: (nn.LayerNorm(8), [_x(2, 3, 8)]),
    "mha_self_causal": lambda nn: (
        nn.MultiHeadAttention(16, 4, causal=True, backend="dense"),
        [_x(2, 5, 16)]),
    "mha_self_no_bias": lambda nn: (
        nn.MultiHeadAttention(16, 4, with_bias=False, backend="dense"),
        [_x(2, 5, 16)]),
    "mha_x_mask": lambda nn: (
        nn.MultiHeadAttention(16, 4, backend="dense"),
        [_x(2, 5, 16), _mask()]),
    "mha_q_k_v": lambda nn: (
        nn.MultiHeadAttention(16, 4, causal=True, backend="dense"),
        [_x(2, 5, 16), _x(2, 7, 16, seed=1), _x(2, 7, 16, seed=2)]),
    "transformer_block": lambda nn: (
        nn.TransformerBlock(16, 4, mlp_ratio=2, backend="dense"),
        [_x(2, 5, 16)]),
    "lookup_padding_idx": lambda nn: (
        nn.LookupTable(10, 6, padding_idx=3),
        [np.array([[3, 1, 3], [0, 9, 3]], np.int64)]),
    "lookup_max_norm": lambda nn: (
        nn.LookupTable(10, 6, max_norm=1.5),
        [np.array([[2, 1, 2], [0, 9, 5]], np.int64)]),
    "lookup_one_based_float": lambda nn: (
        nn.LookupTable(10, 6, one_based=True),
        [np.array([[1.0, 10.0, 4.0], [2.0, 2.0, 7.0]], np.float64)]),
    "time_distributed": lambda nn: (
        nn.TimeDistributed(nn.Sequential(nn.Linear(8, 6), nn.LogSoftMax())),
        [_x(2, 3, 8)]),
}


@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_layer_matches_jax(case):
    jlayer, inputs = LAYER_CASES[case](jnn)
    tlayer, _ = LAYER_CASES[case](tnn)
    _layer_parity(jlayer, tlayer, inputs)


def test_padding_row_keeps_its_value_and_gets_no_gradient():
    table = tnn.LookupTable(10, 6, padding_idx=3)
    idx = torch.tensor([[3, 1, 3], [0, 9, 3]])
    rows = table(idx)
    assert torch.equal(rows[0, 0], table.weight[3].detach())
    rows.sum().backward()
    assert torch.equal(table.weight.grad[3], torch.zeros(6))
    assert torch.equal(table.weight.grad[1], torch.ones(6))
    with pytest.raises(NotImplementedError, match="sparse"):
        tnn.LookupTable(10, 6, sparse=True)


def test_fused_qkv_equals_separate_projections():
    """Self-attention's one [3E, E] product against the three projections
    the (q, k, v) form runs, forward and gradients."""
    mha = tnn.MultiHeadAttention(16, 4, causal=True, backend="dense")
    x = torch.from_numpy(_x(2, 5, 16))
    gy = torch.from_numpy(_x(2, 5, 16, seed=3))
    grads = []
    for inp in ((x,), (x, x.clone(), x.clone())):
        mha.zero_grad()
        out = mha(inp[0] if len(inp) == 1 else inp)
        (out * gy).sum().backward()
        grads.append((out.detach(), {n: p.grad.clone()
                                     for n, p in mha.named_parameters()}))
    torch.testing.assert_close(grads[0][0], grads[1][0], rtol=1e-6,
                               atol=1e-6)
    for name, g in grads[0][1].items():
        torch.testing.assert_close(g, grads[1][1][name], rtol=1e-5,
                                   atol=1e-6, msg=name)


def test_gelu_is_the_tanh_approximation():
    h = np.linspace(-3, 3, 13, dtype=np.float32)
    want = np.asarray(jax.nn.gelu(h))
    F = torch.nn.functional
    np.testing.assert_allclose(
        F.gelu(torch.from_numpy(h), approximate="tanh").numpy(), want,
        rtol=1e-6, atol=1e-7)
    # PyTorch's default, erf, is another function
    assert np.abs(F.gelu(torch.from_numpy(h)).numpy() - want).max() > 1e-4
    block = tnn.TransformerBlock(8, 2)
    assert block.attn.causal and block.attn.backend == "auto"


@pytest.mark.parametrize("weights,size_average", [
    (None, True), ([0.5, 1.0, 2.0, 0.25, 3.0], True),
    ([0.5, 1.0, 2.0, 0.25, 3.0], False)])
def test_time_distributed_criterion_matches_jax(weights, size_average):
    """Per-step losses summed (over t under size_average): with a weighted
    inner criterion this differs from one flattened [B*T] mean."""
    logp = np.asarray(jax.nn.log_softmax(_x(3, 4, 5, seed=5)))
    y = np.random.RandomState(6).randint(0, 5, (3, 4))
    jc = jnn.TimeDistributedCriterion(jnn.ClassNLLCriterion(weights=weights),
                                      size_average=size_average)
    want, jgrad = jax.jit(jax.value_and_grad(
        lambda a: jc.forward(a, jnp.asarray(y))))(jnp.asarray(logp))
    tc = tnn.TimeDistributedCriterion(tnn.ClassNLLCriterion(weights=weights),
                                      size_average=size_average)
    inp = torch.from_numpy(logp.copy()).requires_grad_()
    got = tc.forward(inp, y)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(inp.grad.numpy(), np.asarray(jgrad),
                               rtol=1e-6, atol=1e-7)
    if weights is not None:
        flat = tnn.ClassNLLCriterion(weights=weights).forward(
            inp.reshape(12, 5), y.reshape(12))
        assert abs(flat.item() * (4 if size_average else 1) - got.item()) \
            > 1e-3


# ---------------------------------------------------------------------------
# the slice as a whole: a narrow transformer LM through the flash path
# ---------------------------------------------------------------------------

NARROW = dict(num_layers=2, embed_dim=32, num_heads=4, max_len=32,
              backend="flash")
VOCAB, SEQ = 64, 32


def _lm_pair():
    jmodel = jax_build_lm(VOCAB, **NARROW)
    tmodel = build_transformer_lm(VOCAB, **NARROW)
    _copy_weights(jmodel, tmodel)
    return jmodel, tmodel


def _lm_batch(step):
    # 2 x 32 lookups: over half the vocab of 64, so JAX's embedding stays
    # dense (its row-sparse update is another algorithm)
    rng = np.random.RandomState(30 + step)
    return (rng.randint(0, VOCAB, (2, SEQ)).astype(np.int32),
            rng.randint(0, VOCAB, (2, SEQ)))


def test_narrow_lm_forward_matches_jax():
    jmodel, tmodel = _lm_pair()
    x, _ = _lm_batch(0)
    state = {k: jnp.asarray(v) for k, v in jax_state_dict(jmodel).items()}
    want = jax.jit(lambda p, a: functional_call(jmodel, p, a,
                                                training=False)[0])(
        state, jnp.asarray(x))
    with torch.no_grad():
        got = tmodel.evaluate()(torch.from_numpy(x))
    assert got.shape == (2, SEQ, VOCAB)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_narrow_lm_three_sgd_steps_follow_the_jax_train_step(monkeypatch):
    monkeypatch.setenv("BIGDL_SPARSE", "off")
    jmodel, tmodel = _lm_pair()
    sgd = dict(learning_rate=0.01, momentum=0.9)
    jstep = JaxTrainStep(jmodel, jnn.TimeDistributedCriterion(
        jnn.ClassNLLCriterion(), size_average=True), joptim.SGD(**sgd))
    tstep = TrainStep(tmodel, tnn.TimeDistributedCriterion(
        tnn.ClassNLLCriterion(), size_average=True), SGD(**sgd),
        device="cpu")
    for i in range(3):
        x, y = _lm_batch(i)
        want = float(jstep.run(jnp.asarray(x), jnp.asarray(y),
                               jax.random.key(i)))
        got = tstep.run(x, y)
        np.testing.assert_allclose(got, want, rtol=1e-5)
    state = to_numpy_state(tstep.model)
    assert set(state) == set(jstep.params)
    for k, v in jstep.params.items():
        np.testing.assert_allclose(state[k], np.asarray(v), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_flash_path_runs_the_flash_wrappers(monkeypatch):
    """Each block's attention reaches flash_fwd once forward and
    flash_dq / flash_dkv once backward (the CPU runs their plain
    versions)."""
    from bigdl_tpu_torch.ops import attention

    calls = {"fwd": 0, "dq": 0, "dkv": 0}

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    for name in calls:
        fn = getattr(attention, f"flash_{name}")
        monkeypatch.setattr(attention, f"flash_{name}", count(name, fn))
    _, tmodel = _lm_pair()
    x, _ = _lm_batch(0)
    tmodel(torch.from_numpy(x)).sum().backward()
    assert calls == {"fwd": 2, "dq": 2, "dkv": 2}


# ---------------------------------------------------------------------------
# cli perf and make_step
# ---------------------------------------------------------------------------

def test_perf_trains_the_transformer_on_the_cpu(monkeypatch, capsys):
    def narrow(num_classes=0, generator=None):
        return build_transformer_lm(num_classes or 256, num_layers=1,
                                    embed_dim=16, num_heads=2, max_len=128,
                                    generator=generator)

    monkeypatch.setitem(registry.MODELS, "transformer", registry.ModelEntry(
        narrow, (registry.LM_SEQ_LEN,), "int32"))
    cli.main(["perf", "--model", "transformer", "-b", "2", "-i", "2",
              "--warmup", "1", "--no-bf16", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    report = json.loads(lines[-2])
    assert len(report["losses"]) == 3 and all(np.isfinite(report["losses"]))
    # 256 classes: the first loss is near ln 256
    assert abs(report["losses"][0] - np.log(256)) < 1.0
    assert set(report["launches"].values()) == {0}
    assert re.fullmatch(r"transformer: [0-9.]+ records/sec \(batch 2, 2 "
                        r"iters, [0-9.]+s\)", lines[-1])


def test_make_step_builds_the_full_transformer_lm():
    step, x, y = make_step("transformer_lm", batch=1, device="cpu")
    state = step.model.state_dict()
    assert len(state) == 102
    assert sum(v.numel() for v in state.values()) == 51_977_472
    assert x.shape == y.shape == (1, 512) and x.dtype == torch.int32
    assert int(x.max()) < 32000 and int(y.max()) < 32000
    assert step.compute_dtype == torch.bfloat16
    assert step.model.get(2).attn.backend == "auto"
    assert list(state)[:3] == ["0.weight", "1.weight", "2.ln1.weight"]
    assert list(state)[-2:] == ["9.0.0.weight", "9.0.0.bias"]


@pytest.mark.slow
def test_full_width_transformer_lm_batch1_matches_jax():
    """``transformer_lm`` at full width, batch 1, seq 512: all 102 tensors
    cross by key and the log-probs agree (dense attention on both sides,
    the CPU's auto route)."""
    jmodel = jax_build_lm(32000, num_layers=6, embed_dim=512, num_heads=8,
                          max_len=512)
    tmodel = build_transformer_lm(32000, num_layers=6, embed_dim=512,
                                  num_heads=8, max_len=512)
    assert len(_copy_weights(jmodel, tmodel)) == 102
    x = np.random.RandomState(0).randint(0, 32000, (1, 512)).astype(np.int32)
    want = np.asarray(jmodel.evaluate().forward(jnp.asarray(x)))
    with torch.no_grad():
        got = tmodel.evaluate()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
