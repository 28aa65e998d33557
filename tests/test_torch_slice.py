"""The serving slice as a whole: a narrow Inception-v1 built in both
packages from their public classes, weights copied by key, served by
each package's ``BucketedExecutor``.

The narrow model keeps every layer kind of the real one (7x7/s2 stem,
ceil max pools, two cross-map LRNs, one ``inception_layer_v1``, the
average-pool head, ``View``, ``Linear``, ``LogSoftMax``) at 8-16
channels on [2,3,32,32].  The LRNs use alpha 1.0 so that they move the
output.  Log-probs agree to 1e-4: the convolutions sum in another order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import bigdl_tpu.nn as jnn
from bigdl_tpu.models.inception import build_inception_v1 as jax_build_v1
from bigdl_tpu.models.inception import inception_layer_v1 as jax_layer_v1
from bigdl_tpu.nn.module import state_dict as jax_state_dict
from bigdl_tpu.serving.buckets import BucketPolicy as JaxBucketPolicy
from bigdl_tpu.serving.executor import BucketedExecutor as JaxExecutor
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.models.inception import build_inception_v1
from bigdl_tpu_torch.models.inception import inception_layer_v1
from bigdl_tpu_torch.serving import BucketedExecutor, BucketPolicy
from bigdl_tpu_torch.utils.convert import from_jax_state


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: at these tiny shapes PyTorch's CPU thread
    pool costs more than it gives (its first parallel regions of each
    op take tenths of a second beside JAX's threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def narrow_inception(nn, layer_v1):
    """The narrow model, from one package's public classes."""
    return nn.Sequential(
        nn.SpatialConvolution(3, 8, 7, 7, 2, 2, 3, 3).set_name("conv1/7x7_s2"),
        nn.ReLU(True),
        nn.SpatialMaxPooling(3, 3, 2, 2).ceil(),
        nn.SpatialCrossMapLRN(5, 1.0, 0.75).set_name("pool1/norm1"),
        nn.SpatialConvolution(8, 8, 1, 1, 1, 1).set_name("conv2/3x3_reduce"),
        nn.ReLU(True),
        nn.SpatialConvolution(8, 16, 3, 3, 1, 1, 1, 1).set_name("conv2/3x3"),
        nn.ReLU(True),
        nn.SpatialCrossMapLRN(5, 1.0, 0.75).set_name("conv2/norm2"),
        nn.SpatialMaxPooling(3, 3, 2, 2).ceil(),
        layer_v1(16, [[4], [4, 8], [2, 4], [4]], "inception_3a/"),
        nn.SpatialAveragePooling(4, 4, 1, 1),
        nn.View(20).set_num_input_dims(3),
        nn.Linear(20, 10).set_name("loss3/classifier"),
        nn.LogSoftMax())


def copied_pair():
    """(JAX model, port model) with the JAX model's weights in both."""
    jmodel = narrow_inception(jnn, jax_layer_v1)
    tmodel = narrow_inception(tnn, inception_layer_v1)
    state = {k: np.asarray(v) for k, v in jax_state_dict(jmodel).items()}
    tnn.load_state_dict(tmodel, from_jax_state(state, "cpu", tmodel))
    return jmodel, tmodel


@pytest.mark.parametrize("bf16", [False, True])
def test_executor_matches_jax_executor(bf16):
    jmodel, tmodel = copied_pair()
    x = np.random.RandomState(0).randn(3, 3, 32, 32).astype(np.float32)
    # one JAX executable (bucket 4) against the port's buckets 2 and 1
    jex = JaxExecutor(jmodel, policy=JaxBucketPolicy(batch_buckets=[4]),
                      compute_dtype=jnp.bfloat16 if bf16 else None)
    tex = BucketedExecutor(tmodel, policy=BucketPolicy(batch_buckets=[1, 2]),
                           compute_dtype=torch.bfloat16 if bf16 else None,
                           device="cpu")
    want = jex.run(x)
    got = np.concatenate([tex.run(x[:2]), tex.run(x[2:])])
    assert got.shape == want.shape == (3, 10)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.exp(got).sum(1), 1.0, atol=1e-5)


def test_bf16_state_is_rounded_and_compute_stays_f32():
    _, tmodel = copied_pair()
    ex = BucketedExecutor(tmodel, compute_dtype=torch.bfloat16, device="cpu")
    w = tmodel.get(0).weight
    assert ex.state["0.weight"].dtype == torch.bfloat16
    assert torch.equal(ex.state["0.weight"], w.to(torch.bfloat16))
    out = ex.forward(torch.zeros(1, 3, 32, 32))
    assert out.dtype == torch.float32


def test_full_width_state_keys_and_shapes_match():
    jstate = jax_state_dict(jax_build_v1())
    tstate = tnn.state_dict(build_inception_v1())
    assert len(tstate) == 116
    assert sum(v.numel() for v in tstate.values()) == 6998552
    assert {k: tuple(v.shape) for k, v in tstate.items()} \
        == {k: tuple(v.shape) for k, v in jstate.items()}


@pytest.mark.slow
def test_full_width_inception_v1_batch1_matches_jax():
    jmodel = jax_build_v1()
    tmodel = build_inception_v1()
    state = {k: np.asarray(v) for k, v in jax_state_dict(jmodel).items()}
    tnn.load_state_dict(tmodel, from_jax_state(state, "cpu", tmodel))
    x = np.random.RandomState(0).randn(1, 3, 224, 224).astype(np.float32)
    want = np.asarray(jmodel.evaluate().forward(jnp.asarray(x)))
    with torch.no_grad():
        got = tmodel.evaluate()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 1000)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # seeded random weights leave the log-probs within ~0.1 of -log(1000):
    # hold the spread around their mean too, at 1e-4 of its size
    spread = float(np.ptp(want))
    np.testing.assert_allclose(got - got.mean(), want - want.mean(),
                               rtol=0, atol=1e-4 * spread)
