"""Attention stack tests: Pallas flash kernel vs dense oracle, ring and
Ulysses sequence parallelism on the 8-device CPU mesh, and the nn-level
MultiHeadAttention / TransformerBlock layers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bigdl_tpu.ops import dot_product_attention, flash_attention
from bigdl_tpu.parallel.sequence import make_sequence_parallel_attention


def _rand_qkv(b=2, h=2, s=64, d=16, seed=0, dtype=jnp.float32):
    rng = np.random.RandomState(seed)
    mk = lambda: jnp.asarray(rng.randn(b, h, s, d).astype(np.float32),
                             dtype=dtype)
    return mk(), mk(), mk()


@pytest.mark.parametrize("causal", [False, True])
def test_flash_matches_dense(causal):
    q, k, v = _rand_qkv(s=64)
    out_ref = dot_product_attention(q, k, v, causal=causal)
    out = flash_attention(q, k, v, causal=causal, block_q=16, block_k=16)
    np.testing.assert_allclose(np.asarray(out), np.asarray(out_ref),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_grads_match_dense(causal):
    q, k, v = _rand_qkv(s=32, d=8)

    def loss_dense(q, k, v):
        return jnp.sum(dot_product_attention(q, k, v, causal=causal) ** 2)

    def loss_flash(q, k, v):
        return jnp.sum(flash_attention(q, k, v, causal=causal,
                                       block_q=8, block_k=8) ** 2)

    g_ref = jax.grad(loss_dense, argnums=(0, 1, 2))(q, k, v)
    g = jax.grad(loss_flash, argnums=(0, 1, 2))(q, k, v)
    for a, b in zip(g, g_ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-4)


def test_flash_cross_attention_lengths():
    rng = np.random.RandomState(1)
    q = jnp.asarray(rng.randn(1, 2, 16, 8).astype(np.float32))
    k = jnp.asarray(rng.randn(1, 2, 48, 8).astype(np.float32))
    v = jnp.asarray(rng.randn(1, 2, 48, 8).astype(np.float32))
    out_ref = dot_product_attention(q, k, v, causal=True)
    out = flash_attention(q, k, v, causal=True, block_q=8, block_k=16)
    np.testing.assert_allclose(np.asarray(out), np.asarray(out_ref),
                               rtol=2e-5, atol=2e-5)


@pytest.fixture
def seq_mesh():
    from jax.sharding import Mesh

    devs = np.array(jax.devices()[:8])
    return Mesh(devs, ("seq",))


@pytest.mark.parametrize(
    "strategy", [pytest.param("ring", marks=pytest.mark.slow), "ulysses"])
@pytest.mark.parametrize("causal", [False, True])
def test_sequence_parallel_matches_dense(seq_mesh, strategy, causal):
    # heads divisible by 8 for ulysses; seq sharded 8 ways
    q, k, v = _rand_qkv(b=1, h=8, s=64, d=8, seed=2)
    fn = make_sequence_parallel_attention(seq_mesh, strategy=strategy,
                                          causal=causal)
    out = fn(q, k, v)
    out_ref = dot_product_attention(q, k, v, causal=causal)
    np.testing.assert_allclose(np.asarray(out), np.asarray(out_ref),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.slow
def test_data_x_seq_ring_matches_dense():
    """Ring attention composed with data parallelism on a (data, seq)
    mesh: batch shards over 'data', each data row runs its own k/v ring
    over 'seq' — forward AND gradients must equal dense attention on the
    global arrays (TrainStep differentiates through this form)."""
    from jax.sharding import Mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices (virtual CPU mesh)")
    devs = np.array(jax.devices()[:8]).reshape(2, 4)
    mesh = Mesh(devs, ("data", "seq"))
    q, k, v = _rand_qkv(b=4, h=2, s=32, d=8, seed=6)
    fn = make_sequence_parallel_attention(mesh, strategy="ring",
                                          causal=True, batch_axis="data")
    out = jax.jit(fn)(q, k, v)
    out_ref = dot_product_attention(q, k, v, causal=True)
    np.testing.assert_allclose(np.asarray(out), np.asarray(out_ref),
                               rtol=2e-5, atol=2e-5)
    g = jax.grad(lambda q, k, v: jnp.sum(fn(q, k, v) ** 2),
                 argnums=(0, 1, 2))(q, k, v)
    g_ref = jax.grad(
        lambda q, k, v: jnp.sum(
            dot_product_attention(q, k, v, causal=True) ** 2),
        argnums=(0, 1, 2))(q, k, v)
    for a, b in zip(g, g_ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.slow
def test_ring_attention_differentiable(seq_mesh):
    q, k, v = _rand_qkv(b=1, h=2, s=32, d=8, seed=3)
    fn = make_sequence_parallel_attention(seq_mesh, strategy="ring",
                                          causal=True)

    def loss_sp(q, k, v):
        return jnp.sum(fn(q, k, v) ** 2)

    def loss_ref(q, k, v):
        return jnp.sum(dot_product_attention(q, k, v, causal=True) ** 2)

    g = jax.grad(loss_sp, argnums=(0, 1, 2))(q, k, v)
    g_ref = jax.grad(loss_ref, argnums=(0, 1, 2))(q, k, v)
    for a, b in zip(g, g_ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-4)


def test_ring_attention_jits_under_mesh(seq_mesh):
    """The shard_map'd ring attention must compile inside jit (the form the
    train step uses)."""
    q, k, v = _rand_qkv(b=1, h=2, s=64, d=8, seed=4)
    fn = make_sequence_parallel_attention(seq_mesh, strategy="ring",
                                          causal=True)
    out = jax.jit(fn)(q, k, v)
    out_ref = dot_product_attention(q, k, v, causal=True)
    np.testing.assert_allclose(np.asarray(out), np.asarray(out_ref),
                               rtol=2e-5, atol=2e-5)


def test_multihead_attention_layer():
    import bigdl_tpu.nn as nn
    from bigdl_tpu.nn.module import functional_call, state_dict

    mha = nn.MultiHeadAttention(32, 4, causal=True, backend="dense")
    x = jnp.asarray(np.random.RandomState(5).randn(2, 10, 32),
                    dtype=jnp.float32)
    out = mha.forward(x)
    assert out.shape == (2, 10, 32)

    # functional path + grads flow to all four projections
    params = state_dict(mha, kind="param")

    def loss(p):
        y, _ = functional_call(mha, p, x, training=True)
        return jnp.sum(y ** 2)

    grads = jax.grad(loss)(params)
    assert set(grads) == set(params)
    assert all(np.isfinite(np.asarray(g)).all() for g in grads.values())


def test_mha_flash_backend_matches_dense():
    import bigdl_tpu.nn as nn

    mha = nn.MultiHeadAttention(32, 4, causal=True, backend="dense")
    x = jnp.asarray(np.random.RandomState(6).randn(1, 16, 32),
                    dtype=jnp.float32)
    out_dense = mha.forward(x)
    mha.backend = "flash"
    out_flash = mha.forward(x)
    np.testing.assert_allclose(np.asarray(out_flash), np.asarray(out_dense),
                               rtol=2e-5, atol=2e-5)


def test_transformer_block_trains():
    import bigdl_tpu.nn as nn
    import bigdl_tpu.optim as optim
    from bigdl_tpu.parallel.train_step import TrainStep

    model = nn.Sequential(
        nn.TransformerBlock(16, 2, causal=True, backend="dense"))
    crit = nn.MSECriterion()
    step = TrainStep(model, crit, optim.SGD(learning_rate=0.05))
    rng = np.random.RandomState(7)
    x = rng.randn(4, 8, 16).astype(np.float32)
    y = rng.randn(4, 8, 16).astype(np.float32)
    losses = [float(step.run(x, y, jax.random.PRNGKey(i)))
              for i in range(5)]
    assert losses[-1] < losses[0]


def test_layernorm():
    import bigdl_tpu.nn as nn

    ln = nn.LayerNorm(8)
    x = jnp.asarray(np.random.RandomState(8).randn(3, 8) * 5 + 2,
                    dtype=jnp.float32)
    out = np.asarray(ln.forward(x))
    np.testing.assert_allclose(out.mean(-1), 0.0, atol=1e-5)
    np.testing.assert_allclose(out.std(-1), 1.0, atol=1e-3)


def test_mha_mask_and_dropout():
    import bigdl_tpu.nn as nn

    mha = nn.MultiHeadAttention(16, 2, backend="dense")
    x = jnp.asarray(np.random.RandomState(9).randn(2, 6, 16), jnp.float32)
    mask = jnp.ones((2, 1, 6, 6), bool).at[:, :, :, 3:].set(False)
    out_masked = mha.forward((x, mask))
    out_full = mha.forward(x)
    assert out_masked.shape == (2, 6, 16)
    assert not np.allclose(np.asarray(out_masked), np.asarray(out_full))

    # dropout is live in training mode, off in eval
    mhad = nn.MultiHeadAttention(16, 2, dropout=0.5, backend="dense")
    o1 = mhad.forward(x)
    o2 = mhad.forward(x)
    assert not np.allclose(np.asarray(o1), np.asarray(o2))
    mhad.evaluate()
    e1 = mhad.forward(x)
    e2 = mhad.forward(x)
    np.testing.assert_allclose(np.asarray(e1), np.asarray(e2))


def test_fused_qkv_matches_separate_projections():
    """Self-attention takes the fused [E,3E] projection path; feeding the
    same VALUES as distinct (q, k, v) objects takes the separate-GEMM
    path — both must agree, and the fused path's gradients must land in
    the separate q/k/v parameters."""
    import bigdl_tpu.nn as nn
    from bigdl_tpu.utils.rng import RNG

    RNG.set_seed(21)
    mha = nn.MultiHeadAttention(24, 4, causal=True).evaluate()
    x = jnp.asarray(np.random.RandomState(0).randn(2, 6, 24)
                    .astype(np.float32))
    fused = np.asarray(mha.forward(x))
    apart = np.asarray(mha.forward((x, x + 0.0, x + 0.0)))
    np.testing.assert_allclose(fused, apart, rtol=1e-5, atol=1e-6)

    mha.training_mode()
    mha.zero_grad_parameters()
    gy = jnp.asarray(np.random.RandomState(1).randn(2, 6, 24)
                     .astype(np.float32))
    mha.backward(x, gy)
    for proj in (mha.q_proj, mha.k_proj, mha.v_proj):
        g = np.asarray(proj._grads["weight"])
        assert np.abs(g).max() > 0, "fused path left a projection gradient-free"


def test_auto_backend_threshold_routing(monkeypatch):
    """backend='auto' must route by max(Sq, Sk) against flash_min_seq
    (default 512 after the round-5 block-size sweep flipped the
    decision) — and always dense off-TPU."""
    import bigdl_tpu.ops as O
    import bigdl_tpu.ops.attention as A

    calls = []
    real_dense = A.dot_product_attention

    def spy_flash(q, k, v, **kw):
        calls.append("flash")
        return real_dense(q, k, v, causal=kw.get("causal", False),
                          scale=kw.get("scale"))

    def spy_dense(q, k, v, **kw):
        calls.append("dense")
        return real_dense(q, k, v, **kw)

    # the layer lazily does `from bigdl_tpu.ops import ...` for the
    # kernels and `from bigdl_tpu.ops.attention import ...` for the
    # gate — patch both namespaces
    monkeypatch.setattr(O, "flash_attention", spy_flash)
    monkeypatch.setattr(O, "dot_product_attention", spy_dense)
    import numpy as np

    rng = np.random.default_rng(0)

    def run(seq, tpu):
        calls.clear()
        monkeypatch.setattr(A, "is_tpu_device", lambda: tpu)
        import bigdl_tpu.nn as nn
        mha = nn.MultiHeadAttention(16, 2, causal=True, backend="auto")
        x = jnp.asarray(rng.normal(size=(1, seq, 16)).astype(np.float32))
        mha.forward(x)
        return calls[-1] if calls else "dense"

    assert run(512, tpu=True) == "flash"    # at the threshold: flash
    assert run(256, tpu=True) == "dense"    # below: dense (no spy call)
    assert run(512, tpu=False) == "dense"   # off-TPU: always dense
