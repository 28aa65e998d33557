"""Model-zoo shape/loss tests (the reference's ``models/`` specs,
SURVEY §4 'models/ (7: model graphs produce expected shapes/loss)')."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import bigdl_tpu.nn as nn
from bigdl_tpu import models
from bigdl_tpu.nn.module import functional_call, state_dict


def _check_train_step(model, x_shape, n_classes, rtol_loss=0.6):
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=x_shape).astype(np.float32))
    y = jnp.asarray(rng.integers(0, n_classes, x_shape[0]))
    crit = nn.ClassNLLCriterion()
    p = state_dict(model)

    def loss_fn(p):
        out, _ = functional_call(model, p, x, training=True,
                                 rng=jax.random.key(0))
        return crit.update_output(out, y)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(p)
    expected = np.log(n_classes)
    assert abs(float(loss) - expected) < rtol_loss * expected, float(loss)
    gnorm = sum(float(jnp.sum(jnp.abs(g))) for g in grads.values())
    assert gnorm > 0


def test_lenet5():
    m = models.build_lenet5(10)
    out = m.forward(jnp.ones((2, 28 * 28)))
    assert out.shape == (2, 10)
    _check_train_step(m, (4, 1, 28, 28), 10)


def test_vgg_cifar():
    m = models.build_vgg_for_cifar10(10)
    out = m.evaluate().forward(jnp.ones((2, 3, 32, 32)))
    assert out.shape == (2, 10)


def test_inception_v1():
    m = models.build_inception_v1(1000)
    out = m.evaluate().forward(jnp.ones((2, 3, 224, 224)))
    assert out.shape == (2, 1000)


def test_inception_v1_aux():
    m = models.build_inception_v1(100, with_aux=True)
    outs = m.evaluate().forward(jnp.ones((1, 3, 224, 224)))
    assert isinstance(outs, list) and len(outs) == 3
    for o in outs:
        assert o.shape == (1, 100)


def test_inception_v2():
    m = models.build_inception_v2(1000)
    out = m.evaluate().forward(jnp.ones((1, 3, 224, 224)))
    assert out.shape == (1, 1000)


@pytest.mark.parametrize("depth,block_out", [(18, 512), (50, 2048)])
def test_resnet_imagenet(depth, block_out):
    m = models.build_resnet(depth, 1000)
    out = m.evaluate().forward(jnp.ones((1, 3, 224, 224)))
    assert out.shape == (1, 1000)


def test_resnet_cifar_shortcut_a():
    m = models.build_resnet_cifar(20, 10, shortcut_type="A")
    out = m.evaluate().forward(jnp.ones((2, 3, 32, 32)))
    assert out.shape == (2, 10)
    _check_train_step(m.train(), (2, 3, 32, 32), 10)


def test_simple_rnn_and_lstm_classifier():
    m = models.build_simple_rnn(100, 16, 100)
    out = m.forward(jnp.ones((2, 5, 100)))
    assert out.shape == (2, 5, 100)
    clf = models.build_lstm_classifier(vocab_size=50, embed_dim=8,
                                       hidden_size=12, class_num=3)
    tokens = jnp.asarray(np.random.randint(0, 50, (4, 7)))
    out = clf.forward(tokens)
    assert out.shape == (4, 3)


def test_autoencoder_trains():
    m = models.build_autoencoder(32)
    x = jnp.asarray(np.random.rand(8, 784).astype(np.float32))
    out = m.forward(x)
    assert out.shape == (8, 784)
    crit = nn.MSECriterion()
    p = state_dict(m)

    def loss_fn(p):
        out, _ = functional_call(m, p, x)
        return crit.update_output(out, x)

    l0 = float(loss_fn(p))
    g = jax.grad(loss_fn)(p)
    p2 = {k: p[k] - 0.5 * g[k] for k in p}
    assert float(loss_fn(p2)) < l0


def test_transformer_lm_forward_and_shapes():
    import numpy as np

    from bigdl_tpu import models
    from bigdl_tpu.utils.rng import RNG

    RNG.set_seed(0)
    lm = models.build_transformer_lm(vocab_size=50, num_layers=2,
                                     embed_dim=32, num_heads=4, max_len=16,
                                     backend="dense")
    tokens = np.random.RandomState(0).randint(0, 50, (2, 12))
    out = lm.forward(tokens)
    assert out.shape == (2, 12, 50)
    # log-probs normalize over vocab
    import jax.numpy as jnp

    np.testing.assert_allclose(np.asarray(jnp.exp(out).sum(-1)), 1.0,
                               rtol=1e-4)


def test_transformer_lm_trains_with_sequence_parallel_mesh():
    import jax
    import numpy as np

    import bigdl_tpu.nn as nn
    import bigdl_tpu.optim as optim
    from bigdl_tpu import models
    from bigdl_tpu.parallel.mesh import make_mesh
    from bigdl_tpu.parallel.train_step import TrainStep
    from bigdl_tpu.utils.rng import RNG

    RNG.set_seed(1)
    mesh = make_mesh((8,), ("seq",))
    lm = models.build_transformer_lm(vocab_size=32, num_layers=1,
                                     embed_dim=16, num_heads=2, max_len=32,
                                     sp_mesh=mesh)
    crit = nn.TimeDistributedCriterion(nn.ClassNLLCriterion(), size_average=True)
    step = TrainStep(lm, crit, optim.SGD(learning_rate=0.5))
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, 32, (4, 32))
    # learn to echo the input (predict current token) — learnable fast
    losses = [float(step.run(tokens, tokens, jax.random.key(i)))
              for i in range(8)]
    assert losses[-1] < losses[0]


def test_cli_perf_sequence_models(capsys):
    """ADVICE r1: cmd_perf must feed token-shaped data to lstm/transformer."""
    from bigdl_tpu.models import cli

    cli.main(["perf", "--model", "lstm", "-b", "2", "-i", "1",
              "--warmup", "1", "--no-bf16"])
    assert "records/sec" in capsys.readouterr().out
    cli.main(["perf", "--model", "transformer", "-b", "2", "-i", "1",
              "--warmup", "1", "--no-bf16"])
    assert "records/sec" in capsys.readouterr().out


def test_cli_token_data_shapes():
    from bigdl_tpu.models import cli

    x, y = cli._load_data("lstm", None, "train")
    assert x.ndim == 2 and x.dtype.kind == "i" and len(x) == len(y)
    xt, yt = cli._load_data("transformer", None, "test")
    assert xt.shape == yt.shape and xt.shape[1] == cli.LM_SEQ_LEN


@pytest.mark.slow
def test_textclassification_example_learns():
    """example/textclassification parity (TextClassifier.scala conv
    stack): the synthetic 5-topic corpus must be learnable."""
    import examples.textclassification as tc

    _, _, _, acc = tc.main(["--max-epoch", "4", "--seq-len", "150",
                            "--synthetic-size", "250", "--batch-size", "16",
                            "--learning-rate", "0.05"])
    assert acc >= 0.7, acc


def test_udfpredictor_example_udf_and_query():
    """example/udfpredictor parity: the predict-UDF query flow (a quick
    1-epoch model — the full training quality is covered by the
    textclassification test above)."""
    import examples.textclassification as tc
    import examples.udfpredictor as up

    model, word_index, table, _ = tc.main(
        ["--max-epoch", "1", "--seq-len", "150",
         "--synthetic-size", "100", "--batch-size", "16"])
    udf = up.make_predict_udf(model, word_index, table, 150)
    rows = [{"id": i, "text": "rocket orbit nasa launch"} for i in range(3)]
    preds = udf([r["text"] for r in rows])
    assert preds.shape == (3,)
    kept, preds2 = up.query(rows, "text", udf, {int(preds[0])})
    assert len(kept) == 3  # identical texts -> identical class
    assert all(r["predicted"] == int(preds[0]) for r in kept)
    kept_none, _ = up.query(rows, "text", udf,
                            {int(preds[0]) + 1000})
    assert kept_none == []
