"""int8 post-training quantization (the reference's bigquant capability,
``spark/dl/pom.xml:85-90``): QuantizedLinear / QuantizedSpatialConvolution
numeric closeness to their float twins, quantize() tree walk, BTPU
round-trip, and int8 dtype discipline."""

import numpy as np
import pytest

import bigdl_tpu.nn as nn
from bigdl_tpu.nn.module import state_dict
from bigdl_tpu.nn.quantized import (QuantizedLinear,
                                    QuantizedSpatialConvolution, quantize)
from bigdl_tpu.utils.rng import RNG


def _rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)


def test_quantized_linear_close_to_float():
    RNG.set_seed(40)
    m = nn.Linear(64, 32)
    x = np.random.RandomState(0).randn(16, 64).astype(np.float32)
    want = np.asarray(m.evaluate().forward(x))
    q = QuantizedLinear.from_float(m)
    got = np.asarray(q.forward(x))
    # int8 symmetric quantization: ~1% relative error at these shapes
    assert _rel_err(got, want) < 0.02, _rel_err(got, want)
    assert np.asarray(q.weight_q).dtype == np.int8
    assert state_dict(q, kind="param") == {}  # inference-only


def test_quantized_conv_close_to_float():
    RNG.set_seed(41)
    m = nn.SpatialConvolution(8, 16, 3, 3, 2, 2, 1, 1)
    x = np.random.RandomState(1).randn(4, 8, 14, 14).astype(np.float32)
    want = np.asarray(m.evaluate().forward(x))
    q = QuantizedSpatialConvolution.from_float(m)
    got = np.asarray(q.forward(x))
    assert got.shape == want.shape
    assert _rel_err(got, want) < 0.03, _rel_err(got, want)


def test_quantized_grouped_and_same_pad_conv():
    RNG.set_seed(42)
    m = nn.SpatialConvolution(8, 16, 3, 3, 1, 1, -1, -1, n_group=4)
    x = np.random.RandomState(2).randn(2, 8, 10, 10).astype(np.float32)
    want = np.asarray(m.evaluate().forward(x))
    got = np.asarray(QuantizedSpatialConvolution.from_float(m).forward(x))
    assert got.shape == want.shape
    assert _rel_err(got, want) < 0.03


def test_quantize_walk_preserves_model_accuracy():
    """quantize(model) on a trained classifier: predictions match the
    float model on nearly every sample (the bigquant acceptance bar)."""
    import bigdl_tpu.optim as optim
    from bigdl_tpu.dataset.sample import Sample

    RNG.set_seed(43)
    rng = np.random.RandomState(3)
    x = rng.randn(128, 8).astype(np.float32)
    y = (x[:, 0] + x[:, 1] > 0).astype(np.int64)
    samples = [Sample(x[i], y[i]) for i in range(128)]
    model = nn.Sequential(nn.Linear(8, 32), nn.ReLU(),
                          nn.Linear(32, 2), nn.LogSoftMax())
    o = optim.LocalOptimizer(model, samples, nn.ClassNLLCriterion(),
                             batch_size=32,
                             end_trigger=optim.Trigger.max_epoch(10))
    o.set_optim_method(optim.SGD(learning_rate=0.5))
    o.optimize()
    float_pred = np.asarray(model.evaluate().forward(x)).argmax(1)

    qmodel = quantize(model)
    assert isinstance(qmodel.get(0), QuantizedLinear)
    assert isinstance(qmodel.get(2), QuantizedLinear)
    q_pred = np.asarray(qmodel.forward(x)).argmax(1)
    assert (q_pred == float_pred).mean() >= 0.98


def test_quantized_btpu_roundtrip(tmp_path):
    from bigdl_tpu.utils.serializer import load_module, save_module

    RNG.set_seed(44)
    model = quantize(nn.Sequential(
        nn.SpatialConvolution(3, 4, 3, 3, 1, 1, 1, 1),
        nn.ReLU(), nn.Reshape([4 * 6 * 6]), nn.Linear(4 * 6 * 6, 5)))
    x = np.random.RandomState(4).randn(2, 3, 6, 6).astype(np.float32)
    want = np.asarray(model.forward(x))
    path = str(tmp_path / "q.btpu")
    save_module(model, path)
    back = load_module(path)
    assert np.asarray(back.get(0).weight_q).dtype == np.int8
    np.testing.assert_allclose(np.asarray(back.evaluate().forward(x)),
                               want, rtol=1e-6, atol=1e-6)


def test_quantized_weight_memory_shrinks():
    RNG.set_seed(45)
    m = nn.Linear(256, 256)
    q = QuantizedLinear.from_float(m)
    fbytes = np.asarray(m.weight).nbytes
    qbytes = np.asarray(q.weight_q).nbytes + np.asarray(q.w_scale).nbytes
    assert qbytes < fbytes / 3.5  # ~4x smaller


def test_calibrated_scales_drop_the_amax_reduce():
    """BASELINE.md round-6 fix: after calibrate() the activation scale
    is a trace CONSTANT — the per-call global amax reduce (a full extra
    activation read and a fusion barrier) is gone from the program."""
    import jax

    from bigdl_tpu.nn.module import functional_call, state_dict
    from bigdl_tpu.nn.quantized import calibrate

    RNG.set_seed(50)
    x = np.random.RandomState(5).randn(4, 3, 12, 12).astype(np.float32)
    q = quantize(nn.Sequential(
        nn.SpatialConvolution(3, 8, 3, 3, 1, 1, 1, 1), nn.ReLU(),
        nn.SpatialConvolution(8, 16, 3, 3, 2, 2, 1, 1)))

    def jaxpr_of(model):
        state = state_dict(model)
        return str(jax.make_jaxpr(
            lambda s, xx: functional_call(model, s, xx,
                                          training=False)[0])(state, x))

    assert "reduce_max" in jaxpr_of(q)  # dynamic path: the barrier
    calibrate(q, [x])
    assert "reduce_max" not in jaxpr_of(q)
    for m in q.modules():
        if hasattr(m, "act_scale"):
            assert m.act_scale is not None and m.act_scale > 0


def test_calibrated_numerics_close_to_float_and_match_dynamic():
    from bigdl_tpu.nn.quantized import calibrate

    RNG.set_seed(51)
    m = nn.Sequential(nn.SpatialConvolution(3, 8, 3, 3, 1, 1, 1, 1),
                      nn.ReLU(), nn.Reshape([8 * 10 * 10]),
                      nn.Linear(8 * 10 * 10, 5))
    x = np.random.RandomState(6).randn(4, 3, 10, 10).astype(np.float32)
    want = np.asarray(m.evaluate().forward(x))
    q = quantize(m)
    dyn = np.asarray(q.forward(x))
    calibrate(q, [x])
    stat = np.asarray(q.forward(x))
    # calibrated on this very batch the scales agree exactly, so the
    # static path must reproduce the dynamic path bit-for-bit
    np.testing.assert_array_equal(stat, dyn)
    assert _rel_err(stat, want) < 0.03
    # traffic hotter than the calibration set clips instead of blowing
    # up (the documented saturation semantics)
    hot = np.asarray(q.forward(x * 10.0))
    assert np.isfinite(hot).all()


def test_calibrate_rejects_unquantized_and_empty():
    from bigdl_tpu.nn.quantized import calibrate

    RNG.set_seed(52)
    with pytest.raises(ValueError, match="no quantized"):
        calibrate(nn.Sequential(nn.Linear(4, 2)), [np.zeros((1, 4))])
    q = quantize(nn.Sequential(nn.Linear(4, 2)))
    with pytest.raises(ValueError, match="empty"):
        calibrate(q, [])


def test_calibrated_scale_survives_btpu_roundtrip(tmp_path):
    from bigdl_tpu.nn.quantized import calibrate
    from bigdl_tpu.utils.serializer import load_module, save_module

    RNG.set_seed(53)
    x = np.random.RandomState(7).randn(2, 8).astype(np.float32)
    q = calibrate(quantize(nn.Sequential(nn.Linear(8, 4))), [x])
    scale = q.get(0).act_scale
    path = str(tmp_path / "qc.btpu")
    save_module(q, path)
    back = load_module(path)
    assert back.get(0).act_scale == scale
    np.testing.assert_allclose(np.asarray(back.evaluate().forward(x)),
                               np.asarray(q.forward(x)), rtol=1e-6)


@pytest.mark.slow
def test_int8_calibrated_inception_bytes_not_worse_than_bf16():
    """The serving-PR acceptance on the round-6 regression, verified by
    the attribution byte counts (XLA cost analysis of the lowered
    forward — CPU works, no TPU needed): calibrated int8 inception must
    move NO MORE bytes than the bf16 forward at equal flops.  The old
    dynamic path moved ~1.15x bf16 (measured: the per-conv amax reduce
    + quantize/dequant extra passes), which is exactly why int8 ran
    0.62x bf16 end-to-end on v5e."""
    import jax
    import jax.numpy as jnp

    from bigdl_tpu.models import registry
    from bigdl_tpu.nn.module import functional_call, state_dict
    from bigdl_tpu.nn.quantized import calibrate
    from bigdl_tpu.telemetry.device import normalize_cost_analysis

    x = np.random.RandomState(8).randn(2, 3, 224, 224).astype(np.float32)

    def fwd_bytes(model, cdt=None):
        state = state_dict(model)

        def fwd(s, xx):
            if cdt is not None:
                s = {k: (v.astype(cdt)
                         if jnp.issubdtype(v.dtype, jnp.floating) else v)
                     for k, v in s.items()}
                xx = xx.astype(cdt)
            return functional_call(model, s, xx, training=False)[0]

        compiled = jax.jit(fwd).lower(state, jnp.asarray(x)).compile()
        cost = normalize_cost_analysis(compiled.cost_analysis())
        return float(cost.get("bytes accessed") or 0)

    RNG.set_seed(54)
    bf16_bytes = fwd_bytes(registry.build_model("inception_v1").evaluate(),
                           jnp.bfloat16)
    RNG.set_seed(54)
    q = quantize(registry.build_model("inception_v1").evaluate())
    calibrate(q, [x])
    int8_bytes = fwd_bytes(q)
    assert bf16_bytes > 0 and int8_bytes > 0
    assert int8_bytes <= bf16_bytes, (
        f"calibrated int8 moves {int8_bytes / bf16_bytes:.3f}x the "
        f"bf16 bytes — the round-6 regression is back")


def test_quantize_subclass_dispatch(caplog):
    """isinstance-style dispatch (ADVICE r4): a math-identical subclass
    (SpatialShareConvolution) quantizes as its base; a subclass that
    overrides the forward math (the space-to-depth masked conv) is left
    float WITH a warning, never silently skipped or mis-converted."""
    import logging

    from bigdl_tpu.nn.fuse import _MaskedStride1Conv

    RNG.set_seed(0)
    share = nn.SpatialShareConvolution(3, 8, 3, 3)
    assert isinstance(quantize(share), QuantizedSpatialConvolution)

    RNG.set_seed(0)
    masked = _MaskedStride1Conv(3, 8, 3, 3)
    with caplog.at_level(logging.WARNING, logger="bigdl_tpu"):
        out = quantize(masked)
    assert out is masked  # unchanged
    assert any("overrides its forward math" in r.message
               for r in caplog.records)
