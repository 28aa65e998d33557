"""Each ported layer against its JAX layer, on weights copied by key.

Inputs come from a numpy seed; the JAX layer runs eagerly on the CPU
(its default legs), the port's layer on CPU tensors, both in f32.
Tolerances: 1e-5 relative for the elementwise and pooling layers (the
same terms in the same order); 1e-4 for convolution and linear, whose
dot products XLA and PyTorch sum in different orders.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bigdl_tpu.nn as jnn
from bigdl_tpu.nn.module import state_dict as jax_state_dict
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.utils.convert import from_jax_state
from test_torch_slice import one_thread  # noqa: F401


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _check(jax_layer, torch_layer, x, rtol, atol=1e-6):
    """Copy the JAX layer's weights into the port's layer by key, run
    both in eval mode on ``x`` and compare."""
    state = {k: np.asarray(v) for k, v in jax_state_dict(jax_layer).items()}
    tnn.load_state_dict(torch_layer, from_jax_state(state, "cpu", torch_layer))
    # jitted: eager dispatch compiles every small op on its own
    want = np.asarray(jax.jit(jax_layer.evaluate().forward)(jnp.asarray(x)))
    with torch.no_grad():
        got = torch_layer.evaluate()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    return got


@pytest.mark.parametrize("args,shape", [
    ((3, 4, 3, 3, 1, 1, 1, 1), (2, 3, 9, 9)),
    ((3, 5, 7, 7, 2, 2, 3, 3), (1, 3, 16, 15)),      # the stem's geometry
    ((4, 6, 3, 3, 2, 2, -1, -1), (2, 4, 8, 8)),     # SAME, asymmetric pads
    ((4, 6, 3, 1, 1, 1, 0, 0, 2), (2, 4, 6, 5)),    # n_group 2
])
def test_spatial_convolution(args, shape):
    _check(jnn.SpatialConvolution(*args), tnn.SpatialConvolution(*args),
           _x(shape), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("args,shape", [
    ((2, 2, 2, 2), (1, 2, 7, 7)),           # odd size, ceil overflow of 1
    ((3, 3, 2, 2), (2, 3, 9, 8)),           # odd H exact, even W overflows
    ((3, 3, 2, 2, 1, 1), (1, 2, 10, 11)),   # declared pad plus overflow
    ((2, 2, 2, 2, 1, 1), (1, 2, 11, 11)),   # last window must start inside
    ((3, 3, 1, 1, 1, 1), (2, 4, 5, 5)),     # the inception pool branch
])
def test_spatial_max_pooling_ceil(args, shape):
    _check(jnn.SpatialMaxPooling(*args).ceil(),
           tnn.SpatialMaxPooling(*args).ceil(), _x(shape, 1), rtol=1e-5)


def test_spatial_max_pooling_floor_and_3d_input():
    _check(jnn.SpatialMaxPooling(3, 3, 2, 2), tnn.SpatialMaxPooling(3, 3, 2, 2),
           _x((3, 9, 8), 2), rtol=1e-5)


@pytest.mark.parametrize("kwargs,shape", [
    (dict(kw=7, kh=7, dw=1, dh=1), (2, 4, 7, 7)),                 # the head
    (dict(kw=5, kh=5, dw=3, dh=3, ceil_mode=True), (1, 3, 14, 14)),
    (dict(kw=3, kh=3, dw=2, dh=2, pad_w=1, pad_h=1, ceil_mode=True),
     (1, 2, 10, 11)),
    (dict(kw=3, kh=3, dw=2, dh=2, pad_w=1, pad_h=1, ceil_mode=True,
          count_include_pad=False), (1, 2, 10, 11)),
    (dict(kw=1, kh=1, global_pooling=True), (2, 3, 5, 6)),
    (dict(kw=2, kh=2, divide=False), (1, 2, 6, 6)),
])
def test_spatial_average_pooling(kwargs, shape):
    _check(jnn.SpatialAveragePooling(**kwargs),
           tnn.SpatialAveragePooling(**kwargs), _x(shape, 3), rtol=1e-5)


@pytest.mark.parametrize("shape", [(2, 7, 5, 5), (6, 4, 3), (1, 6, 2, 3, 3)])
def test_spatial_cross_map_lrn(shape):
    # 4-D, 3-D (squeezed batch) and the rank-5 generic branch
    _check(jnn.SpatialCrossMapLRN(5, 1.0, 0.75, 2.0),
           tnn.SpatialCrossMapLRN(5, 1.0, 0.75, 2.0), _x(shape, 4), rtol=1e-5)


def test_concat():
    def build(nn):
        return nn.Concat(1).add(nn.SpatialConvolution(3, 2, 1, 1)) \
            .add(nn.SpatialConvolution(3, 4, 3, 3, 1, 1, 1, 1))

    _check(build(jnn), build(tnn), _x((2, 3, 5, 5), 5), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("shape", [(1, 8, 1, 1), (3, 8, 1, 1), (8, 1, 1)])
def test_view_keeps_the_batch_axis(shape):
    got = _check(jnn.View(8).set_num_input_dims(3),
                 tnn.View(8).set_num_input_dims(3), _x(shape, 6), rtol=0)
    assert got.shape == ((shape[0], 8) if len(shape) == 4 else (8,))


@pytest.mark.parametrize("shape", [(4, 6), (6,)])
def test_linear(shape):
    _check(jnn.Linear(6, 5), tnn.Linear(6, 5), _x(shape, 7), rtol=1e-4,
           atol=1e-5)


def test_log_softmax_relu_and_eval_dropout():
    x = _x((3, 10), 8)
    _check(jnn.LogSoftMax(), tnn.LogSoftMax(), x, rtol=1e-5)
    _check(jnn.ReLU(True), tnn.ReLU(True), x, rtol=0)
    _check(jnn.Dropout(0.4), tnn.Dropout(0.4), x, rtol=0)


# ---------------------------------------------------------------------------
# initialization methods (random draws differ between the packages'
# generators: held by their bounds and moments, and by reproducing from a
# seed; the deterministic methods equal the JAX package's)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,args", [
    ("Zeros", None), ("Ones", None), ("ConstInitMethod", (0.25,)),
    ("BilinearFiller", ()),
])
def test_deterministic_init_equals_jax(name, args):
    from bigdl_tpu.nn import init as jinit
    from bigdl_tpu_torch.nn import init as tinit

    jm, tm = ((getattr(jinit, name), getattr(tinit, name)) if args is None
              else (getattr(jinit, name)(*args), getattr(tinit, name)(*args)))
    for shape in ((4, 3), (2, 3, 4, 5), (1, 1, 3, 3)):
        got = tm.init(shape, generator=torch.Generator().manual_seed(0))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), jm.init(shape))


@pytest.mark.parametrize("name,args,fans,check", [
    ("RandomUniform", (), (64, None), ("uniform", 1 / 8.0)),
    ("RandomUniform", (-0.3, 0.2), (None, None), ("uniform", (-0.3, 0.2))),
    ("RandomNormal", (0.5, 2.0), (None, None), ("normal", (0.5, 2.0))),
    ("Xavier", None, (64, 32), ("uniform", (6.0 / 96) ** 0.5)),
    ("MsraFiller", (), (64, 32), ("normal", (0.0, (2.0 / 64) ** 0.5))),
    ("MsraFiller", (True,), (64, 32), ("normal", (0.0, (2.0 / 48) ** 0.5))),
])
def test_random_init_draws_from_its_rule_and_generator(name, args, fans,
                                                       check):
    from bigdl_tpu_torch.nn import init as tinit

    m = getattr(tinit, name) if args is None else getattr(tinit, name)(*args)
    shape = (200, 400)

    def draw(seed):
        return m.init(shape, *fans,
                      generator=torch.Generator().manual_seed(seed))

    a = draw(3)
    assert a.dtype == torch.float32 and tuple(a.shape) == shape
    assert torch.equal(a, draw(3)) and not torch.equal(a, draw(4))
    kind, params = check
    if kind == "uniform":
        lo, hi = params if isinstance(params, tuple) else (-params, params)
        assert lo <= a.min().item() and a.max().item() <= hi
        assert abs(a.mean().item() - (lo + hi) / 2) < 0.01 * (hi - lo)
        assert abs(a.std().item() - (hi - lo) / 12 ** 0.5) \
            < 0.01 * (hi - lo)
    else:
        mean, std = params
        assert abs(a.mean().item() - mean) < 0.02 * std
        assert abs(a.std().item() - std) < 0.02 * std
