"""The port's max-pool kernels' plain versions (tie-split and argmax
index) against the JAX package, the layer's routing, the narrow
Inception-v1 training step in both max-pool modes, and the out-of-range
index rule of ``LookupTable`` and ``ClassNLLCriterion``.

On the CPU every wrapper runs its plain version; ``chip_smoke.py`` holds
the CUDA kernels to these plain versions bit for bit on the card.
Inputs come from numpy seeds.  Tolerances: tie-split f32 values and
gradients agree exactly with the JAX XLA leg and with the Pallas kernels
in interpret mode (all three divide and sum the same terms in the same
order in f32); argmax-mode bf16 values, indices and gradients bit for
bit (the gradients are drawn from powers of two, so every sum is exact
in bf16); the training steps as in ``test_torch_train.py``.  The JAX
results are jitted, the geometries of a fixture in one compile, to keep
the file cheap.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

import bigdl_tpu.nn as jnn
import bigdl_tpu.optim as joptim
from bigdl_tpu.ops import pool_pallas as jpool
from bigdl_tpu.ops import pooling_pallas as jpooling
from bigdl_tpu.parallel.train_step import TrainStep as JaxTrainStep
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch import ops
from bigdl_tpu_torch.models import cli
from bigdl_tpu_torch.nn.layers import pooling as tpooling_layer
from bigdl_tpu_torch.ops import _build, pool, pooling
from bigdl_tpu_torch.optim import SGD
from bigdl_tpu_torch.parallel import TrainStep
from bigdl_tpu_torch.utils.convert import to_numpy_state
from test_kernels import POOL_CASES
from test_pooling_pallas import CASES, _pow2_grads
from test_torch_attention import _cuda_typed
from test_torch_slice import copied_pair, one_thread  # noqa: F401


def _full(k, s, p):
    return ((1, 1) + tuple(k), (1, 1) + tuple(s), ((0, 0), (0, 0)) + tuple(p))


def _x(shape, seed, tie_heavy=False):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    # quantized activations force equal maxima inside windows
    return np.round(x * 2.0) / 2.0 if tie_heavy else x


def _bits_equal(got: torch.Tensor, want) -> None:
    """Equal values, NaN where NaN (the sign of a zero is not compared:
    the JAX packed forward returns +0.0 for a winning -0.0)."""
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def _port_tie(x, dims, strides, pads, gy):
    xt = torch.from_numpy(x).requires_grad_()
    y = pool.maxpool_tie_split(xt, dims, strides, pads)
    (dx,) = torch.autograd.grad(y, xt, torch.from_numpy(gy))
    return y.detach(), dx


def _jax_vjp(fn, x, gy):
    """``fn(x)`` and its VJP at ``gy``, compiled as one jitted function
    (eager dispatch compiles every small op on its own and costs
    several times more here)."""
    def both(a, g):
        y, vjp = jax.vjp(fn, a)
        return y, vjp(g)[0]

    y, dx = jax.jit(both)(x, gy)
    return np.asarray(y, np.float32), np.asarray(dx, np.float32)


def _jax_tie(x, dims, strides, pads, gy):
    return _jax_vjp(lambda a: jpool.maxpool_tie_split(a, dims, strides, pads),
                    jnp.asarray(x), jnp.asarray(gy))


# ---------------------------------------------------------------------------
# tie-split: the plain versions against maxpool_tie_split
# ---------------------------------------------------------------------------

TIE_PARAMS = [(i, tie) for i in range(len(POOL_CASES)) for tie in (False, True)]


def _jit_all(jobs, arrays):
    """``{key: fn(*arrays[key])}`` for ``jobs = {key: fn}``, all in one
    jitted call: each small jit costs about 0.1 s of its own here, several
    times the work of one geometry."""
    out = jax.jit(lambda a: {k: fn(*a[k]) for k, fn in jobs.items()})(
        {k: tuple(map(jnp.asarray, v)) for k, v in arrays.items()})
    return {k: tuple(np.asarray(r, np.float32)
                     if jnp.issubdtype(r.dtype, jnp.floating)
                     else np.asarray(r) for r in v) for k, v in out.items()}


def _vjp_of(fn):
    """``(x, gy) -> (fn(x), vjp at gy)``."""
    def both(a, g):
        y, vjp = jax.vjp(fn, a)
        return y, vjp(g)[0]
    return both


@pytest.fixture(scope="module")
def tie_refs():
    """The JAX XLA leg's y and dx for every POOL_CASES geometry, tie-heavy
    and not."""
    jobs, arrays = {}, {}
    for i, tie in TIE_PARAMS:
        shape, k, s, p = POOL_CASES[i]
        dims, strides, pads = _full(k, s, p)
        gy_shape = tuple(pool._out_sizes(shape, dims, strides, pads))
        arrays[i, tie] = (_x(shape, 30 + i, tie), _x(gy_shape, 40 + i))
        jobs[i, tie] = _vjp_of(lambda a, g=(dims, strides, pads):
                               jpool.maxpool_tie_split(a, *g))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BIGDL_KERNELS", "xla")
        out = _jit_all(jobs, arrays)
    return {key: arrays[key] + out[key] for key in jobs}


@pytest.mark.parametrize("case,tie_heavy", TIE_PARAMS)
def test_tie_split_matches_the_jax_xla_leg(case, tie_heavy, tie_refs):
    _, k, s, p = POOL_CASES[case]
    dims, strides, pads = _full(k, s, p)
    x, gy, want_y, want_dx = tie_refs[case, tie_heavy]
    y, dx = _port_tie(x, dims, strides, pads, gy)
    np.testing.assert_array_equal(y.numpy(), want_y)
    np.testing.assert_array_equal(dx.numpy(), want_dx)
    np.testing.assert_allclose(dx.sum().item(), gy.sum(), rtol=1e-5)


TIE_PALLAS_CASES = [
    ((1, 2, 12, 12), (3, 3), (2, 2), ((0, 1), (0, 1))),   # ceil 3x3/s2
    ((1, 2, 7, 7), (3, 3), (1, 1), ((1, 1), (1, 1))),     # 3x3/s1/p1
]


@pytest.fixture(scope="module")
def tie_pallas_refs():
    """The Pallas kernels' (interpret mode) y and dx for each of
    ``TIE_PALLAS_CASES``."""
    jobs, arrays = {}, {}
    for i, (shape, k, s, p) in enumerate(TIE_PALLAS_CASES):
        dims, strides, pads = _full(k, s, p)
        gy_shape = tuple(pool._out_sizes(shape, dims, strides, pads))
        arrays[i] = (_x(shape, 50, tie_heavy=True), _x(gy_shape, 51))
        jobs[i] = _vjp_of(lambda a, g=(dims, strides, pads):
                          jpool.maxpool_tie_split(a, *g))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BIGDL_KERNELS", "pallas")
        out = _jit_all(jobs, arrays)
    return {i: arrays[i] + out[i] for i in jobs}


@pytest.mark.parametrize("case", range(len(TIE_PALLAS_CASES)),
                         ids=["shape0-k0-s0-p0", "shape1-k1-s1-p1"])
def test_tie_split_matches_the_pallas_kernels(case, tie_pallas_refs):
    _, k, s, p = TIE_PALLAS_CASES[case]
    dims, strides, pads = _full(k, s, p)
    x, gy, want_y, want_dx = tie_pallas_refs[case]
    y, dx = _port_tie(x, dims, strides, pads, gy)
    np.testing.assert_array_equal(y.numpy(), want_y)
    np.testing.assert_array_equal(dx.numpy(), want_dx)


def test_tie_split_edge_windows_match_the_jax_xla_leg(monkeypatch):
    """All -inf windows (the padding counts toward the tie as JAX pads
    with -inf), a NaN window (NaN out, no gradient), -0.0 against +0.0
    (a tie)."""
    monkeypatch.setenv("BIGDL_KERNELS", "xla")
    dims, strides, pads = _full((3, 3), (2, 2), ((1, 1), (1, 1)))
    x = _x((1, 2, 7, 7), 60)
    x[0, 0, :3, :3] = -np.inf          # the corner window: -inf and padding
    x[0, 0, 4, 4] = np.nan
    x[0, 1, :2, :2] = 0.0
    x[0, 1, 0, 0] = -0.0
    x[0, 1, 2:4, 2:4] = -1.0           # zeros win window (0, 0) with a tie
    gy = _x((1, 2, 4, 4), 61)
    want_y, want_dx = _jax_tie(x, dims, strides, pads, gy)
    y, dx = _port_tie(x, dims, strides, pads, gy)
    np.testing.assert_array_equal(y.numpy(), want_y)
    np.testing.assert_array_equal(dx.numpy(), want_dx)
    assert y[0, 0, 0, 0].item() == -np.inf and torch.isnan(y[0, 0, 2, 2])
    # the corner window's 4 real -inf taps get 4/9 of its gradient
    np.testing.assert_allclose(dx[0, 0, :2, :2].numpy(), gy[0, 0, 0, 0] / 9,
                               rtol=1e-6)
    assert dx[0, 0, 4, 4] == 0.0


def test_tie_split_conserves_gradient_mass():
    dims, strides, pads = _full((2, 2), (2, 2), ((0, 0), (0, 0)))
    x = np.ones((1, 1, 4, 4), np.float32)   # every tap ties
    gy = _x((1, 1, 2, 2), 62)
    _, dx = _port_tie(x, dims, strides, pads, gy)
    np.testing.assert_allclose(dx.sum().item(), gy.sum(), rtol=1e-6)
    np.testing.assert_allclose(dx[0, 0, :2, :2].numpy(), gy[0, 0, 0, 0] / 4,
                               rtol=1e-6)


def test_tie_split_plain_version_passes_gradcheck_in_f64():
    dims, strides, pads = _full((3, 3), (2, 2), ((1, 1), (1, 2)))
    x = torch.from_numpy(np.random.RandomState(63).permutation(
        2 * 7 * 6).reshape(1, 2, 7, 6) / 10.0).requires_grad_()  # no ties
    assert torch.autograd.gradcheck(
        lambda a: pool.maxpool_tie_split(a, dims, strides, pads), (x,))


# ---------------------------------------------------------------------------
# argmax index: the plain versions against maxpool_argmax
# ---------------------------------------------------------------------------

ARG_PARAMS = [(i, tie) for i in range(len(CASES)) for tie in (False, True)]


def _bf16(shape, seed, tie_heavy=False):
    return jnp.asarray(_x(shape, seed, tie_heavy), jnp.bfloat16)


def _port_bf16(xj):
    return torch.from_numpy(np.asarray(xj, np.float32)).bfloat16()


@pytest.fixture(scope="module")
def packed_refs():
    """``_fwd_packed``'s y and idx for every CASES geometry, tie-heavy and
    not."""
    jobs, arrays = {}, {}
    for i, tie in ARG_PARAMS:
        shape, k, s, p = CASES[i]
        arrays[i, tie] = (_bf16(shape, 70 + i, tie),)
        jobs[i, tie] = lambda a, g=_full(k, s, p): jpooling._fwd_packed(a, *g)
    out = _jit_all(jobs, arrays)
    return {key: arrays[key] + out[key] for key in jobs}


@pytest.mark.parametrize("case,tie_heavy", ARG_PARAMS)
def test_argmax_forward_matches_the_packed_forward(case, tie_heavy,
                                                   packed_refs):
    _, k, s, p = CASES[case]
    dims, strides, pads = _full(k, s, p)
    xj, want_y, want_idx = packed_refs[case, tie_heavy]
    y, idx = pool.maxpool_forward(_port_bf16(xj), dims, strides, pads,
                                  want_index=True)
    assert y.dtype == torch.bfloat16 and idx.dtype == torch.int8
    _bits_equal(y, want_y)
    np.testing.assert_array_equal(idx.numpy(), want_idx)


def _port_argmax(xj, dims, strides, pads, gy):
    xt = _port_bf16(xj).requires_grad_()
    y = pooling.maxpool_argmax(xt, dims, strides, pads)
    (dx,) = torch.autograd.grad(y, xt, _port_bf16(gy))
    return y.detach(), dx


ARGMAX_PALLAS = (6, 0)                # the shortfall, ceil 3x3/s2
ARGMAX_SCATTER = (1, 2, 3, 4, 5)


@pytest.fixture(scope="module")
def argmax_bwd_refs():
    """y and dx of the JAX argmax VJP on its Pallas kernels (interpret
    mode) for ``ARGMAX_PALLAS``, and of select-and-scatter (the VJP of
    ``reduce_window`` max) for ``ARGMAX_SCATTER``; ``{(kind, case):
    (xj, gy, y, dx)}``."""
    jobs, arrays = {}, {}
    for kind, cases, seed in (("pallas", ARGMAX_PALLAS, 80),
                              ("scatter", ARGMAX_SCATTER, 90)):
        for case in cases:
            shape, k, s, p = CASES[case]
            g = _full(k, s, p)
            arrays[kind, case] = (
                _bf16(shape, seed + case, tie_heavy=True),
                _pow2_grads(np.random.default_rng(case),
                            pool._out_sizes(shape, *g)))
            jobs[kind, case] = _vjp_of(
                (lambda a, g=g: jpooling.maxpool_argmax(a, *g))
                if kind == "pallas" else
                (lambda a, g=g: lax.reduce_window(a, -jnp.inf, lax.max, *g)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BIGDL_POOL_KERNEL", "interpret")
        out = _jit_all(jobs, arrays)
    return {k: arrays[k] + out[k] for k in jobs}


@pytest.mark.parametrize("case", ARGMAX_PALLAS)
def test_argmax_backward_matches_the_pallas_vjp(case, argmax_bwd_refs,
                                                monkeypatch):
    monkeypatch.setenv("BIGDL_POOL_KERNEL", "interpret")
    shape, k, s, p = CASES[case]
    dims, strides, pads = _full(k, s, p)
    xj, gy, y_ref, dx_ref = argmax_bwd_refs["pallas", case]
    assert jpooling.pallas_pool_supported(xj, dims, strides, pads)
    assert pooling.pool_kernel_supported(_port_bf16(xj), dims, strides, pads,
                                         True)
    y, dx = _port_argmax(xj, dims, strides, pads, gy)
    _bits_equal(y, y_ref)
    _bits_equal(dx, dx_ref)


@pytest.mark.parametrize("case", ARGMAX_SCATTER)
def test_argmax_backward_matches_select_and_scatter(case, argmax_bwd_refs):
    shape, k, s, p = CASES[case]
    dims, strides, pads = _full(k, s, p)
    xj, gy, y_ref, dx_ref = argmax_bwd_refs["scatter", case]
    y, dx = _port_argmax(xj, dims, strides, pads, gy)
    _bits_equal(y, y_ref)
    _bits_equal(dx, dx_ref)


def test_argmax_edge_windows_match_the_packed_forward():
    """A padding tap never wins (an all -inf window picks a real tap), a
    NaN wins its window, -0.0 ties with +0.0 and the first wins."""
    dims, strides, pads = _full((3, 3), (2, 2), ((1, 1), (1, 1)))
    x = _x((1, 8, 7, 7), 100)
    x[0, 0, :3, :3] = -np.inf
    x[0, 1, 1, 1] = np.nan
    x[0, 2, :2, :2] = 0.0
    x[0, 2, 0, 0] = -1.0
    x[0, 2, 0, 1] = -0.0
    xj = jnp.asarray(x, jnp.bfloat16)
    want_y, want_idx = jax.jit(jpooling._fwd_packed, static_argnums=(1, 2, 3))(
        xj, dims, strides, pads)
    y, idx = pool.maxpool_forward(_port_bf16(xj), dims, strides, pads,
                                  want_index=True)
    _bits_equal(y, want_y)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    assert y[0, 0, 0, 0] == -np.inf and idx[0, 0, 0, 0] == 4  # (1, 1)
    assert torch.isnan(y[0, 1, 1, 1]) and idx[0, 1, 1, 1] == 0
    assert y[0, 2, 0, 0] == 0 and idx[0, 2, 0, 0] == 5        # (1, 2)


def test_argmax_inf_gradient_stays_on_its_winner():
    """The deliberate difference from the Pallas mask-multiply: an inf
    gradient reaches its winner and no other tap gets NaN."""
    dims, strides, pads = _full((2, 2), (2, 2), ((0, 0), (0, 0)))
    xj = _bf16((1, 8, 4, 4), 101)
    gy = np.ones((1, 8, 2, 2), np.float32)
    gy[0, 0, 0, 0] = np.inf
    _, dx = _port_argmax(xj, dims, strides, pads, gy)
    win = np.asarray(xj[0, 0, :2, :2], np.float32).argmax()
    block = dx[0, 0, :2, :2].float().numpy().reshape(-1)
    assert block[win] == np.inf
    assert np.all(np.delete(block, win) == 0.0)
    assert torch.isfinite(dx[0, 1:]).all()


# ---------------------------------------------------------------------------
# the layer's routing and the kernels' wrappers
# ---------------------------------------------------------------------------

@pytest.fixture
def routes(monkeypatch):
    calls = {"tie": 0, "argmax": 0}

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(tpooling_layer, "maxpool_tie_split",
                        count("tie", pool.maxpool_tie_split))
    monkeypatch.setattr(tpooling_layer, "maxpool_argmax",
                        count("argmax", pooling.maxpool_argmax))
    return calls


def test_split_ties_and_torch_ties_switch_the_path(routes):
    x = torch.from_numpy(_x((1, 2, 9, 9), 110, tie_heavy=True))
    layer = tnn.SpatialMaxPooling(3, 3, 2, 2).ceil()
    default = layer(x)
    assert routes == {"tie": 0, "argmax": 0}
    assert layer.split_ties() is layer
    assert torch.equal(layer(x), default)
    assert routes == {"tie": 1, "argmax": 0}
    layer.torch_ties()(x)
    assert routes == {"tie": 1, "argmax": 0}
    # more than 64 taps: the default path, as in JAX
    tnn.SpatialMaxPooling(9, 9).split_ties()(x)
    assert routes == {"tie": 1, "argmax": 0}


def test_tie_split_on_3d_input_runs_the_plain_version(routes, monkeypatch):
    monkeypatch.setenv("BIGDL_KERNELS", "xla")
    ops.reset_kernel_launches()
    x = _x((2, 7, 7), 111, tie_heavy=True)
    want = jnn.SpatialMaxPooling(3, 3, 2, 2).ceil().split_ties()
    layer = tnn.SpatialMaxPooling(3, 3, 2, 2).ceil().split_ties()
    dims, strides, pads, _ = layer._window(torch.from_numpy(x))
    gy = _x(tuple(pool._out_sizes(x.shape, dims, strides, pads)), 112)
    y_ref, dx_ref = _jax_vjp(want.update_output, jnp.asarray(x),
                             jnp.asarray(gy))
    xt = torch.from_numpy(x).requires_grad_()
    y = layer(xt)
    (dx,) = torch.autograd.grad(y, xt, torch.from_numpy(gy))
    assert routes["tie"] == 1
    np.testing.assert_array_equal(y.detach().numpy(), y_ref)
    np.testing.assert_array_equal(dx.numpy(), dx_ref)
    assert not any(ops.kernel_launches().values())


def test_argmax_index_takes_16_bit_input_only(routes):
    layer = tnn.SpatialMaxPooling(3, 3, 2, 2, argmax_index=True).ceil()
    x = torch.from_numpy(_x((1, 8, 9, 9), 113))
    layer(x)
    assert routes == {"tie": 0, "argmax": 0}       # f32: the default path
    layer(x.bfloat16())
    assert routes == {"tie": 0, "argmax": 1}
    layer.use_argmax_index(False)(x.bfloat16())
    assert routes == {"tie": 0, "argmax": 1}
    assert tnn.SpatialAveragePooling(3, 3).split_ties() \
        .use_argmax_index()(x).shape == (1, 8, 3, 3)
    assert routes == {"tie": 0, "argmax": 1}


def test_argmax_gate_follows_the_jax_gate():
    dims, strides, pads = _full((3, 3), (2, 2), ((1, 1), (1, 1)))
    for shape, dtype, ok in (((1, 8, 224, 224), torch.bfloat16, True),
                             ((1, 3, 8, 8), torch.float16, True),  # n*c % 8
                             ((1, 8, 8, 8), torch.float32, False),
                             ((1, 8, 255, 8), torch.bfloat16, False)):
        x = torch.zeros(shape, dtype=dtype)
        assert pooling.pool_kernel_supported(x, dims, strides, pads,
                                             True) is ok
        assert not pooling.pool_kernel_supported(x, dims, strides, pads,
                                                 False)
    x = torch.zeros((1, 8, 9, 9), dtype=torch.bfloat16)
    assert not pooling.pool_kernel_supported(
        x, *_full((9, 9), (1, 1), ((0, 0), (0, 0))), True)   # 81 taps


def test_perf_pool_kernel_flag_parses():
    parse = cli._parser().parse_args
    assert parse(["perf"]).pool_kernel == "off"
    assert parse(["perf", "--pool-kernel", "on"]).pool_kernel == "on"
    with pytest.raises(SystemExit):
        parse(["perf", "--pool-kernel", "interpret"])


def test_a_cuda_tensor_reaches_the_max_pool_kernels_or_raises(monkeypatch):
    def plain(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain version")

    def no_build(*args, **kwargs):
        raise RuntimeError("no card to build for")

    monkeypatch.setattr(pool, "maxpool_forward_plain", plain)
    monkeypatch.setattr(pool, "maxpool_tie_split_backward_plain", plain)
    monkeypatch.setattr(pooling, "maxpool_argmax_backward_plain", plain)
    monkeypatch.setattr(_build, "library", no_build)
    ops.reset_kernel_launches()
    dims, strides, pads = _full((3, 3), (2, 2), ((0, 1), (0, 1)))
    x = _cuda_typed((1, 2, 8, 8))
    y = _cuda_typed((1, 2, 4, 4))
    idx = _cuda_typed((1, 2, 4, 4)).to(torch.int8)
    with pytest.raises(RuntimeError, match="no card"):
        pool.maxpool_forward(x, dims, strides, pads, want_index=True)
    with pytest.raises(RuntimeError, match="no card"):
        pool.maxpool_tie_split_backward(x, y, y, dims, strides, pads)
    with pytest.raises(RuntimeError, match="no card"):
        pooling.maxpool_argmax_backward(y, idx, (1, 2, 8, 8), dims, strides,
                                        pads)
    # what the kernels cannot take raises before any build
    with pytest.raises(TypeError, match="max-pool kernel takes"):
        pool.maxpool_forward(x.double(), dims, strides, pads)
    with pytest.raises(ValueError, match="contiguous"):
        pool.maxpool_forward(x.transpose(2, 3), dims, strides, pads)
    with pytest.raises(TypeError, match="int8"):
        pooling.maxpool_argmax_backward(y, y, (1, 2, 8, 8), dims, strides,
                                        pads)
    with pytest.raises(ValueError, match="2\\^31"):
        pool._check_32bit((2 ** 16, 2 ** 15, 1, 1))   # 32-bit indexing
    assert not any(ops.kernel_launches().values())


def test_kernel_wrappers_cover_the_max_pool_kernels():
    wrappers = ops.kernel_wrappers()
    assert wrappers["maxpool_fwd"] is pool.maxpool_forward
    assert wrappers["maxpool_tie_bwd"] is pool.maxpool_tie_split_backward
    assert wrappers["maxpool_argmax_bwd"] is pooling.maxpool_argmax_backward
    assert set(_build.SOURCES) >= {"maxpool_fwd", "maxpool_tie_bwd",
                                   "maxpool_argmax_bwd"}


# ---------------------------------------------------------------------------
# the slice: the narrow Inception-v1 TrainStep in both max-pool modes
# ---------------------------------------------------------------------------

def _max_pools(model, nn):
    return [m for m in model.modules()
            if isinstance(m, nn.SpatialMaxPooling)
            and not isinstance(m, nn.SpatialAveragePooling)]


def _mode_pair(mode, compute_dtype=None):
    jmodel, tmodel = copied_pair()
    for m in _max_pools(jmodel, jnn) + _max_pools(tmodel, tnn):
        if mode == "tie":
            m.split_ties()
    if mode == "argmax":
        for m in _max_pools(tmodel, tnn):
            m.use_argmax_index()
    sgd = dict(learning_rate=0.01, momentum=0.9)
    jstep = JaxTrainStep(jmodel, jnn.ClassNLLCriterion(), joptim.SGD(**sgd),
                         compute_dtype=None if compute_dtype is None
                         else jnp.bfloat16)
    tstep = TrainStep(tmodel, tnn.ClassNLLCriterion(), SGD(**sgd),
                      compute_dtype=compute_dtype, device="cpu")
    return jstep, tstep


def _batch(step):
    rng = np.random.RandomState(120 + step)
    x = rng.randn(2, 3, 32, 32).astype(np.float32)
    return np.round(x * 2.0) / 2.0, rng.randint(0, 10, 2)


def test_three_tie_split_steps_follow_the_jax_train_step(monkeypatch):
    monkeypatch.setenv("BIGDL_KERNELS", "xla")
    jstep, tstep = _mode_pair("tie")
    for i in range(3):
        x, y = _batch(i)
        want = float(jstep.run(jnp.asarray(x), jnp.asarray(y),
                               jax.random.key(i)))
        np.testing.assert_allclose(tstep.run(x, y), want, rtol=1e-5)
    state = to_numpy_state(tstep.model)
    for k, v in jstep.params.items():
        np.testing.assert_allclose(state[k], np.asarray(v), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_argmax_bf16_step_follows_the_jax_default_step():
    """Select-and-scatter has the argmax path's semantics, so the JAX
    default bf16 step is the reference."""
    jstep, tstep = _mode_pair("argmax", torch.bfloat16)
    x, y = _batch(0)
    want = jstep.run(jnp.asarray(x), jnp.asarray(y), jax.random.key(0))
    np.testing.assert_allclose(tstep.run(x, y), float(want), rtol=2e-2)


@pytest.mark.parametrize("mode,dtype,fn", [
    ("tie", None, "maxpool_tie_split_backward"),
    ("argmax", torch.bfloat16, "maxpool_argmax_backward"),
])
def test_train_step_drives_the_max_pool_backward(mode, dtype, fn,
                                                 monkeypatch):
    """The narrow step reaches the mode's backward once per max pool."""
    module = pool if mode == "tie" else pooling
    calls = []
    real = getattr(module, fn)

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(module, fn, counted)
    _, tstep = _mode_pair(mode, dtype)
    assert len(_max_pools(tstep.model, tnn)) == 3
    tstep.run(*_batch(0))
    assert len(calls) == 3


# ---------------------------------------------------------------------------
# out-of-range indices: the JAX package's results
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("one_based", [False, True])
def test_lookup_table_out_of_range_indices_match_jax(one_based):
    jt = jnn.LookupTable(4, 3, one_based=one_based)
    tt = tnn.LookupTable(4, 3, one_based=one_based)
    tt.weight.data = torch.from_numpy(np.asarray(jt.weight).copy())
    idx = np.array([[0, 5, -1, -7], [3, 4, -4, -5]]) + int(one_based)
    want = np.asarray(jt.forward(jnp.asarray(idx)))
    got = tt(torch.from_numpy(idx)).detach().numpy()
    np.testing.assert_array_equal(got, want)
    if not one_based:   # the rows the JAX package gathers, by hand
        w = np.asarray(jt.weight)
        np.testing.assert_array_equal(got[0], w[[0, 3, 3, 0]])


@pytest.mark.parametrize("weights", [None, [0.5, 2.0, 3.0]])
def test_class_nll_out_of_range_targets_match_jax(weights):
    logp = np.asarray(jax.nn.log_softmax(_x((8, 3), 130)))
    for target in ([0, 1, 2, 2, -1, -3, 1, 0],      # in range, wrapped
                   [0, 1, 2, 3, -1, -3, -4, 7]):    # past the end: NaN
        jc = jnn.ClassNLLCriterion(weights=weights)
        tc = tnn.ClassNLLCriterion(weights=weights)
        t = np.asarray(target)
        # one jitted call: eager dispatch compiles every small op alone
        want, want_g = jax.jit(jax.value_and_grad(
            lambda a: jc.forward(a, jnp.asarray(t))))(jnp.asarray(logp))
        inp = torch.from_numpy(logp.copy()).requires_grad_()
        got = tc.forward(inp, torch.from_numpy(t))
        got.backward()
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
        np.testing.assert_allclose(inp.grad.numpy(), np.asarray(want_g),
                                   rtol=1e-6, atol=1e-7)
        assert np.isnan(got.item()) == (max(target) >= 3)
