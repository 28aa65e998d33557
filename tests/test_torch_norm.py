"""The within-channel LRN and the subtractive, divisive and contrastive
normalizations of the port against the JAX package.

On the CPU the port's wrappers run their plain versions; they are held
here to the JAX ops' Pallas legs, run in interpret mode under
``BIGDL_KERNELS=pallas`` as ``tests/test_kernels.py`` runs them, on
inputs made from a numpy seed at that file's small shapes.  Each JAX
reference is jitted once per case and shared by the tests that read it
(eager interpret mode costs several times as much).  Backwards are held
to the JAX custom VJPs.

Tolerances: f32 at rtol 1e-5 / atol 1e-6 (the same terms summed in the
same order; exp and log differ by an ulp).  bf16 at 2e-2, the slack
``test_kernels.py`` gives bf16: the Pallas kernels sum their taps in
the plane's dtype, rounding every add, where the port sums in f32 and
rounds once.  For the input gradients of the divisive and contrastive
normalizations in bf16 that slack holds elementwise against neither
side: the JAX bf16 leg's own gradient departs from its f32 gradient on
the same inputs by up to 0.33 (the max of sigma and its mean switches
branch where bf16 rounds them level).  Those two are held at 2e-2 in
relative L2 error to the JAX Pallas leg run in f32 on the same
bf16-rounded inputs.

The normalizations use a 3 x 3 Gaussian: the interpret-mode trace of a
Pallas leg grows with its taps (a 9 x 9 one costs about three times
as much); the layers' tests hold the 9 x 9 default on the XLA legs.
The CUDA kernels are held to these plain versions on the card by
``chip_smoke.py``.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bigdl_tpu.nn as jnn
from bigdl_tpu.nn.layers.normalization import (
    _gaussian_kernel as jax_gaussian_kernel)
from bigdl_tpu.nn.module import state_dict as jax_state_dict
from bigdl_tpu.ops import dispatch, lrn_pallas, norm_pallas
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.nn.layers.normalization import _gaussian_kernel
from bigdl_tpu_torch.ops import (_build, kernel_launches, lrn, norm,
                                 reset_kernel_launches)
from bigdl_tpu_torch.utils.convert import from_jax_state
from test_torch_slice import one_thread  # noqa: F401

TOL = {"float32": dict(rtol=1e-5, atol=1e-6),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True)
def _pallas(monkeypatch):
    monkeypatch.setenv("BIGDL_KERNELS", "pallas")


def _x(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(got, want, dtype):
    assert got.dtype == TORCH[dtype]
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


def _rounded(a, dtype):
    """``a`` rounded to ``dtype`` and back to f32, so both packages read
    the same values."""
    return np.array(jnp.asarray(a, JNP[dtype]), np.float32)


def _grad(fn, x, g, dtype, *args):
    """(y, dx) of the port's ``fn`` on numpy ``x`` and cotangent ``g``."""
    xt = torch.from_numpy(x).to(TORCH[dtype]).requires_grad_()
    y = fn(xt, *args)
    (dx,) = torch.autograd.grad(y, xt, torch.from_numpy(g).to(TORCH[dtype]))
    return y, dx


# ---------------------------------------------------------------------------
# within-channel LRN
# ---------------------------------------------------------------------------

WCL_CASES = {
    # name: (shape, size, alpha, beta), the shapes of test_kernels.py
    "6x6-w3": ((2, 4, 6, 6), 3, 0.01, 0.75),
    "7x5-w4-even": ((1, 2, 7, 5), 4, 0.01, 0.75),   # (lo, hi) = (1, 2)
    "9x9-w5-rsqrt": ((2, 3, 9, 9), 5, 0.5, 0.5),    # beta 0.5: rsqrt
}
WCL_PARAMS = [(c, "float32") for c in WCL_CASES] + [
    ("7x5-w4-even", "bfloat16")]


def _wcl_job(name, dtype):
    """(inputs, fn) of one case: x and g, and (y, scale, dx) from the
    custom VJP's rules on the Pallas legs."""
    shape, size, alpha, beta = WCL_CASES[name]

    def run(a, ga):
        y, res = lrn_pallas._wcl_vjp_fwd(a, size, alpha, beta)
        (dx,) = lrn_pallas._wcl_vjp_bwd(size, alpha, beta, res, ga)
        return y, res[1], dx

    return (_rounded(_x(shape, 1), dtype), _rounded(_x(shape, 2), dtype)), run


@pytest.fixture(scope="module")
def pallas_refs():
    """Inputs and results of every within-channel LRN and smooth2d case on
    the Pallas legs, ``{key: inputs + results}``, in one jitted call: a
    jit of its own costs about 0.1 s here, more than a case's work."""
    jobs = [(("wcl", n, d), d) + _wcl_job(n, d) for n, d in WCL_PARAMS]
    jobs += [(("smooth", n, d), d) + _smooth_job(n, d)
             for n, d in dict.fromkeys((n, d) for n, d, _ in SMOOTH_PARAMS)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BIGDL_KERNELS", "pallas")
        out = jax.jit(lambda arrays: [run(*a) for (_, _, _, run), a in
                                      zip(jobs, arrays)])(
            [tuple(jnp.asarray(a, JNP[d]) for a in args)
             for _, d, args, _ in jobs])
    return {key: args + tuple(r) for (key, _, args, _), r in zip(jobs, out)}


@pytest.mark.parametrize("name,dtype", WCL_PARAMS)
def test_within_channel_forward_and_scale_match_pallas(name, dtype,
                                                        pallas_refs):
    x, _, want_y, want_scale, _ = pallas_refs["wcl", name, dtype]
    _, size, alpha, beta = WCL_CASES[name]
    y, scale = lrn.within_channel_lrn_forward(
        torch.from_numpy(x).to(TORCH[dtype]), size, alpha, beta)
    _close(y, want_y, dtype)
    _close(scale, want_scale, dtype)   # stored in x's dtype, as in JAX


@pytest.mark.parametrize("name,dtype", WCL_PARAMS)
def test_within_channel_backward_matches_pallas_vjp(name, dtype,
                                                    pallas_refs):
    x, g, want_y, _, want_dx = pallas_refs["wcl", name, dtype]
    _, size, alpha, beta = WCL_CASES[name]
    y, dx = _grad(lrn.within_channel_lrn, x, g, dtype, size, alpha, beta)
    _close(y, want_y, dtype)
    _close(dx, want_dx, dtype)


def test_within_channel_backward_reads_the_rounded_scale(pallas_refs):
    """Autograd's dx is the backward's plain version from the forward's
    bf16 ``scale``: the scale is saved in x's dtype."""
    x, g, _, _, _ = pallas_refs["wcl", "7x5-w4-even", "bfloat16"]
    xt, gt = (torch.from_numpy(a).bfloat16() for a in (x, g))
    _, scale = lrn.within_channel_lrn_plain(xt, 4, 0.01, 0.75)
    assert scale.dtype == torch.bfloat16
    want = lrn.within_channel_lrn_backward_plain(xt, scale, gt, 4, 0.01,
                                                 0.75)
    _, dx = _grad(lrn.within_channel_lrn, x, g, "bfloat16", 4, 0.01, 0.75)
    assert torch.equal(dx, want)


# ---------------------------------------------------------------------------
# smooth2d, both directions
# ---------------------------------------------------------------------------

def _normalized(k):
    """Divided by its sum, as every layer divides its kernel."""
    return (k / k.sum()).astype(np.float32)


SMOOTH_KERNELS = {
    "3x5": _normalized(np.random.RandomState(3).rand(3, 5)),
    "4x4-even": _normalized(np.random.RandomState(4).rand(4, 4)),
}
SMOOTH_PARAMS = [(k, "float32", f) for k in SMOOTH_KERNELS
                 for f in (False, True)] + [
    ("4x4-even", "bfloat16", False), ("4x4-even", "bfloat16", True)]


def _pads(kernel, flip):
    return (norm._transpose_pads if flip else norm._fwd_pads)(*kernel.shape)


def _smooth_job(name, dtype):
    """(inputs, fn) of one kernel and dtype: the stack, and the Pallas
    leg's forward and transpose of it."""
    k = SMOOTH_KERNELS[name]

    def run(v):
        return tuple(norm_pallas._smooth_pallas(v, jnp.asarray(k),
                                                _pads(k, f), f)
                     for f in (False, True))

    return (_rounded(_x((2, 12, 12), 5), dtype),), run


@pytest.mark.parametrize("name,dtype,flip", SMOOTH_PARAMS)
def test_smooth2d_matches_pallas(name, dtype, flip, pallas_refs):
    k = SMOOTH_KERNELS[name]
    assert norm._fwd_pads(*k.shape) == norm_pallas._fwd_pads(*k.shape)
    assert norm._transpose_pads(*k.shape) == \
        norm_pallas._transpose_pads(*k.shape)
    stack, *want = pallas_refs["smooth", name, dtype]
    got = norm.smooth2d(torch.from_numpy(stack).to(TORCH[dtype]),
                        torch.from_numpy(k), _pads(k, flip), flip)
    _close(got, want[int(flip)], dtype)


def test_smooth2d_rounds_the_kernel_to_the_stack_dtype():
    k = torch.from_numpy(SMOOTH_KERNELS["3x5"])
    stack = torch.from_numpy(_x((1, 6, 7), 6)).bfloat16()
    pads = norm._fwd_pads(3, 5)
    assert torch.equal(norm.smooth2d(stack, k, pads),
                       norm.smooth2d(stack, k.bfloat16(), pads))


# ---------------------------------------------------------------------------
# subtractive, divisive, contrastive
# ---------------------------------------------------------------------------

NORM_OPS = ("subtractive_norm", "divisive_norm", "contrastive_norm")
NORM_KERNEL = _gaussian_kernel(3)


def _norm_inputs():
    """(x, g), bf16-representable, [4, 3, 12, 12]: images 0 and 1 random
    (the bf16 cases read these two); image 2 all zeros (sigma 0: the
    thresval branch and the guarded gradient); image 3 of +-2, so every
    smoothed mean square is 4 and sigma equals its plane mean exactly
    (ties: the position branch)."""
    x = _rounded(_x((4, 3, 12, 12), 7), "bfloat16")
    x[2] = 0.0
    x[3] = np.where(x[3] >= 0, 2.0, -2.0)
    return x, _rounded(_x((4, 3, 12, 12), 8), "bfloat16")


@functools.lru_cache(maxsize=None)
def _jax_vjp(op, dtype):
    """The JAX op and its custom VJP on the Pallas legs as one jitted
    ``(x, g) -> (y, dx)``."""
    fn = getattr(norm_pallas, op)

    def run(a, ga):
        y, vjp = jax.vjp(lambda v: fn(v, jnp.asarray(NORM_KERNEL)), a)
        return y, vjp(ga)[0]

    return jax.jit(run)


@functools.lru_cache(maxsize=None)
def _norm_case(op, dtype):
    """(y, dx) of the JAX op: all four images in f32, the random two in
    bf16.  ``contrastive_norm`` is ``divisive_norm(subtractive_norm(x))``
    in the JAX package; it is run as that chain of the two jitted VJPs,
    which traces no Pallas leg a second time."""
    x, g = _norm_inputs()
    if dtype == "bfloat16":
        x, g = x[:2], g[:2]
    x, g = jnp.asarray(x, JNP[dtype]), jnp.asarray(g, JNP[dtype])
    if op != "contrastive_norm":
        return _jax_vjp(op, dtype)(x, g)
    sub, div = (_jax_vjp(o, dtype) for o in NORM_OPS[:2])
    y, dy = div(sub(x, g)[0], g)
    return y, sub(x, dy)[1]


@pytest.mark.parametrize("op", NORM_OPS)
def test_normalization_matches_pallas_vjp_in_f32(op):
    x, g = _norm_inputs()
    want_y, want_dx = _norm_case(op, "float32")
    y, dx = _grad(getattr(norm, op), x, g, "float32",
                  torch.from_numpy(NORM_KERNEL))
    _close(y, want_y, "float32")
    _close(dx, want_dx, "float32")
    if op == "divisive_norm":
        # image 2 divides by thresval, and image 3 by its sigma of 2
        np.testing.assert_array_equal(y[2].detach().numpy(), 0.0)
        np.testing.assert_allclose(dx[2].numpy(), g[2] / np.float32(1e-4),
                                   rtol=1e-6)
        np.testing.assert_array_equal(y[3].detach().numpy(), x[3] / 2)


@pytest.mark.parametrize("op", NORM_OPS)
def test_normalization_matches_pallas_vjp_in_bf16(op):
    x, g = (a[:2] for a in _norm_inputs())
    want_y, want_dx = _norm_case(op, "bfloat16")
    y, dx = _grad(getattr(norm, op), x, g, "bfloat16",
                  torch.from_numpy(NORM_KERNEL))
    _close(y, want_y, "bfloat16")
    if op == "subtractive_norm":
        _close(dx, want_dx, "bfloat16")
        return
    # see the module docstring: held to the f32 leg on the same inputs
    ref = np.asarray(_norm_case(op, "float32")[1][:2])
    err = np.linalg.norm(dx.float().numpy() - ref) / np.linalg.norm(ref)
    assert dx.dtype == torch.bfloat16 and err <= 2e-2


@pytest.mark.parametrize("op", NORM_OPS)
def test_smoothing_kernel_gets_a_zero_gradient(op):
    x = torch.from_numpy(_x((1, 2, 6, 6), 10)).requires_grad_()
    k = torch.from_numpy(_gaussian_kernel(3)).requires_grad_()
    getattr(norm, op)(x, k).square().sum().backward()
    assert k.grad is not None and k.grad.shape == k.shape
    assert torch.count_nonzero(k.grad) == 0
    assert torch.isfinite(x.grad).all()


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------

WCL_LAYER = ("SpatialWithinChannelLRN", (4, 0.5, 0.75))
WCL_LAYER_SHAPES = [(3, 6, 6), (2, 3, 6, 6), (2, 2, 3, 6, 6)]
SMOOTHING_LAYERS = [
    ("SpatialSubtractiveNormalization", (3,)),
    ("SpatialDivisiveNormalization", (3, None, 1e-3, 1e-2)),
    ("SpatialContrastiveNormalization",
     (3, np.array([0.25, 0.5, 1.0, 0.5, 0.25], np.float32))),  # 1-D kernel
]
LAYER_CASES = [(WCL_LAYER, _x(shape, 11)) for shape in WCL_LAYER_SHAPES] + [
    (layer, _x((2, 3, 10, 9)[4 - rank:], 12))
    for rank in (3, 4) for layer in SMOOTHING_LAYERS]


@pytest.fixture(scope="module")
def layer_refs():
    """For each of ``LAYER_CASES``: the JAX layer's state and its output
    on the XLA legs, all outputs from one jitted call."""
    layers = [getattr(jnn, cls)(*args).evaluate()
              for (cls, args), _ in LAYER_CASES]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BIGDL_KERNELS", "xla")
        out = jax.jit(lambda xs: [jl.forward(x) for jl, x in
                                  zip(layers, xs)])(
            [jnp.asarray(x) for _, x in LAYER_CASES])
    return [({k: np.asarray(v) for k, v in jax_state_dict(jl).items()},
             np.asarray(want)) for jl, want in zip(layers, out)]


def _layer_check(case, layer_refs):
    """The port's layer, its state copied from the JAX layer's by key,
    against the JAX layer's output."""
    (cls, args), x = LAYER_CASES[case]
    state, want = layer_refs[case]
    tl = getattr(tnn, cls)(*args)
    tnn.load_state_dict(tl, from_jax_state(state, "cpu", tl))
    got = tl.evaluate()(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL["float32"])


@pytest.mark.parametrize("case", range(3),
                         ids=["rank3", "rank4", "rank5-window-mean"])
def test_within_channel_lrn_layer(case, layer_refs):
    _layer_check(case, layer_refs)


@pytest.mark.parametrize("case", range(3, len(LAYER_CASES)),
                         ids=[f"{rank}-{c}" for rank in (3, 4)
                              for c, _ in SMOOTHING_LAYERS])
def test_smoothing_layers(case, layer_refs):
    _layer_check(case, layer_refs)


def test_contrastive_state_crosses_from_jax():
    ramp = np.arange(1, 6, dtype=np.float32)
    jl = jnn.SpatialContrastiveNormalization(3, ramp)
    state = {k: np.asarray(v) for k, v in jax_state_dict(jl).items()}
    tl = tnn.SpatialContrastiveNormalization(3, np.ones(5, np.float32))
    assert set(state) == set(tl.state_dict()) == {"sub.kernel", "div.kernel"}
    tnn.load_state_dict(tl, from_jax_state(state, "cpu", tl))
    for name in ("sub.kernel", "div.kernel"):
        np.testing.assert_array_equal(tl.state_dict()[name].numpy(),
                                      state[name])
    np.testing.assert_array_equal(_gaussian_kernel(9),
                                  jax_gaussian_kernel(9))


# ---------------------------------------------------------------------------
# calls per forward + backward, against the JAX dispatch records
# ---------------------------------------------------------------------------

#: per forward + backward: (within-channel fwd, bwd), (smooth fwd, flipped)
CALLS = {"within_channel_lrn": (1, 1, 0, 0),
         "subtractive_norm": (0, 0, 2, 1),
         "divisive_norm": (0, 0, 2, 1),
         "contrastive_norm": (0, 0, 4, 2)}


def _jax_op(op):
    if op == "within_channel_lrn":
        return lambda a: lrn_pallas.within_channel_lrn(a, 3, 0.01, 0.75)
    k = jnp.asarray(jax_gaussian_kernel(3))
    return lambda a: getattr(norm_pallas, op)(a, k)


def _port_op(op):
    if op == "within_channel_lrn":
        return lambda a: lrn.within_channel_lrn(a, 3, 0.01, 0.75)
    k = torch.from_numpy(_gaussian_kernel(3))
    return lambda a: getattr(norm, op)(a, k)


@pytest.mark.parametrize("op", list(CALLS))
def test_calls_per_step_equal_the_jax_dispatches(op, monkeypatch):
    """The JAX op is traced (not run) on its XLA legs: it records one
    dispatch per smoothing or LRN call whichever leg it takes."""
    monkeypatch.setenv("BIGDL_KERNELS", "xla")
    x = _x((1, 2, 5, 5), 13)
    dispatch.clear_decisions()
    jax.make_jaxpr(lambda a: jax.vjp(_jax_op(op), a)[1](a))(jnp.asarray(x))
    records = [name for name, _, _ in dispatch.decisions()]
    want = tuple(records.count(n) for n in (
        "lrn_within_channel.fwd", "lrn_within_channel.bwd",
        "norm_smooth.fwd", "norm_smooth.bwd"))

    calls = []

    def spy(fn, key):
        def call(*args, **kwargs):
            calls.append(key(*args, **kwargs))
            return fn(*args, **kwargs)
        return call

    monkeypatch.setattr(lrn, "within_channel_lrn_forward",
                        spy(lrn.within_channel_lrn_forward, lambda *a: 0))
    monkeypatch.setattr(lrn, "within_channel_lrn_backward",
                        spy(lrn.within_channel_lrn_backward, lambda *a: 1))
    monkeypatch.setattr(norm, "smooth2d", spy(
        norm.smooth2d, lambda *a, flip=False: 3 if flip else 2))
    xt = torch.from_numpy(x).requires_grad_()
    _port_op(op)(xt).backward(torch.ones_like(xt))
    got = tuple(calls.count(i) for i in range(4))
    assert got == want == CALLS[op]


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

def _forbidden_build(*args, **kwargs):
    raise AssertionError("a CPU tensor reached the kernel build")


def test_cpu_tensors_never_touch_the_kernels(monkeypatch):
    reset_kernel_launches()
    monkeypatch.setattr(_build, "build", _forbidden_build)
    x = torch.from_numpy(_x((2, 3, 8, 8), 14)).requires_grad_()
    layers = [tnn.SpatialWithinChannelLRN(5, 1e-4, 0.75),
              tnn.SpatialSubtractiveNormalization(3),
              tnn.SpatialDivisiveNormalization(3),
              tnn.SpatialContrastiveNormalization(3)]
    sum(layer(x).sum() for layer in layers).backward()
    assert torch.isfinite(x.grad).all()
    launches = kernel_launches()
    assert {"within_channel_lrn_fwd", "within_channel_lrn_bwd",
            "smooth2d"} <= set(launches)
    assert set(launches.values()) == {0}


def test_structural_gates_raise_on_every_device():
    with pytest.raises(ValueError, match="4-D NCHW"):
        lrn.within_channel_lrn_forward(torch.zeros(1, 2, 3, 4, 5), 3, 1.0,
                                       0.75)
    with pytest.raises(ValueError, match="at least 1"):
        lrn.within_channel_lrn_forward(torch.zeros(1, 2, 3, 4), 0, 1.0, 0.75)
    with pytest.raises(ValueError, match=r"\[B, H, W\]"):
        norm.smooth2d(torch.zeros(1, 2, 3, 4), torch.ones(3, 3),
                      norm._fwd_pads(3, 3))
