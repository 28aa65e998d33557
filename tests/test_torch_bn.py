"""Batch normalization and the Inception-v2 blocks of the port against
the JAX package.

Inputs, gradients and weights come from a numpy seed; the JAX results
of each case are computed in one jitted call.  Tolerances: rtol 1e-5 /
atol 1e-6 for f32 batch norm (forward, dx, dgamma, dbeta and both
running buffers after two steps), 1e-4 for the Inception-v2 blocks (the
convolutions sum in another order), 2e-2 for a bf16 forward.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bigdl_tpu.nn as jnn
from bigdl_tpu.models.inception import build_inception_v2 as jax_build_v2
from bigdl_tpu.models.inception import inception_layer_v2 as jax_layer_v2
from bigdl_tpu.nn.module import functional_call as jax_call
from bigdl_tpu.nn.module import state_dict as jax_state_dict
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.models.inception import (build_inception_v2,
                                              inception_layer_v2)
from bigdl_tpu_torch.utils.convert import from_jax_state
from test_torch_slice import one_thread  # noqa: F401

F32 = dict(rtol=1e-5, atol=1e-6)


def _x(shape, seed=0, scale=1.0, shift=0.0):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape) * scale + shift).astype(np.float32)


def _pair(kind, n, affine):
    jcls, tcls = {"spatial": (jnn.SpatialBatchNormalization,
                              tnn.SpatialBatchNormalization),
                  "flat": (jnn.BatchNormalization,
                           tnn.BatchNormalization)}[kind]
    jlayer = jcls(n, eps=1e-3, momentum=0.2, affine=affine)
    tlayer = tcls(n, eps=1e-3, momentum=0.2, affine=affine)
    if affine:
        jlayer.weight = jnp.asarray(_x((n,), 7, 0.5, 1.0))
        jlayer.bias = jnp.asarray(_x((n,), 8))
    state = {k: np.asarray(v) for k, v in jax_state_dict(jlayer).items()}
    tnn.load_state_dict(tlayer, from_jax_state(state, "cpu", tlayer))
    return jlayer, tlayer, state


def _jax_two_steps(jlayer, state, x1, x2, gy):
    """Step 1 (output, input and parameter gradients, buffers), step 2
    (buffers), evaluation on x2 with the final buffers: one jit."""
    params = {k: v for k, v in state.items() if k in ("weight", "bias")}
    bufs = {k: v for k, v in state.items() if k not in params}

    def train(p, b, x):
        out, new = jax_call(jlayer, {**p, **b}, x, training=True)
        return out, {k: new[k] for k in b}

    @jax.jit
    def run(p, b, x1, x2, gy):
        out1, vjp, b1 = jax.vjp(lambda p_, x_: train(p_, b, x_), p, x1,
                                has_aux=True)
        dp, dx = vjp(gy)
        _, b2 = train(p, b1, x2)
        ev, _ = jax_call(jlayer, {**p, **b2}, x2, training=False)
        return out1, dx, dp, b1, b2, ev

    return run(params, bufs, x1, x2, gy)


BN_CASES = [("spatial", (4, 6, 5, 5), True), ("spatial", (3, 5, 4, 7), False),
            ("flat", (16, 6), True)]


@pytest.mark.parametrize("kind,shape,affine", BN_CASES)
def test_batch_norm_train_and_eval_match_jax(kind, shape, affine):
    n = shape[1]
    jlayer, tlayer, state = _pair(kind, n, affine)
    # a mean far from 0 exercises the s2/n - mean^2 form of the variance
    x1, x2 = _x(shape, 1, 2.0, 3.0), _x(shape, 2, 0.5, -1.0)
    gy = _x(shape, 3)
    out1, dx, dp, b1, b2, ev = _jax_two_steps(jlayer, state, *map(
        jnp.asarray, (x1, x2, gy)))
    tlayer.training_mode()
    xt = torch.from_numpy(x1).requires_grad_()
    got = tlayer(xt)
    wrt = [xt] + ([tlayer.weight, tlayer.bias] if affine else [])
    grads = torch.autograd.grad(got, wrt, torch.from_numpy(gy))
    np.testing.assert_allclose(got.detach().numpy(), out1, **F32)
    np.testing.assert_allclose(grads[0].numpy(), dx, **F32)
    if affine:
        np.testing.assert_allclose(grads[1].numpy(), dp["weight"], **F32)
        np.testing.assert_allclose(grads[2].numpy(), dp["bias"], **F32)
    for k in ("running_mean", "running_var"):
        np.testing.assert_allclose(getattr(tlayer, k).numpy(), b1[k], **F32)
    with torch.no_grad():
        tlayer(torch.from_numpy(x2))
    for k in ("running_mean", "running_var"):
        np.testing.assert_allclose(getattr(tlayer, k).numpy(), b2[k], **F32)
    tlayer.evaluate()
    with torch.no_grad():
        np.testing.assert_allclose(tlayer(torch.from_numpy(x2)).numpy(), ev,
                                   **F32)


def test_batch_norm_bf16_input_keeps_f32_buffers():
    jlayer, tlayer, state = _pair("spatial", 6, True)
    x1, x2 = _x((4, 6, 5, 5), 1, 2.0, 3.0), _x((4, 6, 5, 5), 2)
    gy = _x((4, 6, 5, 5), 3)
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    out1, _, _, b1, _, _ = _jax_two_steps(jlayer, state, bf(x1), bf(x2),
                                          bf(gy))
    tlayer.training_mode()
    xt = torch.from_numpy(x1).bfloat16().requires_grad_()
    got = tlayer(xt)
    (dx,) = torch.autograd.grad(got, xt, torch.from_numpy(gy).bfloat16())
    assert got.dtype == dx.dtype == torch.bfloat16
    assert tlayer.running_mean.dtype == tlayer.running_var.dtype \
        == torch.float32
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(out1, np.float32),
                               rtol=2e-2, atol=2e-2)
    for k in ("running_mean", "running_var"):
        np.testing.assert_allclose(getattr(tlayer, k).numpy(), b1[k],
                                   rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# Inception-v2 blocks and the full build
# ---------------------------------------------------------------------------

BLOCKS = {
    # avg pool, stride 1 (3a-like)
    "avg_s1": (8, [[4], [4, 6], [4, 6], ["avg", 4]]),
    # max pool, stride 2, pass-through pool (3c-like)
    "max_s2": (8, [[0], [4, 6], [4, 6], ["max", 0]]),
    # max pool, stride 1, with projection (5b-like)
    "max_s1_proj": (8, [[6], [4, 6], [4, 6], ["max", 4]]),
}


def _block_pair(name):
    size, config = BLOCKS[name]
    jblock = jax_layer_v2(size, config, "inception_x/")
    tblock = inception_layer_v2(size, config, "inception_x/")
    state = {k: np.asarray(v) for k, v in jax_state_dict(jblock).items()}
    tnn.load_state_dict(tblock, from_jax_state(state, "cpu", tblock))
    return jblock, tblock, state


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_inception_v2_block_matches_jax(name):
    jblock, tblock, state = _block_pair(name)
    x = _x((2, 8, 12, 12), 5)

    @jax.jit
    def run(s, x):
        out, vjp = jax.vjp(
            lambda x_: jax_call(jblock, s, x_, training=True)[0], x)
        return out, vjp(jnp.ones_like(out) * 0.1 + out)[0]

    want, want_dx = run(state, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    tblock.training_mode()
    got = tblock(xt)
    (dx,) = torch.autograd.grad(got, xt, torch.ones_like(got) * 0.1
                                + got.detach())
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(dx.numpy(), want_dx, rtol=1e-4, atol=1e-4)


def test_full_width_inception_v2_state_keys_and_shapes_match():
    jstate = jax_state_dict(jax_build_v2(1000))
    tstate = tnn.state_dict(build_inception_v2(1000))
    assert list(tstate) == list(jstate)
    assert len(tstate) == 416
    assert sum(v.numel() for v in tstate.values()) == 11224840
    assert {k: tuple(v.shape) for k, v in tstate.items()} \
        == {k: tuple(v.shape) for k, v in jstate.items()}
    assert all(tstate[k].dtype == torch.float32 for k in tstate
               if k.endswith(("running_mean", "running_var")))
