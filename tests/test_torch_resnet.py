"""ResNet of the port against the JAX package: the shortcut types, the
basic and bottleneck blocks at narrow widths and the CIFAR ResNet-8,
forward and backward in training mode from the same weights, and the
full-width ResNet-50's ``state_dict`` (built only: a CPU forward at 224
is too slow for tier-1).

Inputs and output gradients come from a numpy seed; the JAX results of
every case come from one jitted call.  Tolerances: forward outputs
rtol 1e-5 / atol 1e-6, input and parameter gradients 1e-4 (the
convolutions sum in another order).  Every convolution of a ResNet feeds
a batch norm, which removes any shift, so a convolution's bias has a
gradient of exactly 0: both packages return rounding noise there, and
the test holds both below 1e-3 of the largest gradient of the same
convolution's weight instead of against each other.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu.models import resnet as jax_resnet
from bigdl_tpu.nn.module import functional_call as jax_call
from bigdl_tpu.nn.module import state_dict as jax_state_dict
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.models import resnet
from bigdl_tpu_torch.utils.convert import from_jax_state
from test_torch_slice import one_thread  # noqa: F401

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-4)


def _x(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


#: name -> (builder taking the package's resnet module, input shape)
CASES = {
    "shortcut_A": (lambda m: m.basic_block(4, 8, 2, "A"), (2, 4, 8, 8)),
    "shortcut_B": (lambda m: m.basic_block(4, 8, 2, "B"), (2, 4, 8, 8)),
    "shortcut_C": (lambda m: m.basic_block(8, 8, 1, "C"), (2, 8, 6, 6)),
    "basic_identity": (lambda m: m.basic_block(6, 6, 1, "B"), (2, 6, 6, 6)),
    "bottleneck_B": (lambda m: m.bottleneck(8, 4, 2, "B"), (2, 8, 8, 8)),
    "bottleneck_identity": (lambda m: m.bottleneck(16, 4, 1, "B"),
                            (2, 16, 5, 5)),
    "resnet8": (lambda m: m.build_resnet_cifar(8), (4, 3, 32, 32)),
}


@pytest.fixture(scope="module")
def results():
    """For every case: the port module with the JAX weights, the input,
    the output gradient and the JAX (out, dx, dparams) in training
    mode, all JAX results from one jit."""
    jmods, inputs, states = {}, {}, {}
    for i, (name, (build, shape)) in enumerate(CASES.items()):
        jmods[name] = build(jax_resnet)
        states[name] = {k: np.asarray(v)
                        for k, v in jax_state_dict(jmods[name]).items()}
        inputs[name] = _x(shape, i)

    def one(name, params, bufs, x):
        def f(p, x_):
            return jax_call(jmods[name], {**p, **bufs}, x_,
                            training=True)[0]
        out, vjp = jax.vjp(f, params, x)
        dp, dx = vjp(jnp.ones_like(out) * 0.1 + out)
        return out, dx, dp

    @jax.jit
    def run(params, bufs, xs):
        return {n: one(n, params[n], bufs[n], xs[n]) for n in CASES}

    params = {n: {k: v for k, v in s.items() if "running" not in k}
              for n, s in states.items()}
    bufs = {n: {k: v for k, v in s.items() if "running" in k}
            for n, s in states.items()}
    want = run(params, bufs, inputs)
    out = {}
    for name, (build, _) in CASES.items():
        tmod = build(resnet)
        tnn.load_state_dict(tmod, from_jax_state(states[name], "cpu", tmod))
        out[name] = (tmod, inputs[name], want[name])
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_resnet_block_forward_and_gradients_match_jax(results, name):
    tmod, x, (want, want_dx, want_dp) = results[name]
    xt = torch.from_numpy(x).requires_grad_()
    tmod.training_mode()
    got = tmod(xt)
    params = tnn.parameters(tmod)
    grads = torch.autograd.grad(got, [xt] + list(params.values()),
                                torch.ones_like(got) * 0.1 + got.detach())
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, **FWD)
    np.testing.assert_allclose(grads[0].numpy(), want_dx, **GRAD)
    assert set(params) == set(want_dp)
    for (k, _), g in zip(params.items(), grads[1:]):
        owner = tmod.get_submodule(k.rpartition(".")[0])
        if k.endswith(".bias") and isinstance(owner, tnn.SpatialConvolution):
            scale = np.abs(want_dp[k[:-len("bias")] + "weight"]).max()
            assert np.abs(g.numpy()).max() <= 1e-3 * scale, k
            assert np.abs(want_dp[k]).max() <= 1e-3 * scale, k
            continue
        np.testing.assert_allclose(g.numpy(), want_dp[k], err_msg=k, **GRAD)


def test_shortcut_types_pick_the_jax_modules():
    # A pads, B projects only where the shape changes, C always projects
    assert isinstance(resnet._shortcut(4, 8, 2, "A", None),
                      resnet._ZeroPadShortcut)
    assert isinstance(resnet._shortcut(8, 8, 1, "A", None), tnn.Identity)
    assert isinstance(resnet._shortcut(8, 8, 1, "B", None), tnn.Identity)
    assert isinstance(resnet._shortcut(4, 8, 1, "B", None), tnn.Sequential)
    assert isinstance(resnet._shortcut(8, 8, 1, "C", None), tnn.Sequential)
    with pytest.raises(ValueError, match="6n\\+2"):
        resnet.build_resnet_cifar(9)


def test_full_width_resnet50_state_keys_and_shapes_match():
    jstate = jax_state_dict(jax_resnet.build_resnet(50))
    tstate = tnn.state_dict(resnet.build_resnet(50))
    assert list(tstate) == list(jstate)
    assert len(tstate) == 320
    assert sum(v.numel() for v in tstate.values()) == 25636712
    assert {k: tuple(v.shape) for k, v in tstate.items()} \
        == {k: tuple(v.shape) for k, v in jstate.items()}
