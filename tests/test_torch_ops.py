"""The port's kernel ops (forward and backward) against the JAX
package's Pallas kernels.

``bigdl_tpu_torch.ops`` holds a CUDA kernel and a plain PyTorch version
per op; on the CPU (this suite) the wrapper runs the plain version.  It
is held here to the JAX op's Pallas leg, which runs in interpret mode on
the CPU under ``BIGDL_KERNELS=pallas`` (as ``tests/test_kernels.py``
runs it), on inputs made from a numpy seed.  f32 at rtol 1e-5 / atol
1e-6 (the two sum the same terms in the same order; exp/log differ by
an ulp); bf16 at 2e-2, the slack ``test_kernels.py`` gives bf16.  The
CUDA kernels themselves are held to these plain versions on the card by
``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu.nn.layers import pooling as jax_pooling
from bigdl_tpu.ops import pool_pallas as jax_pool
from bigdl_tpu.ops.lrn_pallas import cross_map_lrn
from bigdl_tpu_torch import resolve_device
from bigdl_tpu_torch.nn.layers.pooling import _axis_padding
from bigdl_tpu_torch.ops import (_build, kernel_launches, lrn, pool,
                                 reset_kernel_launches)
from test_torch_slice import one_thread  # noqa: F401


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# ---------------------------------------------------------------------------
# cross-map LRN forward
# ---------------------------------------------------------------------------

LRN_CASES = [
    # (shape, size, alpha, beta, k)
    ((2, 7, 5, 5), 5, 1e-4, 0.75, 1.0),   # band wider than half the channels
    ((2, 7, 5, 5), 3, 0.5, 0.5, 2.0),     # rsqrt branch
    ((1, 8, 6, 4), 5, 1.0, 0.5, 1.0),
    ((1, 8, 6, 4), 3, 2.0, 0.75, 2.0),
]


@pytest.mark.parametrize("shape,size,alpha,beta,k", LRN_CASES)
def test_cross_map_lrn_matches_pallas(shape, size, alpha, beta, k,
                                      monkeypatch):
    monkeypatch.setenv("BIGDL_KERNELS", "pallas")
    x = _x(shape)
    want = np.asarray(cross_map_lrn(jnp.asarray(x), size, alpha, beta, k))
    got = lrn.cross_map_lrn_forward(torch.from_numpy(x), size, alpha, beta, k)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_cross_map_lrn_den_matches_pallas(monkeypatch):
    from bigdl_tpu.ops.lrn_pallas import _cml_fwd_pallas

    monkeypatch.setenv("BIGDL_KERNELS", "pallas")
    x = _x((2, 7, 5, 5), seed=3)
    want_y, want_den = _cml_fwd_pallas(jnp.asarray(x), 5, 1.0, 0.75, 2.0)
    y, den = lrn.cross_map_lrn_forward(torch.from_numpy(x), 5, 1.0, 0.75,
                                       2.0, want_den=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(den.numpy(), np.asarray(want_den),
                               rtol=1e-5, atol=1e-6)


def test_cross_map_lrn_bf16_matches_pallas(monkeypatch):
    monkeypatch.setenv("BIGDL_KERNELS", "pallas")
    x = _x((2, 8, 8, 8), seed=2)
    want = cross_map_lrn(jnp.asarray(x, jnp.bfloat16), 5, 1e-4, 0.75, 1.0)
    got = lrn.cross_map_lrn_forward(torch.from_numpy(x).bfloat16(), 5, 1e-4,
                                    0.75, 1.0)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


# ---------------------------------------------------------------------------
# average-pool forward (Torch divisor semantics)
# ---------------------------------------------------------------------------

def _geom(shape, k, s, p, ceil):
    """(dims, strides, pads, declared) as SpatialAveragePooling builds
    them, with the JAX package's padding rule held equal on the way."""
    dims, strides = (1, 1, k, k), (1, 1, s, s)
    pads, declared = [(0, 0), (0, 0)], [(0, 0), (0, 0)]
    for n in shape[2:]:
        lo, hi, dhi = _axis_padding(n, k, s, p, ceil)
        assert (lo, hi, dhi) == jax_pooling._axis_padding(n, k, s, p, ceil)
        pads.append((lo, hi))
        declared.append((lo, dhi))
    return dims, strides, tuple(pads), tuple(declared)


POOL_CASES = [
    # (shape, k, s, pad, ceil)
    ((2, 3, 7, 7), 7, 1, 0, False),     # the Inception-v1 head
    ((1, 2, 14, 14), 5, 3, 0, True),    # aux head: ceil overflow of 1
    ((2, 2, 10, 11), 3, 2, 1, True),    # declared pad 1 + overflow 1 on H
    ((1, 3, 9, 8), 2, 2, 0, True),      # odd H overflows, even W does not
]


@pytest.mark.parametrize("count_include_pad", [True, False])
@pytest.mark.parametrize("shape,k,s,p,ceil", POOL_CASES)
def test_avg_pool_matches_pallas(shape, k, s, p, ceil, count_include_pad,
                                 monkeypatch):
    monkeypatch.setenv("BIGDL_KERNELS", "pallas")
    dims, strides, pads, declared = _geom(shape, k, s, p, ceil)
    key = (shape, dims, strides, pads, declared, count_include_pad)
    # the divisor map is the JAX package's, value for value
    np.testing.assert_array_equal(pool._np_inv_counts(*key),
                                  jax_pool._np_inv_counts(*key))
    x = _x(shape, seed=9)
    want = np.asarray(jax_pool.avg_pool(jnp.asarray(x), dims, strides, pads,
                                        declared, count_include_pad, True))
    got = pool.avg_pool_forward(torch.from_numpy(x), dims, strides, pads,
                                declared, count_include_pad)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("k,s", [((1, 3), (1, 2)), ((3, 1), (2, 1))])
def test_avg_pool_kernel_divisor_plane_covers_the_output(k, s):
    """The kernel reads inv[oy * ow + ox]: an axis the window leaves
    alone (k 1, stride 1) must still span its output extent."""
    shape = (1, 2, 5, 6)
    dims, strides = (1, 1) + k, (1, 1) + s
    pads = ((0, 0),) * 4
    key = (shape, dims, strides, pads, pads, True)
    oh, ow = pool._out_sizes(shape, dims, strides, pads)[2:]
    plane = pool._device_inv(key, torch.device("cpu"))
    assert tuple(plane.shape) == (oh, ow) and plane.is_contiguous()
    want = np.broadcast_to(pool._np_inv_counts(*key), (1, 1, oh, ow))[0, 0]
    np.testing.assert_array_equal(plane.numpy(), want.astype(np.float32))


def test_avg_pool_bf16_matches_pallas(monkeypatch):
    monkeypatch.setenv("BIGDL_KERNELS", "pallas")
    shape = (2, 4, 14, 14)
    dims, strides, pads, declared = _geom(shape, 5, 3, 0, True)
    x = _x(shape, seed=4)
    want = jax_pool.avg_pool(jnp.asarray(x, jnp.bfloat16), dims, strides,
                             pads, declared, True, True)
    got = pool.avg_pool_forward(torch.from_numpy(x).bfloat16(), dims,
                                strides, pads, declared, True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


# ---------------------------------------------------------------------------
# backward: against jax.vjp of the JAX ops (Pallas legs, interpret mode)
# ---------------------------------------------------------------------------

LRN_BWD_CASES = [
    # (shape, size, alpha, beta, k)
    ((2, 7, 5, 5), 5, 1.0, 0.75, 1.0),
    ((2, 7, 5, 5), 3, 0.5, 0.5, 2.0),     # rsqrt branch of den^-beta
    ((1, 8, 6, 4), 5, 2.0, 0.5, 1.0),
    ((1, 8, 6, 4), 3, 1e-4, 0.75, 1.0),
]


def _lrn_vjp(x, g, size, alpha, beta, k, dtype=jnp.float32):
    _, vjp = jax.vjp(lambda a: cross_map_lrn(a, size, alpha, beta, k),
                     jnp.asarray(x, dtype))
    return vjp(jnp.asarray(g, dtype))[0]


@pytest.mark.parametrize("shape,size,alpha,beta,k", LRN_BWD_CASES)
def test_cross_map_lrn_backward_matches_pallas_vjp(shape, size, alpha, beta,
                                                   k, monkeypatch):
    monkeypatch.setenv("BIGDL_KERNELS", "pallas")
    x, g = _x(shape, seed=5), _x(shape, seed=6)
    want = np.asarray(_lrn_vjp(x, g, size, alpha, beta, k))
    xt = torch.from_numpy(x).requires_grad_()
    y = lrn.cross_map_lrn(xt, size, alpha, beta, k)
    (got,) = torch.autograd.grad(y, xt, torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    # the plain version alone, from the forward's den
    _, den = lrn.cross_map_lrn_plain(xt.detach(), size, alpha, beta, k)
    plain = lrn.cross_map_lrn_backward_plain(
        xt.detach(), den, torch.from_numpy(g), size, alpha, beta)
    np.testing.assert_array_equal(plain.numpy(), got.numpy())


def test_cross_map_lrn_backward_bf16_matches_pallas_vjp(monkeypatch):
    monkeypatch.setenv("BIGDL_KERNELS", "pallas")
    x, g = _x((2, 8, 6, 6), seed=7), _x((2, 8, 6, 6), seed=8)
    want = _lrn_vjp(x, g, 5, 1.0, 0.75, 1.0, jnp.bfloat16)
    xt = torch.from_numpy(x).bfloat16().requires_grad_()
    y = lrn.cross_map_lrn(xt, 5, 1.0, 0.75, 1.0)
    (got,) = torch.autograd.grad(y, xt, torch.from_numpy(g).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


POOL_BWD_CASES = [
    # (shape, k, s, pad, ceil)
    ((2, 3, 7, 7), 7, 1, 0, False),     # the Inception-v1 head
    ((1, 2, 14, 14), 5, 3, 0, True),    # aux head: ceil overflow of 1
    ((2, 2, 10, 11), 3, 2, 1, True),    # declared pad 1 + overflow 1 on H
    ((1, 2, 8, 9), 3, 2, 0, False),     # floor mode: W's last column unread
]


def _pool_vjp(x, gy, dims, strides, pads, declared, cip, dtype=jnp.float32):
    _, vjp = jax.vjp(lambda a: jax_pool.avg_pool(a, dims, strides, pads,
                                                 declared, cip, True),
                     jnp.asarray(x, dtype))
    return vjp(jnp.asarray(gy, dtype))[0]


@pytest.mark.parametrize("count_include_pad", [True, False])
@pytest.mark.parametrize("shape,k,s,p,ceil", POOL_BWD_CASES)
def test_avg_pool_backward_matches_pallas_vjp(shape, k, s, p, ceil,
                                              count_include_pad, monkeypatch):
    monkeypatch.setenv("BIGDL_KERNELS", "pallas")
    dims, strides, pads, declared = _geom(shape, k, s, p, ceil)
    x = _x(shape, seed=10)
    xt = torch.from_numpy(x).requires_grad_()
    y = pool.avg_pool(xt, dims, strides, pads, declared, count_include_pad)
    gy = _x(tuple(y.shape), seed=11)
    want = np.asarray(_pool_vjp(x, gy, dims, strides, pads, declared,
                                count_include_pad))
    (got,) = torch.autograd.grad(y, xt, torch.from_numpy(gy))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_avg_pool_backward_bf16_matches_pallas_vjp(monkeypatch):
    monkeypatch.setenv("BIGDL_KERNELS", "pallas")
    shape = (2, 4, 14, 14)
    dims, strides, pads, declared = _geom(shape, 5, 3, 0, True)
    xt = torch.from_numpy(_x(shape, seed=12)).bfloat16().requires_grad_()
    y = pool.avg_pool(xt, dims, strides, pads, declared, True)
    gy = _x(tuple(y.shape), seed=13)
    want = _pool_vjp(xt.detach().float().numpy(), gy, dims, strides, pads,
                     declared, True, jnp.bfloat16)
    (got,) = torch.autograd.grad(y, xt, torch.from_numpy(gy).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


def test_backward_functions_pass_gradcheck_in_f64():
    x = torch.from_numpy(_x((1, 6, 3, 4), seed=14)).double().requires_grad_()
    assert torch.autograd.gradcheck(
        lambda a: lrn.cross_map_lrn(a, 5, 0.7, 0.75, 1.5), (x,))
    dims, strides, pads, declared = _geom((1, 2, 7, 8), 3, 2, 1, True)
    x = torch.from_numpy(_x((1, 2, 7, 8), seed=15)).double().requires_grad_()
    assert torch.autograd.gradcheck(
        lambda a: pool.avg_pool(a, dims, strides, pads, declared, False),
        (x,))


# ---------------------------------------------------------------------------
# routing: CPU tensors never reach a kernel; CUDA entry points need CUDA
# ---------------------------------------------------------------------------

def test_cpu_tensors_never_touch_the_kernels(monkeypatch):
    monkeypatch.setattr(lrn.cross_map_lrn_forward, "launches", 0)
    monkeypatch.setattr(pool.avg_pool_forward, "launches", 0)
    monkeypatch.setattr(_build, "build", _forbidden_build)
    x = torch.from_numpy(_x((2, 6, 7, 7)))
    lrn.cross_map_lrn_forward(x, 5, 1e-4, 0.75, 1.0)
    dims, strides, pads, declared = _geom(tuple(x.shape), 7, 1, 0, False)
    pool.avg_pool_forward(x, dims, strides, pads, declared, True)
    assert lrn.cross_map_lrn_forward.launches == 0
    assert pool.avg_pool_forward.launches == 0


def test_cpu_backward_never_touches_the_kernels(monkeypatch):
    reset_kernel_launches()
    monkeypatch.setattr(_build, "build", _forbidden_build)
    x = torch.from_numpy(_x((2, 6, 7, 7))).requires_grad_()
    dims, strides, pads, declared = _geom(tuple(x.shape), 7, 1, 0, False)
    loss = lrn.cross_map_lrn(x, 5, 1e-4, 0.75, 1.0).sum() \
        + pool.avg_pool(x, dims, strides, pads, declared, True).sum()
    loss.backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
    assert kernel_launches() == {"cross_map_lrn_fwd": 0,
                                 "cross_map_lrn_bwd": 0,
                                 "avg_pool_fwd": 0, "avg_pool_bwd": 0,
                                 "flash_fwd": 0, "flash_dq": 0,
                                 "flash_dkv": 0, "maxpool_fwd": 0,
                                 "maxpool_tie_bwd": 0,
                                 "maxpool_argmax_bwd": 0}


def _forbidden_build(*args, **kwargs):
    raise AssertionError("a CPU tensor reached the kernel build")


def test_cuda_entry_points_raise_without_cuda(monkeypatch):
    from bigdl_tpu_torch.models import cli
    from bigdl_tpu_torch.serving import BucketedExecutor

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BucketedExecutor(torch.nn.Identity())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["serve", "--port", "0", "--num-classes", "10"])
    assert resolve_device("cpu") == torch.device("cpu")
