"""The port's attention ops against the JAX package's: the plain
versions of the three flash kernels against the Pallas kernels in
interpret mode, the dense version, and the backend rule.

Inputs come from a numpy seed, f32.  Tolerances: flash outputs, lse and
gradients agree to rtol 1e-5 / atol 1e-5 (the port sums each product in
one pass where Pallas walks 16-wide blocks with an online softmax, so
the two round differently); the dense version to 1e-5 / 1e-6.  The
float64 gradcheck holds the port's autograd function to its own finite
differences.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu.ops import attention as jatt
from bigdl_tpu_torch import ops
from bigdl_tpu_torch.ops import _build
from bigdl_tpu_torch.ops import attention as tatt
from test_torch_slice import one_thread  # noqa: F401

BLOCK = 16  # the Pallas block for q and k: S = 32 walks two of each
TOL = dict(rtol=1e-5, atol=1e-5)

# (sq, sk, causal); 48/16 causal has rows that see no key
FLASH_CASES = [(32, 32, True), (32, 32, False), (16, 48, True),
               (48, 16, True)]


def _qkv(sq, sk, d=16, h=2, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(1, h, s, d).astype(np.float32)
            for s in (sq, sk, sk, sq)]


@pytest.fixture(scope="module", params=FLASH_CASES,
                ids=[f"{sq}x{sk}{'-causal' if c else ''}"
                     for sq, sk, c in FLASH_CASES])
def flash_case(request):
    """One case's inputs and the JAX results: the forward rule of
    ``flash_attention``'s custom VJP, (out, lse), and its backward rule
    at ``do`` (what ``jax.vjp`` of ``flash_attention`` runs), both in
    Pallas interpret mode, under one jit so they share a compile and the
    forward is traced once."""
    sq, sk, causal = request.param
    q, k, v, do = _qkv(sq, sk)
    scale = 1.0 / np.sqrt(q.shape[-1])
    hyper = (float(scale), causal, BLOCK, BLOCK, True)

    def run(q_, k_, v_, do_):
        out, res = jatt._flash_fwd_rule(q_, k_, v_, *hyper)
        return out, res[4], jatt._flash_bwd_rule(*hyper, res, do_)

    out, lse, grads = jax.jit(run)(*map(jnp.asarray, (q, k, v, do)))
    return dict(inputs=(q, k, v, do), scale=float(scale), causal=causal,
                out=np.asarray(out), lse=np.asarray(lse),
                grads=[np.asarray(g) for g in grads])


def test_flash_fwd_plain_matches_the_pallas_forward(flash_case):
    q, k, v, _ = map(torch.from_numpy, flash_case["inputs"])
    out, lse = tatt.flash_fwd_plain(q, k, v, flash_case["scale"],
                                    flash_case["causal"])
    assert out.dtype == torch.float32 and lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), flash_case["out"], **TOL)
    np.testing.assert_allclose(lse.numpy(), flash_case["lse"], **TOL)


def test_flash_bwd_plain_matches_the_jax_vjp(flash_case):
    q, k, v, do = map(torch.from_numpy, flash_case["inputs"])
    scale, causal = flash_case["scale"], flash_case["causal"]
    out, lse = tatt.flash_fwd_plain(q, k, v, scale, causal)
    delta = (do * out).sum(-1)
    got = tatt.flash_bwd_plain(q, k, v, out, lse, do, delta, scale, causal)
    for name, g, want in zip(("dq", "dk", "dv"), got, flash_case["grads"]):
        np.testing.assert_allclose(g.numpy(), want, err_msg=name, **TOL)
    # the autograd function reaches the same gradients through the
    # wrappers (the CPU runs their plain versions)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    tatt.flash_attention(*leaves, causal=causal).backward(do)
    for name, t, want in zip(("dq", "dk", "dv"), leaves,
                             flash_case["grads"]):
        np.testing.assert_allclose(t.grad.numpy(), want, err_msg=name, **TOL)


def test_rows_that_see_no_key_output_zero():
    q, k, v, do = map(torch.from_numpy, _qkv(48, 16))
    out, lse = tatt.flash_fwd_plain(q, k, v, 0.25, True)
    # row i sees keys up to i - 32: rows 0..31 see none
    assert torch.equal(out[:, :, :32], torch.zeros_like(out[:, :, :32]))
    assert torch.all(lse[:, :, :32] == torch.tensor(-1e30))
    delta = (do * out).sum(-1)
    dq, _, _ = tatt.flash_bwd_plain(q, k, v, out, lse, do, delta, 0.25, True)
    assert torch.equal(dq[:, :, :32], torch.zeros_like(dq[:, :, :32]))


@pytest.mark.parametrize("sq,sk,causal", [(3, 5, True), (5, 3, True),
                                          (4, 4, False)])
def test_flash_attention_passes_gradcheck_in_f64(sq, sk, causal):
    q, k, v, _ = _qkv(sq, sk, d=4, h=1, seed=1)
    leaves = [torch.from_numpy(a).double().requires_grad_() for a in (q, k, v)]
    assert torch.autograd.gradcheck(
        lambda a, b, c: tatt.flash_attention(a, b, c, causal=causal), leaves)


def test_dot_product_attention_matches_jax():
    q, k, v, _ = _qkv(6, 6, d=8, seed=2)
    mask = np.random.RandomState(3).rand(1, 1, 6, 6) > 0.3
    mask[..., 4, :] = False   # a row with every key masked outputs 0
    for causal in (False, True):
        want = jax.jit(functools.partial(jatt.dot_product_attention,
                                         causal=causal))(
            *map(jnp.asarray, (q, k, v)), mask=jnp.asarray(mask))
        got = tatt.dot_product_attention(
            *map(torch.from_numpy, (q, k, v)), mask=torch.from_numpy(mask),
            causal=causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)
        assert torch.equal(got[..., 4, :], torch.zeros_like(got[..., 4, :]))
    # sq != sk: the causal offset is sk - sq, as in JAX
    q, k, v, _ = _qkv(3, 7, d=8, seed=4)
    want = jax.jit(functools.partial(jatt.dot_product_attention,
                                     causal=True))(*map(jnp.asarray, (q, k, v)))
    got = tatt.dot_product_attention(*map(torch.from_numpy, (q, k, v)),
                                     causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_select_attention_backend_follows_the_jax_rule(monkeypatch):
    """On the card the port's rule is the JAX rule on a TPU, threshold
    512; off the card (the CPU) ``auto`` is dense, as JAX off-TPU."""
    monkeypatch.delenv("BIGDL_KERNELS", raising=False)
    monkeypatch.delenv("BIGDL_FLASH_MIN_SEQ", raising=False)
    monkeypatch.setattr(jatt, "is_tpu_device", lambda: True)
    assert tatt.flash_min_seq() == jatt.flash_min_seq() == 512
    for sq in (1, 128, 511, 512, 1024):
        for sk in (1, 256, 511, 512, 4096):
            for masked in (False, True):
                want = jatt.select_attention_backend(sq, sk, masked)[0]
                got = tatt.select_attention_backend(sq, sk, masked,
                                                    torch.device("cuda"))
                assert got[0] == want, (sq, sk, masked)
                cpu = tatt.select_attention_backend(sq, sk, masked, "cpu")
                assert cpu[0] == "dense"
    assert tatt.select_attention_backend(512, 512, False, "cuda") \
        == ("flash", "auto:cuda")


class _CudaTyped(torch.Tensor):
    """A CPU tensor that reports a CUDA device: what the wrappers read of
    a card's tensor, made without a card."""

    @property
    def device(self):
        return torch.device("cuda")


def _cuda_typed(shape):
    return torch.zeros(shape).as_subclass(_CudaTyped)


def test_a_cuda_tensor_reaches_the_kernel_or_raises(monkeypatch):
    def plain(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain version")

    def no_build(*args, **kwargs):
        raise RuntimeError("no card to build for")

    for name in ("flash_fwd_plain", "_dq_plain", "_dkv_plain"):
        monkeypatch.setattr(tatt, name, plain)
    monkeypatch.setattr(_build, "library", no_build)
    ops.reset_kernel_launches()
    q = _cuda_typed((1, 2, 8, 16))
    lse = _cuda_typed((1, 2, 8))
    with pytest.raises(RuntimeError, match="no card"):
        tatt.flash_fwd(q, q, q, 0.25, True)
    with pytest.raises(RuntimeError, match="no card"):
        tatt.flash_dq(q, q, q, q, lse, lse, 0.25, True)
    with pytest.raises(RuntimeError, match="no card"):
        tatt.flash_dkv(q, q, q, q, lse, lse, 0.25, True)
    # what the kernels cannot take raises before any build
    wide = _cuda_typed((1, 1, 8, 160))
    with pytest.raises(ValueError, match="D at most 128"):
        tatt.flash_fwd(wide, wide, wide, 0.25, False)
    with pytest.raises(ValueError, match="contiguous"):
        t = q.transpose(2, 3)
        tatt.flash_fwd(t, t, t, 0.25, False)
    assert ops.kernel_launches()["flash_fwd"] == 0


def test_kernel_wrappers_cover_the_flash_kernels():
    wrappers = ops.kernel_wrappers()
    assert wrappers["flash_fwd"] is tatt.flash_fwd
    assert wrappers["flash_dq"] is tatt.flash_dq
    assert wrappers["flash_dkv"] is tatt.flash_dkv
    assert set(_build.SOURCES) >= {"flash_fwd", "flash_dq", "flash_dkv"}
