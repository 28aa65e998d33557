"""Randomized-config criterion fuzz vs torch — forward LOSS and
backward GRADINPUT across sampled shapes, weights, and size_average
settings (the reduction/weighting algebra is where criterion
implementations quietly diverge; the optimizer fuzz caught exactly such
a divergence in SGD dampening)."""

import numpy as np
import pytest
import torch

import bigdl_tpu.nn as nn


def _cmp(ours_loss, ours_grad, t_loss, t_grad, tag, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(float(ours_loss), float(t_loss.detach()),
                               rtol=rtol, atol=atol, err_msg=f"{tag} loss")
    np.testing.assert_allclose(np.asarray(ours_grad), t_grad.numpy(),
                               rtol=rtol, atol=atol, err_msg=f"{tag} grad")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_classnll_fuzz(seed):
    rng = np.random.RandomState(800 + seed)
    for _ in range(6):
        n, c = int(rng.randint(2, 9)), int(rng.randint(2, 7))
        size_avg = bool(rng.randint(0, 2))
        use_w = bool(rng.randint(0, 2))
        w = (rng.rand(c).astype(np.float32) + 0.2) if use_w else None
        logits = rng.randn(n, c).astype(np.float32)
        logp = logits - np.log(np.exp(logits).sum(1, keepdims=True))
        y = rng.randint(0, c, n)

        crit = nn.ClassNLLCriterion(weights=w, size_average=size_avg)
        loss = crit.forward(logp, y)
        grad = crit.backward(logp, y)

        tx = torch.tensor(logp, requires_grad=True)
        tcrit = torch.nn.NLLLoss(
            weight=None if w is None else torch.tensor(w),
            reduction="mean" if size_avg else "sum")
        tl = tcrit(tx, torch.tensor(y))
        tl.backward()
        _cmp(loss, grad, tl, tx.grad, f"nll avg={size_avg} w={use_w}")


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.slow
def test_elementwise_criterion_fuzz(seed):
    """MSE / Abs(L1) / SmoothL1 / BCE / KLDiv over random shapes and
    size_average."""
    rng = np.random.RandomState(900 + seed)
    for _ in range(8):
        shape = tuple(int(rng.randint(2, 6))
                      for _ in range(int(rng.randint(1, 4))))
        size_avg = bool(rng.randint(0, 2))
        red = "mean" if size_avg else "sum"
        x = rng.randn(*shape).astype(np.float32)
        t = rng.randn(*shape).astype(np.float32)

        cases = [
            (nn.MSECriterion(size_average=size_avg),
             torch.nn.MSELoss(reduction=red), x, t),
            (nn.AbsCriterion(size_average=size_avg),
             torch.nn.L1Loss(reduction=red), x, t),
            (nn.SmoothL1Criterion(size_average=size_avg),
             torch.nn.SmoothL1Loss(reduction=red), x, t),
        ]
        # BCE needs inputs in (0,1); KLDiv wants log-probs vs probs
        p = 1.0 / (1.0 + np.exp(-x))
        tgt01 = (t > 0).astype(np.float32)
        cases.append((nn.BCECriterion(size_average=size_avg),
                      torch.nn.BCELoss(reduction=red), p, tgt01))
        logq = np.log(np.abs(x) / np.abs(x).sum() + 1e-8).astype(np.float32)
        pr = (np.abs(t) / np.abs(t).sum()).astype(np.float32)
        cases.append((nn.DistKLDivCriterion(size_average=size_avg),
                      torch.nn.KLDivLoss(reduction=red), logq, pr))

        for crit, tcrit, xi, ti in cases:
            loss = crit.forward(xi, ti)
            grad = crit.backward(xi, ti)
            tx = torch.tensor(xi, requires_grad=True)
            tl = tcrit(tx, torch.tensor(ti))
            tl.backward()
            _cmp(loss, grad, tl, tx.grad,
                 f"{type(crit).__name__} avg={size_avg} shape={shape}",
                 rtol=2e-4, atol=2e-5)
