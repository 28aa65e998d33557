"""ResNet, ported from ``bigdl_tpu/models/resnet.py``
(``models/resnet/ResNet.scala``): the CIFAR-10 variant (depth 6n+2,
basic blocks) and the ImageNet ResNet-18/34/50/101/152 (basic or
bottleneck blocks), with shortcut types A (zero-pad identity), B (1x1
convolution where the shape changes) and C (1x1 convolution always).

The module tree is the JAX package's, so ``state_dict`` keys are equal
and weights cross by key.  The head's ``SpatialAveragePooling`` (8x8 on
CIFAR, 7x7 on ImageNet) runs the average-pool kernels on the card; the
ImageNet stem's 3x3 s2 max pool takes the default path (no kernel), as
in the JAX package.  Not ported: ``scan`` (the stacked-stage
``ScanLayers`` build).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.nn.module import Module

__all__ = ["build_resnet", "build_resnet_cifar", "basic_block", "bottleneck"]


class _ZeroPadShortcut(Module):
    """Shortcut type A: subsample by the stride, then zero-pad the
    channels (ResNet.scala shortcut 'A')."""

    def __init__(self, n_in: int, n_out: int, stride: int):
        super().__init__()
        self.n_in, self.n_out, self.stride = n_in, n_out, stride

    def forward(self, x):
        x = x[:, :, ::self.stride, ::self.stride]
        pad = self.n_out - self.n_in
        if pad > 0:
            x = F.pad(x, (0, 0, 0, 0, 0, pad))
        return x


def _shortcut(n_in: int, n_out: int, stride: int, shortcut_type: str,
              generator: Optional[torch.Generator]) -> Module:
    use_conv = shortcut_type == "C" or (
        shortcut_type == "B" and (n_in != n_out or stride != 1))
    if use_conv:
        return nn.Sequential(
            nn.SpatialConvolution(n_in, n_out, 1, 1, stride, stride,
                                  generator=generator),
            nn.SpatialBatchNormalization(n_out))
    if n_in != n_out or stride != 1:
        return _ZeroPadShortcut(n_in, n_out, stride)
    return nn.Identity()


def _residual(body: Module, shortcut: Module) -> Module:
    return nn.Sequential(nn.ConcatTable().add(body).add(shortcut),
                         nn.CAddTable(True), nn.ReLU(True))


def basic_block(n_in: int, n: int, stride: int, shortcut_type: str = "B",
                generator: Optional[torch.Generator] = None) -> Module:
    g = generator
    body = nn.Sequential(
        nn.SpatialConvolution(n_in, n, 3, 3, stride, stride, 1, 1,
                              generator=g),
        nn.SpatialBatchNormalization(n),
        nn.ReLU(True),
        nn.SpatialConvolution(n, n, 3, 3, 1, 1, 1, 1, generator=g),
        nn.SpatialBatchNormalization(n))
    return _residual(body, _shortcut(n_in, n, stride, shortcut_type, g))


def bottleneck(n_in: int, n: int, stride: int, shortcut_type: str = "B",
               generator: Optional[torch.Generator] = None) -> Module:
    g = generator
    n_out = n * 4
    body = nn.Sequential(
        nn.SpatialConvolution(n_in, n, 1, 1, 1, 1, generator=g),
        nn.SpatialBatchNormalization(n),
        nn.ReLU(True),
        nn.SpatialConvolution(n, n, 3, 3, stride, stride, 1, 1,
                              generator=g),
        nn.SpatialBatchNormalization(n),
        nn.ReLU(True),
        nn.SpatialConvolution(n, n_out, 1, 1, 1, 1, generator=g),
        nn.SpatialBatchNormalization(n_out))
    return _residual(body, _shortcut(n_in, n_out, stride, shortcut_type, g))


_IMAGENET_CFGS = {
    18: ([2, 2, 2, 2], basic_block, 512),
    34: ([3, 4, 6, 3], basic_block, 512),
    50: ([3, 4, 6, 3], bottleneck, 2048),
    101: ([3, 4, 23, 3], bottleneck, 2048),
    152: ([3, 8, 36, 3], bottleneck, 2048),
}


def build_resnet(depth: int = 50, class_num: int = 1000,
                 shortcut_type: str = "B",
                 generator: Optional[torch.Generator] = None) -> Module:
    """ImageNet ResNet (``ResNet.scala`` apply, dataset=ImageNet) on
    [b, 3, 224, 224]."""
    counts, block, n_features = _IMAGENET_CFGS[depth]
    g = generator
    m = nn.Sequential(
        nn.SpatialConvolution(3, 64, 7, 7, 2, 2, 3, 3, generator=g),
        nn.SpatialBatchNormalization(64),
        nn.ReLU(True),
        nn.SpatialMaxPooling(3, 3, 2, 2, 1, 1))
    n_in = 64
    for stage, (w, count) in enumerate(zip([64, 128, 256, 512], counts)):
        for i in range(count):
            stride = 2 if stage > 0 and i == 0 else 1
            m.add(block(n_in, w, stride, shortcut_type, g))
            n_in = w * 4 if block is bottleneck else w
    m.add(nn.SpatialAveragePooling(7, 7, 1, 1))
    m.add(nn.View(n_features).set_num_input_dims(3))
    m.add(nn.Linear(n_features, class_num, generator=g))
    m.add(nn.LogSoftMax())
    return m


def build_resnet_cifar(depth: int = 20, class_num: int = 10,
                       shortcut_type: str = "A",
                       generator: Optional[torch.Generator] = None) -> Module:
    """CIFAR-10 ResNet (``ResNet.scala`` apply, dataset=CIFAR-10) on
    [b, 3, 32, 32]: depth = 6n+2 basic blocks."""
    if (depth - 2) % 6:
        raise ValueError("CIFAR depth must be 6n+2")
    n = (depth - 2) // 6
    g = generator
    m = nn.Sequential(
        nn.SpatialConvolution(3, 16, 3, 3, 1, 1, 1, 1, generator=g),
        nn.SpatialBatchNormalization(16),
        nn.ReLU(True))
    n_in = 16
    for stage, w in enumerate([16, 32, 64]):
        for i in range(n):
            stride = 2 if stage > 0 and i == 0 else 1
            m.add(basic_block(n_in, w, stride, shortcut_type, g))
            n_in = w
    m.add(nn.SpatialAveragePooling(8, 8, 1, 1))
    m.add(nn.View(64).set_num_input_dims(3))
    m.add(nn.Linear(64, class_num, generator=g))
    m.add(nn.LogSoftMax())
    return m
