"""Inception v1 (GoogLeNet), ported from ``bigdl_tpu/models/inception.py``.

Built with the Concat container exactly as the JAX package builds it,
so the module tree, and with it every ``state_dict`` key, is the same.
The auxiliary heads (``with_aux``), the NHWC build and v2 are not ported
yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch import nn

__all__ = ["inception_layer_v1", "build_inception_v1"]


def inception_layer_v1(input_size: int, config, name_prefix: str = "",
                       generator: Optional[torch.Generator] = None
                       ) -> nn.Module:
    """One inception module: 1x1 / 3x3reduce+3x3 / 5x5reduce+5x5 /
    pool+proj branches concatenated on the channel dim."""
    g = generator
    concat = nn.Concat(1).set_name(name_prefix + "inception")
    concat.add(nn.Sequential(
        nn.SpatialConvolution(input_size, config[0][0], 1, 1, 1, 1, generator=g)
        .set_name(name_prefix + "1x1"),
        nn.ReLU(True)))
    concat.add(nn.Sequential(
        nn.SpatialConvolution(input_size, config[1][0], 1, 1, 1, 1, generator=g)
        .set_name(name_prefix + "3x3_reduce"),
        nn.ReLU(True),
        nn.SpatialConvolution(config[1][0], config[1][1], 3, 3, 1, 1, 1, 1,
                              generator=g)
        .set_name(name_prefix + "3x3"),
        nn.ReLU(True)))
    concat.add(nn.Sequential(
        nn.SpatialConvolution(input_size, config[2][0], 1, 1, 1, 1, generator=g)
        .set_name(name_prefix + "5x5_reduce"),
        nn.ReLU(True),
        nn.SpatialConvolution(config[2][0], config[2][1], 5, 5, 1, 1, 2, 2,
                              generator=g)
        .set_name(name_prefix + "5x5"),
        nn.ReLU(True)))
    concat.add(nn.Sequential(
        nn.SpatialMaxPooling(3, 3, 1, 1, 1, 1).ceil(),
        nn.SpatialConvolution(input_size, config[3][0], 1, 1, 1, 1, generator=g)
        .set_name(name_prefix + "pool_proj"),
        nn.ReLU(True)))
    return concat


def build_inception_v1(class_num: int = 1000, has_dropout: bool = True,
                       with_aux: bool = False, format: str = "NCHW",
                       generator: Optional[torch.Generator] = None
                       ) -> nn.Module:
    """GoogLeNet without the auxiliary classifiers, NCHW, weights drawn
    from ``generator`` on the CPU."""
    if with_aux or format != "NCHW":
        raise NotImplementedError(
            "the port builds Inception-v1 without aux heads, NCHW only")
    g = generator
    feature1 = nn.Sequential(
        nn.SpatialConvolution(3, 64, 7, 7, 2, 2, 3, 3, generator=g)
        .set_name("conv1/7x7_s2"),
        nn.ReLU(True),
        nn.SpatialMaxPooling(3, 3, 2, 2).ceil(),
        nn.SpatialCrossMapLRN(5, 0.0001, 0.75).set_name("pool1/norm1"),
        nn.SpatialConvolution(64, 64, 1, 1, 1, 1, generator=g)
        .set_name("conv2/3x3_reduce"),
        nn.ReLU(True),
        nn.SpatialConvolution(64, 192, 3, 3, 1, 1, 1, 1, generator=g)
        .set_name("conv2/3x3"),
        nn.ReLU(True),
        nn.SpatialCrossMapLRN(5, 0.0001, 0.75).set_name("conv2/norm2"),
        nn.SpatialMaxPooling(3, 3, 2, 2).ceil(),
        inception_layer_v1(192, [[64], [96, 128], [16, 32], [32]], "inception_3a/", g),
        inception_layer_v1(256, [[128], [128, 192], [32, 96], [64]], "inception_3b/", g),
        nn.SpatialMaxPooling(3, 3, 2, 2).ceil(),
        inception_layer_v1(480, [[192], [96, 208], [16, 48], [64]], "inception_4a/", g),
    )
    feature2 = nn.Sequential(
        inception_layer_v1(512, [[160], [112, 224], [24, 64], [64]], "inception_4b/", g),
        inception_layer_v1(512, [[128], [128, 256], [24, 64], [64]], "inception_4c/", g),
        inception_layer_v1(512, [[112], [144, 288], [32, 64], [64]], "inception_4d/", g),
    )
    feature3 = nn.Sequential(
        inception_layer_v1(528, [[256], [160, 320], [32, 128], [128]], "inception_4e/", g),
        nn.SpatialMaxPooling(3, 3, 2, 2).ceil(),
        inception_layer_v1(832, [[256], [160, 320], [32, 128], [128]], "inception_5a/", g),
        inception_layer_v1(832, [[384], [192, 384], [48, 128], [128]], "inception_5b/", g),
    )
    head = nn.Sequential(
        nn.SpatialAveragePooling(7, 7, 1, 1),
        nn.View(1024).set_num_input_dims(3),
    )
    if has_dropout:
        head.add(nn.Dropout(0.4))
    head.add(nn.Linear(1024, class_num, generator=g).set_name("loss3/classifier"))
    head.add(nn.LogSoftMax().set_name("loss3/loss3"))
    return nn.Sequential(feature1, feature2, feature3, head)
