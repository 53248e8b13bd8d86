"""Zoo builder helpers: Inception-ResNet and FaceNet inception blocks.

Port of `deeplearning4j_tpu/models/helpers.py`, the same node names, layers
and hyperparameters, so the models built from it serialize to the same JSON.
Reference parity: zoo/model/helper/InceptionResNetHelper.java
(inceptionV1ResA/B/C — residual inception blocks with a ScaleVertex on
the residual branch, arXiv 1602.07261) and zoo/model/helper/
FaceNetHelper.java (the GoogLeNet-style inception module with reduce
convs, used by FaceNetNN4Small2). Rebuilt from the papers' structure on
this framework's GraphBuilder — NHWC convs, SAME mode, BN decay 0.995 /
eps 0.001 like the reference blocks.
"""
from __future__ import annotations

from ..nn.graph.vertices import ElementWiseVertex, MergeVertex, ScaleVertex
from ..nn.layers.convolution import (BatchNormalization, ConvolutionLayer,
                                     ConvolutionMode, PoolingType,
                                     SubsamplingLayer)

SAME = ConvolutionMode.SAME


def name_layer(block: str, layer: str, i) -> str:
    """Reference InceptionResNetHelper.nameLayer."""
    return f"{block}-{layer}-{i}"


def conv_bn(g, name: str, inp: str, n_out: int, kernel=(1, 1), stride=(1, 1),
            activation: str = "relu") -> str:
    """conv → BN(decay .995, eps 1e-3) with activation on the conv (the
    reference block pattern)."""
    g.add_layer(f"{name}-cnn", ConvolutionLayer(
        n_out=n_out, kernel_size=tuple(kernel), stride=tuple(stride),
        convolution_mode=SAME, activation=activation), inp)
    g.add_layer(f"{name}-bn", BatchNormalization(
        decay=0.995, eps=1e-3, activation="identity"), f"{name}-cnn")
    return f"{name}-bn"


def _residual(g, block: str, i, inp: str, branch_out: str,
              activation_scale: float) -> str:
    """scale the inception branch then add the shortcut (reference
    ScaleVertex + ElementWiseVertex.Op.Add in inceptionV1Res*)."""
    scaled = name_layer(block, "scale", i)
    g.add_vertex(scaled, ScaleVertex(scale_factor=activation_scale),
                 branch_out)
    out = name_layer(block, "shortcut", i)
    g.add_vertex(out, ElementWiseVertex(op="add"), inp, scaled)
    return out


def inception_resnet_a(g, block: str, scale: int, activation_scale: float,
                       inp: str) -> str:
    """Inception-ResNet-A ("block35"): branches 1x1 / 1x1→3x3 /
    1x1→3x3→3x3, merged, 1x1 up-projection, scaled residual add
    (reference inceptionV1ResA; paper fig. 10)."""
    prev = inp
    for i in range(1, scale + 1):
        b1 = conv_bn(g, name_layer(block, "b1", i), prev, 32)
        b2a = conv_bn(g, name_layer(block, "b2a", i), prev, 32)
        b2 = conv_bn(g, name_layer(block, "b2b", i), b2a, 32, (3, 3))
        b3a = conv_bn(g, name_layer(block, "b3a", i), prev, 32)
        b3b = conv_bn(g, name_layer(block, "b3b", i), b3a, 32, (3, 3))
        b3 = conv_bn(g, name_layer(block, "b3c", i), b3b, 32, (3, 3))
        merged = name_layer(block, "merge", i)
        g.add_vertex(merged, MergeVertex(), b1, b2, b3)
        up = name_layer(block, "up", i)
        g.add_layer(up, ConvolutionLayer(
            n_out=256, kernel_size=(1, 1), convolution_mode=SAME,
            activation="identity"), merged)
        prev = _residual(g, block, i, prev, up, activation_scale)
    return prev


def inception_resnet_b(g, block: str, scale: int, activation_scale: float,
                       inp: str, width: int = 896) -> str:
    """Inception-ResNet-B ("block17"): 1x1 / 1x1→1x7→7x1 branches
    (reference inceptionV1ResB; paper fig. 11)."""
    prev = inp
    for i in range(1, scale + 1):
        b1 = conv_bn(g, name_layer(block, "b1", i), prev, 128)
        b2a = conv_bn(g, name_layer(block, "b2a", i), prev, 128)
        b2b = conv_bn(g, name_layer(block, "b2b", i), b2a, 128, (1, 7))
        b2 = conv_bn(g, name_layer(block, "b2c", i), b2b, 128, (7, 1))
        merged = name_layer(block, "merge", i)
        g.add_vertex(merged, MergeVertex(), b1, b2)
        up = name_layer(block, "up", i)
        g.add_layer(up, ConvolutionLayer(
            n_out=width, kernel_size=(1, 1), convolution_mode=SAME,
            activation="identity"), merged)
        prev = _residual(g, block, i, prev, up, activation_scale)
    return prev


def inception_resnet_c(g, block: str, scale: int, activation_scale: float,
                       inp: str, width: int = 1792) -> str:
    """Inception-ResNet-C ("block8"): 1x1 / 1x1→1x3→3x1 branches
    (reference inceptionV1ResC; paper fig. 13)."""
    prev = inp
    for i in range(1, scale + 1):
        b1 = conv_bn(g, name_layer(block, "b1", i), prev, 192)
        b2a = conv_bn(g, name_layer(block, "b2a", i), prev, 192)
        b2b = conv_bn(g, name_layer(block, "b2b", i), b2a, 192, (1, 3))
        b2 = conv_bn(g, name_layer(block, "b2c", i), b2b, 192, (3, 1))
        merged = name_layer(block, "merge", i)
        g.add_vertex(merged, MergeVertex(), b1, b2)
        up = name_layer(block, "up", i)
        g.add_layer(up, ConvolutionLayer(
            n_out=width, kernel_size=(1, 1), convolution_mode=SAME,
            activation="identity"), merged)
        prev = _residual(g, block, i, prev, up, activation_scale)
    return prev


def reduction_a(g, name: str, inp: str) -> str:
    """Reduction-A: stride-2 3x3 conv / 1x1→3x3→3x3-s2 / maxpool-s2,
    merged (reference reduceA section; paper fig. 7)."""
    pool = f"{name}-pool"
    g.add_layer(pool, SubsamplingLayer(
        kernel_size=(3, 3), stride=(2, 2), pooling_type=PoolingType.MAX,
        convolution_mode=SAME), inp)
    b1 = conv_bn(g, f"{name}-b1", inp, 384, (3, 3), (2, 2))
    b2a = conv_bn(g, f"{name}-b2a", inp, 192)
    b2b = conv_bn(g, f"{name}-b2b", b2a, 192, (3, 3))
    b2 = conv_bn(g, f"{name}-b2c", b2b, 256, (3, 3), (2, 2))
    g.add_vertex(name, MergeVertex(), pool, b1, b2)
    return name


def reduction_b(g, name: str, inp: str) -> str:
    """Reduction-B: maxpool / 1x1→3x3-s2 ×2 / 1x1→3x3→3x3-s2, merged
    (reference reduceB section; paper fig. 12)."""
    pool = f"{name}-pool"
    g.add_layer(pool, SubsamplingLayer(
        kernel_size=(3, 3), stride=(2, 2), pooling_type=PoolingType.MAX,
        convolution_mode=SAME), inp)
    b1a = conv_bn(g, f"{name}-b1a", inp, 256)
    b1 = conv_bn(g, f"{name}-b1b", b1a, 384, (3, 3), (2, 2))
    b2a = conv_bn(g, f"{name}-b2a", inp, 256)
    b2 = conv_bn(g, f"{name}-b2b", b2a, 256, (3, 3), (2, 2))
    b3a = conv_bn(g, f"{name}-b3a", inp, 256)
    b3b = conv_bn(g, f"{name}-b3b", b3a, 256, (3, 3))
    b3 = conv_bn(g, f"{name}-b3c", b3b, 256, (3, 3), (2, 2))
    g.add_vertex(name, MergeVertex(), pool, b1, b2, b3)
    return name


def facenet_inception(g, name: str, inp: str, *, c1x1: int, c3x3_reduce: int,
                      c3x3: int, c5x5_reduce: int = 0, c5x5: int = 0,
                      pool_proj: int = 0, pool_type=PoolingType.MAX,
                      pool_stride=(1, 1), stride3x3=(1, 1)) -> str:
    """GoogLeNet-style inception module with reduce convs (reference
    FaceNetHelper.inception/appendGraph): optional branches so the
    nn4.small2 3c/4e reduction modules (no 1x1 branch, stride 2) build
    from the same helper."""
    branches = []
    if c1x1:
        branches.append(conv_bn(g, f"{name}-1x1", inp, c1x1))
    r3 = conv_bn(g, f"{name}-3x3r", inp, c3x3_reduce)
    branches.append(conv_bn(g, f"{name}-3x3", r3, c3x3, (3, 3), stride3x3))
    if c5x5:
        r5 = conv_bn(g, f"{name}-5x5r", inp, c5x5_reduce)
        branches.append(conv_bn(g, f"{name}-5x5", r5, c5x5, (5, 5),
                                stride3x3))
    pool = f"{name}-pool"
    g.add_layer(pool, SubsamplingLayer(
        kernel_size=(3, 3), stride=tuple(pool_stride),
        pooling_type=pool_type, convolution_mode=SAME), inp)
    if pool_proj:
        branches.append(conv_bn(g, f"{name}-poolproj", pool, pool_proj))
    else:
        branches.append(pool)
    g.add_vertex(name, MergeVertex(), *branches)
    return name
