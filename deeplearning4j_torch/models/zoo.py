"""Model zoo: standard architectures as config builders.

Port of `deeplearning4j_tpu/models/zoo.py` for the models the port runs:
LeNet, SimpleCNN, AlexNet, VGG16 and VGG19 (MultiLayerNetwork), ResNet50
and GoogLeNet (ComputationGraph), with the same layer lists, node names and
hyperparameters, so their configurations serialize to the same JSON; input
shape NHWC [height, width, channels]. `ZooModel.init` builds the network
its configuration describes, and `init_pretrained` restores a local
checkpoint after checking its checksum and architecture. TextGenerationLSTM
(MultiLayerNetwork, truncated BPTT) and the face models InceptionResNetV1
and FaceNetNN4Small2 (ComputationGraph, center loss; their blocks in
models/helpers.py) are here too. `model_selector` builds any of the ten by
its `ZooType`.
"""
from __future__ import annotations

import enum
import hashlib
import os
from dataclasses import dataclass
from typing import Optional, Sequence

from ..nn.conf.builders import (BackpropType, MultiLayerConfiguration,
                                NeuralNetConfiguration)
from ..nn.conf.graph_conf import ComputationGraphConfiguration
from ..nn.conf.inputs import InputType
from ..nn.graph.graph import ComputationGraph
from ..nn.graph.vertices import (ElementWiseVertex, L2NormalizeVertex,
                                 MergeVertex)
from ..nn.layers.convolution import (BatchNormalization, ConvolutionLayer,
                                     ConvolutionMode, GlobalPoolingLayer,
                                     LocalResponseNormalization, PoolingType,
                                     SubsamplingLayer, ZeroPaddingLayer)
from ..nn.layers.core import (ActivationLayer, DenseLayer, DropoutLayer,
                              LossLayer, OutputLayer)
from ..nn.layers.pretrain import CenterLossOutputLayer
from ..nn.layers.recurrent import GravesLSTM, RnnOutputLayer
from ..nn.multilayer import MultiLayerNetwork
from ..nn.updaters import AdaDelta, GradientNormalization, Nesterovs, RmsProp
from ..nn.weights import Distribution, WeightInit
from .helpers import (conv_bn, facenet_inception, inception_resnet_a,
                      inception_resnet_b, inception_resnet_c, reduction_a,
                      reduction_b)


def _architecture(conf):
    """Layer and vertex class names, in order: what makes two
    configurations the same architecture."""
    if hasattr(conf, "layers"):
        return [type(layer).__name__ for layer in conf.layers]
    return [type(n.layer if n.is_layer() else n.vertex).__name__
            for n in conf.nodes.values()]


@dataclass
class ZooModel:
    """Base zoo model (reference zoo/ZooModel.java)."""

    num_labels: int = 1000
    seed: int = 123
    input_shape: Sequence[int] = (224, 224, 3)  # NHWC

    def conf(self):
        raise NotImplementedError

    def init(self, **init_kwargs):
        """Build and initialize the network: a ComputationGraph for a graph
        configuration, else a MultiLayerNetwork. Keyword arguments
        (``device=``, ``dtype=``, ``seed=``) pass through to its init; with
        no ``device`` it runs on CUDA or raises."""
        c = self.conf()
        if isinstance(c, ComputationGraphConfiguration):
            return ComputationGraph(c).init(**init_kwargs)
        return MultiLayerNetwork(c).init(**init_kwargs)

    def pretrained_checksum(self) -> Optional[str]:
        """Expected sha256 of the pretrained artifact, where the model
        publishes one (reference ZooModel.pretrainedChecksum)."""
        return None

    def init_pretrained(self, path, verify_checksum: bool = True,
                        expected_sha256: Optional[str] = None, device=None):
        """Restore pretrained weights from a local checkpoint on `device`
        (CUDA unless the caller asks for the CPU), after checking its sha256
        (the reference downloads by URL and checks a checksum,
        ZooModel.java:40-81; here the artifact is a file) and that it holds
        this model's architecture, not merely the same container class."""
        from ..utils.model_serializer import restore_model
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"No pretrained artifact at {path!r} (place the checkpoint "
                "there; nothing is downloaded)")
        expected = expected_sha256 or self.pretrained_checksum()
        if verify_checksum and expected:
            h = hashlib.sha256()
            with open(path, "rb") as f:
                for chunk in iter(lambda: f.read(1 << 20), b""):
                    h.update(chunk)
            if h.hexdigest() != expected:
                raise ValueError(
                    f"Pretrained artifact checksum mismatch for "
                    f"{type(self).__name__}: got {h.hexdigest()}, expected "
                    f"{expected}: corrupt or wrong file")
        net = restore_model(path, device=device)
        mine = self.conf()
        if type(net.conf) is not type(mine):
            raise ValueError(
                f"Artifact at {path!r} holds a {type(net.conf).__name__}, not "
                f"this zoo model's {type(mine).__name__}")
        got, want = _architecture(net.conf), _architecture(mine)
        if got != want:
            raise ValueError(
                f"Artifact at {path!r} is a different architecture "
                f"({len(got)} layers) than {type(self).__name__} "
                f"({len(want)} layers)")
        return net


@dataclass
class LeNet(ZooModel):
    """conv5x5x20 -> max2 -> conv5x5x50 -> max2 -> dense500 -> softmax;
    AdaDelta, XAVIER, Same mode (reference zoo/model/LeNet.java)."""

    num_labels: int = 10
    input_shape: Sequence[int] = (28, 28, 1)

    def conf(self) -> MultiLayerConfiguration:
        h, w, c = self.input_shape
        return (NeuralNetConfiguration.builder()
                .seed(self.seed)
                .activation("identity")
                .weight_init(WeightInit.XAVIER)
                .updater(AdaDelta())
                .list()
                .layer(ConvolutionLayer(kernel_size=(5, 5), stride=(1, 1),
                                        n_out=20, activation="relu",
                                        convolution_mode=ConvolutionMode.SAME))
                .layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2),
                                        pooling_type=PoolingType.MAX,
                                        convolution_mode=ConvolutionMode.SAME))
                .layer(ConvolutionLayer(kernel_size=(5, 5), stride=(1, 1),
                                        n_out=50, activation="relu",
                                        convolution_mode=ConvolutionMode.SAME))
                .layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2),
                                        pooling_type=PoolingType.MAX,
                                        convolution_mode=ConvolutionMode.SAME))
                .layer(DenseLayer(n_out=500, activation="relu"))
                .layer(OutputLayer(n_out=self.num_labels,
                                   activation="softmax", loss="mcxent"))
                .set_input_type(InputType.convolutional(h, w, c))
                .build())


@dataclass
class SimpleCNN(ZooModel):
    """Reference zoo/model/SimpleCNN.java:75-128: a conv/BN stack with
    average pools and dropout, ending in conv(num_labels), global average
    pooling and softmax; as in the JAX package the tail is a
    LossLayer(softmax, mcxent), so that it trains."""

    num_labels: int = 10
    input_shape: Sequence[int] = (48, 48, 1)

    def conf(self) -> MultiLayerConfiguration:
        h, w, c = self.input_shape
        b = (NeuralNetConfiguration.builder()
             .seed(self.seed)
             .activation("identity")
             .weight_init(WeightInit.RELU)
             .updater(AdaDelta())
             .convolution_mode(ConvolutionMode.SAME)
             .gradient_normalization(
                 GradientNormalization.RENORMALIZE_L2_PER_LAYER)
             .list())
        for n, k in ((16, 7), (32, 5), (64, 3), (128, 3)):
            for _ in range(2):
                b.layer(ConvolutionLayer(kernel_size=(k, k), n_out=n))
                b.layer(BatchNormalization())
            b.layer(ActivationLayer(activation="relu"))
            b.layer(SubsamplingLayer(kernel_size=(2, 2),
                                     pooling_type=PoolingType.AVG))
            b.layer(DropoutLayer(dropout_rate=0.5))
        b.layer(ConvolutionLayer(kernel_size=(3, 3), n_out=256))
        b.layer(BatchNormalization())
        b.layer(ConvolutionLayer(kernel_size=(3, 3), n_out=self.num_labels))
        b.layer(GlobalPoolingLayer(pooling_type=PoolingType.AVG))
        b.layer(LossLayer(activation="softmax", loss="mcxent"))
        return b.set_input_type(InputType.convolutional(h, w, c)).build()


@dataclass
class AlexNet(ZooModel):
    """One-tower AlexNet (reference zoo/model/AlexNet.java): gaussian(0,
    0.01) init, bias 1 on conv2/4/5 and dense, dropout 0.5, Nesterov
    momentum, L2 5e-4, LRN after conv1 and conv2."""

    num_labels: int = 1000
    input_shape: Sequence[int] = (224, 224, 3)

    def conf(self) -> MultiLayerConfiguration:
        h, w, c = self.input_shape
        bias1 = 1.0
        return (NeuralNetConfiguration.builder()
                .seed(self.seed)
                .weight_init(WeightInit.DISTRIBUTION)
                .dist(Distribution(kind="normal", mean=0.0, std=0.01))
                .activation("relu")
                .updater(Nesterovs(learning_rate=1e-2, momentum=0.9))
                .convolution_mode(ConvolutionMode.SAME)
                .gradient_normalization(
                    GradientNormalization.RENORMALIZE_L2_PER_LAYER)
                .dropout(0.5)
                .l2(5e-4)
                .list()
                # conv1/maxpool1/conv2 are explicitly Truncate in the
                # reference (AlexNet.java:99-105); the rest inherit Same.
                .layer(ConvolutionLayer(
                    kernel_size=(11, 11), stride=(4, 4), padding=(2, 2),
                    n_out=64, dropout_rate=0.0,
                    convolution_mode=ConvolutionMode.TRUNCATE))
                .layer(LocalResponseNormalization(dropout_rate=0.0))
                .layer(SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2),
                                        padding=(1, 1),
                                        pooling_type=PoolingType.MAX,
                                        convolution_mode=ConvolutionMode.TRUNCATE,
                                        dropout_rate=0.0))
                .layer(ConvolutionLayer(kernel_size=(5, 5), stride=(2, 2),
                                        padding=(2, 2), n_out=192,
                                        bias_init=bias1, dropout_rate=0.0,
                                        convolution_mode=ConvolutionMode.TRUNCATE))
                .layer(LocalResponseNormalization(dropout_rate=0.0))
                .layer(SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2),
                                        pooling_type=PoolingType.MAX,
                                        dropout_rate=0.0))
                .layer(ConvolutionLayer(kernel_size=(3, 3), stride=(1, 1),
                                        n_out=384, dropout_rate=0.0))
                .layer(ConvolutionLayer(kernel_size=(3, 3), stride=(1, 1),
                                        n_out=256,
                                        bias_init=bias1, dropout_rate=0.0))
                .layer(ConvolutionLayer(kernel_size=(3, 3), stride=(1, 1),
                                        n_out=256,
                                        bias_init=bias1, dropout_rate=0.0))
                .layer(SubsamplingLayer(kernel_size=(3, 3), stride=(7, 7),
                                        pooling_type=PoolingType.MAX,
                                        dropout_rate=0.0))
                .layer(DenseLayer(n_out=4096, bias_init=bias1,
                                  dist=Distribution(kind="normal", std=0.005),
                                  weight_init=WeightInit.DISTRIBUTION))
                .layer(DenseLayer(n_out=4096, bias_init=bias1,
                                  dist=Distribution(kind="normal", std=0.005),
                                  weight_init=WeightInit.DISTRIBUTION))
                .layer(OutputLayer(n_out=self.num_labels,
                                   activation="softmax",
                                   loss="negativeloglikelihood"))
                .set_input_type(InputType.convolutional(h, w, c))
                .build())


def _vgg_conf(builder, conv_plan, num_labels, input_shape):
    h, w, c = input_shape
    for n in conv_plan:
        if n == "M":
            builder.layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2),
                                           pooling_type=PoolingType.MAX))
        else:
            builder.layer(ConvolutionLayer(kernel_size=(3, 3), stride=(1, 1),
                                           padding=(1, 1), n_out=n))
    builder.layer(OutputLayer(n_out=num_labels, activation="softmax",
                              loss="negativeloglikelihood"))
    return builder.set_input_type(InputType.convolutional(h, w, c)).build()


@dataclass
class VGG16(ZooModel):
    """Reference zoo/model/VGG16.java:90-160: the conv stack straight into
    the output layer (the reference's dense tail is commented out too)."""

    def conf(self) -> MultiLayerConfiguration:
        b = (NeuralNetConfiguration.builder().seed(self.seed)
             .activation("relu").updater(Nesterovs(learning_rate=1e-2))
             .weight_init(WeightInit.XAVIER).list())
        plan = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
                512, 512, 512, "M", 512, 512, 512, "M"]
        return _vgg_conf(b, plan, self.num_labels, self.input_shape)


@dataclass
class VGG19(ZooModel):
    """Reference zoo/model/VGG19.java:80-150."""

    def conf(self) -> MultiLayerConfiguration:
        b = (NeuralNetConfiguration.builder().seed(self.seed)
             .activation("relu").updater(Nesterovs(learning_rate=1e-2))
             .weight_init(WeightInit.XAVIER).list())
        plan = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
                512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]
        return _vgg_conf(b, plan, self.num_labels, self.input_shape)


@dataclass
class TextGenerationLSTM(ZooModel):
    """Reference zoo/model/TextGenerationLSTM.java:77-97: two GravesLSTM(256)
    + RnnOutput(mcxent), RmsProp, l2 1e-3, tBPTT 50."""

    num_labels: int = 26  # totalUniqueCharacters
    input_shape: Sequence[int] = (50, 26)  # [maxLen, vocab]
    hidden: int = 256

    def conf(self) -> MultiLayerConfiguration:
        return (NeuralNetConfiguration.builder()
                .seed(self.seed)
                .l2(0.001)
                .weight_init(WeightInit.XAVIER)
                .updater(RmsProp(learning_rate=0.1))
                .list()
                .layer(GravesLSTM(n_out=self.hidden, activation="tanh"))
                .layer(GravesLSTM(n_out=self.hidden, activation="tanh"))
                .layer(RnnOutputLayer(n_out=self.num_labels,
                                      activation="softmax", loss="mcxent"))
                .set_input_type(InputType.recurrent(self.input_shape[1]))
                .backprop_type(BackpropType.TRUNCATED_BPTT)
                .tbptt_fwd_length(50).tbptt_back_length(50)
                .build())


@dataclass
class ResNet50(ZooModel):
    """Reference zoo/model/ResNet50.java:82-230, as the JAX package builds
    it: a stem (zero pad 3, 7x7/2 conv, BN, ReLU, 3x3/2 max pool, both
    Truncate), then `_conv_block` (a strided 1x1 bottleneck with a
    projection shortcut) and `_identity_block` per stage, each shortcut an
    ElementWiseVertex add, global average pooling and a negative
    log-likelihood output. RmsProp(0.1, 0.96, 1e-3), normal(0, 0.5) init,
    l1 1e-7, l2 5e-5. Every stage's first block strides 2, its own too, so
    a 224x224 image gives 112 -> 55 -> 28 -> 14 -> 7 -> 4."""

    def _bn_act(self, g, name, inp, act="relu"):
        g.add_layer("bn" + name, BatchNormalization(), inp)
        g.add_layer("act" + name, ActivationLayer(activation=act), "bn" + name)
        return "act" + name

    def _identity_block(self, g, kernel, filters, stage, block, inp):
        f1, f2, f3 = filters
        base = f"{stage}{block}_branch"
        g.add_layer(f"res{base}2a", ConvolutionLayer(
            kernel_size=(1, 1), n_out=f1), inp)
        a = self._bn_act(g, f"{base}2a", f"res{base}2a")
        g.add_layer(f"res{base}2b", ConvolutionLayer(
            kernel_size=kernel, n_out=f2,
            convolution_mode=ConvolutionMode.SAME), a)
        a = self._bn_act(g, f"{base}2b", f"res{base}2b")
        g.add_layer(f"res{base}2c", ConvolutionLayer(
            kernel_size=(1, 1), n_out=f3), a)
        g.add_layer(f"bn{base}2c", BatchNormalization(), f"res{base}2c")
        g.add_vertex(f"short{base}", ElementWiseVertex(op="add"),
                     f"bn{base}2c", inp)
        g.add_layer(f"res{stage}{block}_out",
                    ActivationLayer(activation="relu"), f"short{base}")
        return f"res{stage}{block}_out"

    def _conv_block(self, g, kernel, filters, stage, block, inp,
                    stride=(2, 2)):
        f1, f2, f3 = filters
        base = f"{stage}{block}_branch"
        g.add_layer(f"res{base}2a", ConvolutionLayer(
            kernel_size=(1, 1), stride=stride, n_out=f1), inp)
        a = self._bn_act(g, f"{base}2a", f"res{base}2a")
        g.add_layer(f"res{base}2b", ConvolutionLayer(
            kernel_size=kernel, n_out=f2,
            convolution_mode=ConvolutionMode.SAME), a)
        a = self._bn_act(g, f"{base}2b", f"res{base}2b")
        g.add_layer(f"res{base}2c", ConvolutionLayer(
            kernel_size=(1, 1), n_out=f3), a)
        g.add_layer(f"bn{base}2c", BatchNormalization(), f"res{base}2c")
        # projection shortcut
        g.add_layer(f"res{base}1", ConvolutionLayer(
            kernel_size=(1, 1), stride=stride, n_out=f3), inp)
        g.add_layer(f"bn{base}1", BatchNormalization(), f"res{base}1")
        g.add_vertex(f"short{base}", ElementWiseVertex(op="add"),
                     f"bn{base}2c", f"bn{base}1")
        g.add_layer(f"res{stage}{block}_out",
                    ActivationLayer(activation="relu"), f"short{base}")
        return f"res{stage}{block}_out"

    def conf(self) -> ComputationGraphConfiguration:
        h, w, c = self.input_shape
        g = (NeuralNetConfiguration.builder()
             .seed(self.seed)
             .activation("identity")
             .updater(RmsProp(learning_rate=0.1, rms_decay=0.96,
                              epsilon=0.001))
             .weight_init(WeightInit.DISTRIBUTION)
             .dist(Distribution(kind="normal", mean=0.0, std=0.5))
             .l1(1e-7).l2(5e-5)
             .graph_builder())
        g.add_inputs("input")
        g.set_input_types(InputType.convolutional(h, w, c))
        g.add_layer("stem-zero", ZeroPaddingLayer(padding=(3, 3)), "input")
        g.add_layer("stem-cnn1", ConvolutionLayer(
            kernel_size=(7, 7), stride=(2, 2), n_out=64), "stem-zero")
        a = self._bn_act(g, "stem1", "stem-cnn1")
        g.add_layer("stem-maxpool1", SubsamplingLayer(
            kernel_size=(3, 3), stride=(2, 2),
            pooling_type=PoolingType.MAX), a)

        x = self._conv_block(g, (3, 3), (64, 64, 256), "2", "a",
                             "stem-maxpool1", stride=(2, 2))
        x = self._identity_block(g, (3, 3), (64, 64, 256), "2", "b", x)
        x = self._identity_block(g, (3, 3), (64, 64, 256), "2", "c", x)

        x = self._conv_block(g, (3, 3), (128, 128, 512), "3", "a", x)
        for blk in "bcd":
            x = self._identity_block(g, (3, 3), (128, 128, 512), "3", blk, x)

        x = self._conv_block(g, (3, 3), (256, 256, 1024), "4", "a", x)
        for blk in "bcdef":
            x = self._identity_block(g, (3, 3), (256, 256, 1024), "4", blk, x)

        x = self._conv_block(g, (3, 3), (512, 512, 2048), "5", "a", x)
        x = self._identity_block(g, (3, 3), (512, 512, 2048), "5", "b", x)
        x = self._identity_block(g, (3, 3), (512, 512, 2048), "5", "c", x)

        g.add_layer("avgpool", GlobalPoolingLayer(
            pooling_type=PoolingType.AVG), x)
        g.add_layer("output", OutputLayer(
            n_out=self.num_labels, activation="softmax",
            loss="negativeloglikelihood"), "avgpool")
        g.set_outputs("output")
        return g.build()


@dataclass
class GoogLeNet(ZooModel):
    """Inception v1 (reference zoo/model/GoogLeNet.java:83-180, Szegedy et
    al.; Nesterovs(1e-2, 0.9), l2 2e-4, relu), with the JAX package's SAME
    3x3/1 max pool in each inception block. `fuse_siblings=True` runs the
    sibling-conv fusion pass (nn/graph/fusion.py) over the built
    configuration: each block's 1x1 cnn1/cnn2/cnn3 become one conv and
    three SubsetVertex slices. `pooling_impl` goes to every
    SubsamplingLayer (ops/pooling.py)."""

    fuse_siblings: bool = False
    pooling_impl: str = "auto"

    def _inception(self, g, name, cfg, inp):
        # cfg = [[c1x1], [c3r, c3], [c5r, c5], [pool_proj]]
        g.add_layer(f"{name}-cnn1", ConvolutionLayer(
            kernel_size=(1, 1), n_out=cfg[0][0], bias_init=0.2), inp)
        g.add_layer(f"{name}-cnn2", ConvolutionLayer(
            kernel_size=(1, 1), n_out=cfg[1][0], bias_init=0.2), inp)
        g.add_layer(f"{name}-cnn3", ConvolutionLayer(
            kernel_size=(1, 1), n_out=cfg[2][0], bias_init=0.2), inp)
        g.add_layer(f"{name}-max1", SubsamplingLayer(
            kernel_size=(3, 3), stride=(1, 1), pooling_type=PoolingType.MAX,
            convolution_mode=ConvolutionMode.SAME,
            pooling_impl=self.pooling_impl), inp)
        g.add_layer(f"{name}-cnn4", ConvolutionLayer(
            kernel_size=(3, 3), padding=(1, 1), n_out=cfg[1][1],
            bias_init=0.2), f"{name}-cnn2")
        g.add_layer(f"{name}-cnn5", ConvolutionLayer(
            kernel_size=(5, 5), padding=(2, 2), n_out=cfg[2][1],
            bias_init=0.2), f"{name}-cnn3")
        g.add_layer(f"{name}-cnn6", ConvolutionLayer(
            kernel_size=(1, 1), n_out=cfg[3][0], bias_init=0.2),
            f"{name}-max1")
        g.add_vertex(f"{name}-depthconcat1", MergeVertex(),
                     f"{name}-cnn1", f"{name}-cnn4", f"{name}-cnn5",
                     f"{name}-cnn6")
        return f"{name}-depthconcat1"

    def conf(self) -> ComputationGraphConfiguration:
        h, w, c = self.input_shape
        g = (NeuralNetConfiguration.builder()
             .seed(self.seed)
             .activation("relu")
             .updater(Nesterovs(learning_rate=1e-2, momentum=0.9))
             .weight_init(WeightInit.XAVIER)
             .l2(2e-4)
             .graph_builder())
        g.add_inputs("input")
        g.set_input_types(InputType.convolutional(h, w, c))
        g.add_layer("cnn1", ConvolutionLayer(
            kernel_size=(7, 7), stride=(2, 2), padding=(3, 3), n_out=64,
            bias_init=0.2), "input")
        g.add_layer("max1", SubsamplingLayer(
            kernel_size=(3, 3), stride=(2, 2), padding=(1, 1),
            pooling_type=PoolingType.MAX,
            pooling_impl=self.pooling_impl), "cnn1")
        g.add_layer("lrn1", LocalResponseNormalization(), "max1")
        g.add_layer("cnn2", ConvolutionLayer(
            kernel_size=(1, 1), n_out=64, bias_init=0.2), "lrn1")
        g.add_layer("cnn3", ConvolutionLayer(
            kernel_size=(3, 3), padding=(1, 1), n_out=192, bias_init=0.2),
            "cnn2")
        g.add_layer("lrn2", LocalResponseNormalization(), "cnn3")
        g.add_layer("max2", SubsamplingLayer(
            kernel_size=(3, 3), stride=(2, 2), padding=(1, 1),
            pooling_type=PoolingType.MAX,
            pooling_impl=self.pooling_impl), "lrn2")

        x = self._inception(g, "3a", [[64], [96, 128], [16, 32], [32]],
                            "max2")
        x = self._inception(g, "3b", [[128], [128, 192], [32, 96], [64]], x)
        g.add_layer("max3", SubsamplingLayer(
            kernel_size=(3, 3), stride=(2, 2), padding=(1, 1),
            pooling_type=PoolingType.MAX,
            pooling_impl=self.pooling_impl), x)
        x = self._inception(g, "4a", [[192], [96, 208], [16, 48], [64]],
                            "max3")
        x = self._inception(g, "4b", [[160], [112, 224], [24, 64], [64]], x)
        x = self._inception(g, "4c", [[128], [128, 256], [24, 64], [64]], x)
        x = self._inception(g, "4d", [[112], [144, 288], [32, 64], [64]], x)
        x = self._inception(g, "4e", [[256], [160, 320], [32, 128], [128]], x)
        g.add_layer("max4", SubsamplingLayer(
            kernel_size=(3, 3), stride=(2, 2), padding=(1, 1),
            pooling_type=PoolingType.MAX,
            pooling_impl=self.pooling_impl), x)
        x = self._inception(g, "5a", [[256], [160, 320], [32, 128], [128]],
                            "max4")
        x = self._inception(g, "5b", [[384], [192, 384], [48, 128], [128]], x)
        g.add_layer("avgpool", GlobalPoolingLayer(
            pooling_type=PoolingType.AVG), x)
        g.add_layer("fc1", DenseLayer(n_out=1024, dropout_rate=0.4), "avgpool")
        g.add_layer("output", OutputLayer(
            n_out=self.num_labels, activation="softmax", loss="mcxent"),
            "fc1")
        g.set_outputs("output")
        conf = g.build()
        if self.fuse_siblings:
            from ..nn.graph.fusion import fuse_sibling_convs
            conf, _ = fuse_sibling_convs(conf)
        return conf


@dataclass
class InceptionResNetV1(ZooModel):
    """Reference zoo/model/InceptionResNetV1.java (:75 init adds the
    bottleneck + center-loss head onto graphBuilder :101; blocks via
    InceptionResNetHelper) — Szegedy et al., arXiv 1602.07261. Face-
    recognition scale: 160×160×3 input, 128-d embedding, center loss."""

    num_labels: int = 1001
    input_shape: Sequence[int] = (160, 160, 3)
    embedding_size: int = 128

    def conf(self) -> ComputationGraphConfiguration:
        h, w, c = self.input_shape
        g = (NeuralNetConfiguration.builder()
             .seed(self.seed)
             .activation("identity")
             .updater(RmsProp(learning_rate=0.1, rms_decay=0.96,
                              epsilon=0.001))
             .weight_init(WeightInit.DISTRIBUTION)
             .dist(Distribution(kind="normal", mean=0.0, std=0.5))
             .graph_builder())
        g.add_inputs("input")
        g.set_input_types(InputType.convolutional(h, w, c))
        # stem (reference graphBuilder :101-167)
        x = conv_bn(g, "stem1", "input", 32, (3, 3), (2, 2))
        x = conv_bn(g, "stem2", x, 32, (3, 3))
        x = conv_bn(g, "stem3", x, 64, (3, 3))
        g.add_layer("stem-pool", SubsamplingLayer(
            kernel_size=(3, 3), stride=(2, 2),
            pooling_type=PoolingType.MAX,
            convolution_mode=ConvolutionMode.SAME), x)
        x = conv_bn(g, "stem4", "stem-pool", 80, (1, 1))
        x = conv_bn(g, "stem5", x, 192, (3, 3))
        x = conv_bn(g, "stem6", x, 256, (3, 3), (2, 2))
        # 5× Inception-ResNet-A @ scale .17 (reference :167)
        x = inception_resnet_a(g, "resnetA", 5, 0.17, x)
        x = reduction_a(g, "reduceA", x)
        # 10× Inception-ResNet-B @ .10 (reference :220); width follows the
        # merge of reduction-A (256 + 384 + 256 = 896)
        x = inception_resnet_b(g, "resnetB", 10, 0.10, x, width=896)
        x = reduction_b(g, "reduceB", x)
        # 5× Inception-ResNet-C @ .20 (reference :302); 896+384+256+256
        x = inception_resnet_c(g, "resnetC", 5, 0.20, x, width=1792)
        g.add_layer("avgpool", GlobalPoolingLayer(
            pooling_type=PoolingType.AVG), x)
        # bottleneck embedding + L2 normalize + center loss (init :75-99)
        g.add_layer("bottleneck", DenseLayer(
            n_out=self.embedding_size, activation="identity"), "avgpool")
        g.add_vertex("embeddings", L2NormalizeVertex(), "bottleneck")
        g.add_layer("lossLayer", CenterLossOutputLayer(
            n_out=self.num_labels, activation="softmax", loss="mcxent",
            alpha=0.9, lambda_=1e-4), "embeddings")
        g.set_outputs("lossLayer")
        return g.build()


@dataclass
class FaceNetNN4Small2(ZooModel):
    """Reference zoo/model/FaceNetNN4Small2.java (:322-335 tail:
    avgpool → bottleneck dense → L2NormalizeVertex 'embeddings' →
    CenterLossOutputLayer; inception modules via FaceNetHelper) —
    Schroff et al. FaceNet, OpenFace nn4.small2 variant, 96×96×3."""

    num_labels: int = 5749
    input_shape: Sequence[int] = (96, 96, 3)
    embedding_size: int = 128

    def conf(self) -> ComputationGraphConfiguration:
        h, w, c = self.input_shape
        g = (NeuralNetConfiguration.builder()
             .seed(self.seed)
             .activation("relu")
             .updater(Nesterovs(learning_rate=0.001, momentum=0.9))
             .weight_init(WeightInit.RELU)
             .graph_builder())
        g.add_inputs("input")
        g.set_input_types(InputType.convolutional(h, w, c))
        x = conv_bn(g, "stem1", "input", 64, (7, 7), (2, 2))
        g.add_layer("pool1", SubsamplingLayer(
            kernel_size=(3, 3), stride=(2, 2),
            pooling_type=PoolingType.MAX,
            convolution_mode=ConvolutionMode.SAME), x)
        x = conv_bn(g, "stem2", "pool1", 64, (1, 1))
        x = conv_bn(g, "stem3", x, 192, (3, 3))
        g.add_layer("pool2", SubsamplingLayer(
            kernel_size=(3, 3), stride=(2, 2),
            pooling_type=PoolingType.MAX,
            convolution_mode=ConvolutionMode.SAME), x)
        # nn4.small2 inception stack (OpenFace table; reference
        # FaceNetHelper.appendGraph calls)
        x = facenet_inception(g, "inception3a", "pool2", c1x1=64,
                              c3x3_reduce=96, c3x3=128, c5x5_reduce=16,
                              c5x5=32, pool_proj=32)
        x = facenet_inception(g, "inception3b", x, c1x1=64,
                              c3x3_reduce=96, c3x3=128, c5x5_reduce=32,
                              c5x5=64, pool_proj=64,
                              pool_type=PoolingType.AVG)
        x = facenet_inception(g, "inception3c", x, c1x1=0,
                              c3x3_reduce=128, c3x3=256, c5x5_reduce=32,
                              c5x5=64, pool_proj=0, stride3x3=(2, 2),
                              pool_stride=(2, 2))
        x = facenet_inception(g, "inception4a", x, c1x1=256,
                              c3x3_reduce=96, c3x3=192, c5x5_reduce=32,
                              c5x5=64, pool_proj=128,
                              pool_type=PoolingType.AVG)
        x = facenet_inception(g, "inception4e", x, c1x1=0,
                              c3x3_reduce=160, c3x3=256, c5x5_reduce=64,
                              c5x5=128, pool_proj=0, stride3x3=(2, 2),
                              pool_stride=(2, 2))
        x = facenet_inception(g, "inception5a", x, c1x1=256,
                              c3x3_reduce=96, c3x3=384, pool_proj=96,
                              pool_type=PoolingType.AVG)
        x = facenet_inception(g, "inception5b", x, c1x1=256,
                              c3x3_reduce=96, c3x3=384, pool_proj=96)
        g.add_layer("avgpool", GlobalPoolingLayer(
            pooling_type=PoolingType.AVG), x)
        g.add_layer("bottleneck", DenseLayer(
            n_out=self.embedding_size, activation="identity"), "avgpool")
        g.add_vertex("embeddings", L2NormalizeVertex(), "bottleneck")
        g.add_layer("lossLayer", CenterLossOutputLayer(
            n_out=self.num_labels, activation="softmax", loss="mcxent",
            alpha=0.9, lambda_=1e-4), "embeddings")
        g.set_outputs("lossLayer")
        return g.build()


class ZooType(enum.Enum):
    """Reference zoo/ZooType.java: the zoo models the port has."""

    LENET = "lenet"
    SIMPLECNN = "simplecnn"
    ALEXNET = "alexnet"
    VGG16 = "vgg16"
    VGG19 = "vgg19"
    RESNET50 = "resnet50"
    GOOGLENET = "googlenet"
    TEXTGENLSTM = "textgenlstm"
    INCEPTIONRESNETV1 = "inceptionresnetv1"
    FACENETNN4SMALL2 = "facenetnn4small2"


_ZOO = {
    ZooType.LENET: LeNet,
    ZooType.SIMPLECNN: SimpleCNN,
    ZooType.ALEXNET: AlexNet,
    ZooType.VGG16: VGG16,
    ZooType.VGG19: VGG19,
    ZooType.RESNET50: ResNet50,
    ZooType.GOOGLENET: GoogLeNet,
    ZooType.TEXTGENLSTM: TextGenerationLSTM,
    ZooType.INCEPTIONRESNETV1: InceptionResNetV1,
    ZooType.FACENETNN4SMALL2: FaceNetNN4Small2,
}


def model_selector(zoo_type: ZooType, **kwargs) -> ZooModel:
    """A zoo model by type, `kwargs` passed to its constructor (reference
    zoo/ModelSelector.java)."""
    if zoo_type not in _ZOO:
        raise ValueError(f"Unknown zoo type {zoo_type}")
    return _ZOO[zoo_type](**kwargs)
