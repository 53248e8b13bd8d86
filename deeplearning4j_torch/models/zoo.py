"""Model zoo: standard architectures as config builders.

Port of the MultiLayerNetwork models of `deeplearning4j_tpu/models/zoo.py`
that this slice serves: LeNet and AlexNet, with the same layer lists and
hyperparameters (so their configurations serialize to the same JSON), input
shape NHWC [height, width, channels]. The ComputationGraph models and the
pretrained-artifact loader come with later slices.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

from ..nn.conf.builders import MultiLayerConfiguration, NeuralNetConfiguration
from ..nn.conf.inputs import InputType
from ..nn.layers.convolution import (ConvolutionLayer, ConvolutionMode,
                                     LocalResponseNormalization, PoolingType,
                                     SubsamplingLayer)
from ..nn.layers.core import DenseLayer, OutputLayer
from ..nn.multilayer import MultiLayerNetwork
from ..nn.updaters import AdaDelta, GradientNormalization, Nesterovs
from ..nn.weights import Distribution, WeightInit


@dataclass
class ZooModel:
    """Base zoo model (reference zoo/ZooModel.java)."""

    num_labels: int = 1000
    seed: int = 123
    input_shape: Sequence[int] = (224, 224, 3)  # NHWC

    def conf(self) -> MultiLayerConfiguration:
        raise NotImplementedError

    def init(self, **init_kwargs) -> MultiLayerNetwork:
        """Build + initialize the network. Keyword arguments (``device=``,
        ``dtype=``, ``seed=``) pass through to MultiLayerNetwork.init; with
        no ``device`` it runs on CUDA or raises."""
        return MultiLayerNetwork(self.conf()).init(**init_kwargs)


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
