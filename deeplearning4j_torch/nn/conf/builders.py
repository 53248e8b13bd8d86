"""NeuralNetConfiguration builder DSL + MultiLayerConfiguration.

Port of `deeplearning4j_tpu/nn/conf/builders.py` (reference
nn/conf/NeuralNetConfiguration.java, MultiLayerConfiguration.java and the
ListBuilder pattern). The built MultiLayerConfiguration is a pure,
JSON-round-trippable description with the same fields as the JAX package's,
so either package reads the other's JSON. Global defaults are merged into
layers at build() time. A layer's JSON tag resolves once its module is
imported: the package's ``__init__`` imports every ported layer (core,
convolution, attention, recurrent).
"""
from __future__ import annotations

import copy
import enum
from dataclasses import dataclass, field as dc_field
from typing import Any, Dict, List, Optional

from ...utils import serde
from ..layers.core import Layer
from ..updaters import GradientNormalization, Sgd, Updater
from ..weights import Distribution, WeightInit
from .inputs import (CnnToFeedForwardPreProcessor, CnnToRnnPreProcessor,
                     ConvolutionalFlatType, ConvolutionalType,
                     FeedForwardToCnnPreProcessor, FeedForwardToRnnPreProcessor,
                     FeedForwardType, InputPreProcessor, InputType,
                     RecurrentType, RnnToFeedForwardPreProcessor)


@serde.register
class BackpropType(enum.Enum):
    STANDARD = "standard"
    TRUNCATED_BPTT = "truncated_bptt"


@serde.register
class OptimizationAlgorithm(enum.Enum):
    """Reference nn/api/OptimizationAlgorithm (config only in this slice)."""

    STOCHASTIC_GRADIENT_DESCENT = "sgd"
    LINE_GRADIENT_DESCENT = "line_gradient_descent"
    CONJUGATE_GRADIENT = "conjugate_gradient"
    LBFGS = "lbfgs"


_INHERITABLE = ("activation", "weight_init", "dist", "bias_init", "l1", "l2",
                "l1_bias", "l2_bias", "dropout_rate", "updater",
                "gradient_normalization", "convolution_mode")


def _preprocessor_for(layer: Layer, input_type: InputType):
    """Auto-insert shape adapters (reference InputTypeUtil semantics)."""
    kind = layer.input_kind()
    if kind == "any":
        return None
    if kind == "ff":
        if isinstance(input_type, ConvolutionalType):
            return CnnToFeedForwardPreProcessor(
                input_type.height, input_type.width, input_type.channels)
        if isinstance(input_type, RecurrentType):
            return RnnToFeedForwardPreProcessor()
    elif kind == "cnn":
        if isinstance(input_type, ConvolutionalFlatType):
            return FeedForwardToCnnPreProcessor(
                input_type.height, input_type.width, input_type.channels)
        if isinstance(input_type, FeedForwardType):
            raise ValueError(
                "Cannot feed FeedForward input to a convolutional layer without "
                "spatial dims; use InputType.convolutional_flat(h, w, c)")
    elif kind == "rnn":
        if isinstance(input_type, FeedForwardType):
            return FeedForwardToRnnPreProcessor()
        if isinstance(input_type, ConvolutionalType):
            return CnnToRnnPreProcessor()
    return None


def _normalize_input_type(input_type: InputType, layer: Layer) -> InputType:
    # ConvolutionalFlat behaves as FeedForward for ff layers.
    if isinstance(input_type, ConvolutionalFlatType) and layer.input_kind() == "ff":
        return FeedForwardType(size=input_type.flat_size)
    return input_type


@serde.register
@dataclass
class MultiLayerConfiguration:
    """Built, self-contained sequential-network description."""

    layers: List[Layer] = dc_field(default_factory=list)
    input_preprocessors: Dict[str, InputPreProcessor] = dc_field(default_factory=dict)
    input_type: Optional[InputType] = None
    seed: int = 12345
    backprop: bool = True
    pretrain: bool = False
    backprop_type: BackpropType = BackpropType.STANDARD
    tbptt_fwd_length: int = 20
    tbptt_back_length: int = 20
    optimization_algo: OptimizationAlgorithm = (
        OptimizationAlgorithm.STOCHASTIC_GRADIENT_DESCENT)
    max_num_line_search_iterations: int = 5
    iteration_count: int = 0
    epoch_count: int = 0

    def preprocessor(self, i: int) -> Optional[InputPreProcessor]:
        return self.input_preprocessors.get(str(i))

    def to_json(self) -> str:
        return serde.to_json(self)

    @staticmethod
    def from_json(s: str) -> "MultiLayerConfiguration":
        obj = serde.from_json(s)
        if not isinstance(obj, MultiLayerConfiguration):
            raise ValueError("JSON did not decode to a MultiLayerConfiguration")
        return obj

    def clone(self) -> "MultiLayerConfiguration":
        return copy.deepcopy(self)


class ListBuilder:
    """`.list()` builder (reference NeuralNetConfiguration.ListBuilder)."""

    def __init__(self, global_conf: "NeuralNetConfiguration"):
        self._global = global_conf
        self._layers: Dict[int, Layer] = {}
        self._preprocessors: Dict[int, InputPreProcessor] = {}
        self._input_type: Optional[InputType] = None
        self._backprop = True
        self._pretrain = False
        self._backprop_type = BackpropType.STANDARD
        self._tbptt_fwd = 20
        self._tbptt_back = 20

    def layer(self, index_or_layer, maybe_layer: Layer | None = None) -> "ListBuilder":
        if maybe_layer is None:
            idx = len(self._layers)
            layer = index_or_layer
        else:
            idx, layer = int(index_or_layer), maybe_layer
        self._layers[idx] = layer
        return self

    def input_preprocessor(self, index: int, p: InputPreProcessor) -> "ListBuilder":
        self._preprocessors[int(index)] = p
        return self

    def set_input_type(self, it: InputType) -> "ListBuilder":
        self._input_type = it
        return self

    def backprop(self, b: bool) -> "ListBuilder":
        self._backprop = b
        return self

    def pretrain(self, p: bool) -> "ListBuilder":
        self._pretrain = p
        return self

    def backprop_type(self, t: BackpropType) -> "ListBuilder":
        self._backprop_type = t
        return self

    def tbptt_fwd_length(self, n: int) -> "ListBuilder":
        self._tbptt_fwd = n
        return self

    def tbptt_back_length(self, n: int) -> "ListBuilder":
        self._tbptt_back = n
        return self

    def build(self) -> MultiLayerConfiguration:
        if not self._layers:
            raise ValueError("No layers added")
        n = max(self._layers) + 1
        layers = []
        for i in range(n):
            if i not in self._layers:
                raise ValueError(f"Missing layer index {i}")
            layers.append(self._global.merge_defaults(copy.deepcopy(self._layers[i])))

        preprocessors = {str(k): v for k, v in self._preprocessors.items()}
        # Shape inference + automatic preprocessor insertion.
        if self._input_type is not None:
            it = self._input_type
            for i, layer in enumerate(layers):
                if str(i) not in preprocessors:
                    p = _preprocessor_for(layer, it)
                    if p is not None:
                        preprocessors[str(i)] = p
                if str(i) in preprocessors:
                    it = preprocessors[str(i)].output_type(it)
                it = layer.set_input_type(_normalize_input_type(it, layer))

        return MultiLayerConfiguration(
            layers=layers,
            input_preprocessors=preprocessors,
            input_type=self._input_type,
            seed=self._global.seed,
            backprop=self._backprop,
            pretrain=self._pretrain,
            backprop_type=self._backprop_type,
            tbptt_fwd_length=self._tbptt_fwd,
            tbptt_back_length=self._tbptt_back,
            optimization_algo=self._global.optimization_algo,
            max_num_line_search_iterations=self._global.max_num_line_search_iterations,
        )


@serde.register
@dataclass
class NeuralNetConfiguration:
    """Global (per-network) hyperparameter defaults + entry to the builders.

    Usage mirrors the reference:
        conf = (NeuralNetConfiguration.builder()
                  .seed(42).updater(Adam(1e-3)).weight_init(WeightInit.XAVIER)
                  .list()
                  .layer(DenseLayer(n_out=128, activation="relu"))
                  .layer(OutputLayer(n_out=10, activation="softmax"))
                  .set_input_type(InputType.feed_forward(784))
                  .build())
    """

    seed: int = 12345
    activation: Optional[str] = "sigmoid"
    weight_init: Optional[WeightInit] = WeightInit.XAVIER
    dist: Optional[Distribution] = None
    bias_init: Optional[float] = 0.0
    l1: Optional[float] = 0.0
    l2: Optional[float] = 0.0
    l1_bias: Optional[float] = 0.0
    l2_bias: Optional[float] = 0.0
    dropout_rate: Optional[float] = 0.0
    updater: Optional[Updater] = None
    gradient_normalization: Optional[GradientNormalization] = (
        GradientNormalization.NONE)
    gradient_normalization_threshold: float = 1.0
    convolution_mode: Optional[Any] = None  # ConvolutionMode; None=Truncate
    mini_batch: bool = True
    minimize: bool = True
    optimization_algo: OptimizationAlgorithm = (
        OptimizationAlgorithm.STOCHASTIC_GRADIENT_DESCENT)
    max_num_line_search_iterations: int = 5

    @staticmethod
    def builder() -> "NeuralNetConfigurationBuilder":
        return NeuralNetConfigurationBuilder()

    def merge_defaults(self, layer: Layer) -> Layer:
        """Fill layer fields left as None with the global defaults
        (reference: NeuralNetConfiguration.Builder per-layer config clone)."""
        for f in _INHERITABLE:
            if hasattr(layer, f) and getattr(layer, f) is None:
                setattr(layer, f, copy.deepcopy(getattr(self, f)))
                if f == "gradient_normalization":
                    layer.gradient_normalization_threshold = (
                        self.gradient_normalization_threshold)
        if layer.updater is None:
            layer.updater = Sgd(learning_rate=0.1)
        return layer


class NeuralNetConfigurationBuilder:
    def __init__(self):
        self._conf = NeuralNetConfiguration()

    # fluent setters ------------------------------------------------------
    def seed(self, s: int):
        self._conf.seed = int(s)
        return self

    def activation(self, a: str):
        self._conf.activation = a
        return self

    def weight_init(self, w: WeightInit):
        self._conf.weight_init = w
        return self

    def dist(self, d: Distribution):
        self._conf.dist = d
        if self._conf.weight_init is None:
            self._conf.weight_init = WeightInit.DISTRIBUTION
        return self

    def bias_init(self, b: float):
        self._conf.bias_init = float(b)
        return self

    def l1(self, v: float):
        self._conf.l1 = float(v)
        return self

    def l2(self, v: float):
        self._conf.l2 = float(v)
        return self

    def l1_bias(self, v: float):
        self._conf.l1_bias = float(v)
        return self

    def l2_bias(self, v: float):
        self._conf.l2_bias = float(v)
        return self

    def dropout(self, rate: float):
        self._conf.dropout_rate = float(rate)
        return self

    def updater(self, u: Updater):
        self._conf.updater = u
        return self

    def learning_rate(self, lr: float):
        """Convenience: sets/overrides the updater learning rate (reference
        Builder.learningRate)."""
        if self._conf.updater is None:
            self._conf.updater = Sgd(learning_rate=float(lr))
        else:
            self._conf.updater.learning_rate = float(lr)
        return self

    def gradient_normalization(self, gn: GradientNormalization, threshold: float = 1.0):
        self._conf.gradient_normalization = gn
        self._conf.gradient_normalization_threshold = float(threshold)
        return self

    def convolution_mode(self, mode):
        """Global default ConvolutionMode (reference
        Builder.convolutionMode; inherited by conv/subsampling layers)."""
        self._conf.convolution_mode = mode
        return self

    def optimization_algo(self, algo: OptimizationAlgorithm):
        self._conf.optimization_algo = algo
        return self

    def mini_batch(self, b: bool):
        self._conf.mini_batch = bool(b)
        return self

    def max_num_line_search_iterations(self, n: int):
        self._conf.max_num_line_search_iterations = int(n)
        return self

    # terminal builders ---------------------------------------------------
    def list(self) -> ListBuilder:
        return ListBuilder(self._conf)

    def graph_builder(self):
        """A GraphBuilder for a ComputationGraphConfiguration (reference
        Builder.graphBuilder)."""
        from .graph_conf import GraphBuilder
        return GraphBuilder(self._conf)

    def build(self) -> NeuralNetConfiguration:
        return self._conf
