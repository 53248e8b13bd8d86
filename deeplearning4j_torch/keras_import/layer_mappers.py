"""Keras layer-config → framework layer mapping + weight transforms.

Port of `deeplearning4j_tpu/keras_import/layer_mappers.py` (reference
modelimport/keras/layers/Keras{Dense,Convolution,Lstm,BatchNormalization,
Embedding,Pooling,GlobalPooling,Flatten,ZeroPadding,Dropout,Activation,
Input,Loss}.java — one mapper per supported Keras layer class, each
translating config keys and reordering weight blocks), onto the port's
layers and vertices.

The transforms here produce arrays in the JAX package's layout, which is
Keras's channels_last one: HWIO conv kernels and (in, out) dense kernels
copy with no transposition. The importer moves them into the port's layout
(OIHW conv kernels, utils/params.py) as it places them on the device. The
only reorder here is the LSTM gate blocks: Keras packs [i, f,
c(candidate), o]; the framework packs [i(candidate), f, o, g(input gate)]
after DL4J's LSTMHelpers convention (nn/layers/recurrent.py), giving block
permutation [c, f, o, i].
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..nn.layers import convolution as conv
from ..nn.layers import core as core_layers
from ..nn.layers import recurrent
from .reader import (InvalidKerasConfigurationException,
                     UnsupportedKerasConfigurationException)

# Keras activation name → framework activation name (ops/activations.py)
_ACTIVATIONS = {
    "linear": "identity", "relu": "relu", "tanh": "tanh",
    "sigmoid": "sigmoid", "softmax": "softmax", "elu": "elu",
    "selu": "selu", "softplus": "softplus", "softsign": "softsign",
    "hard_sigmoid": "hardsigmoid", "leaky_relu": "leakyrelu",
    "swish": "swish", "silu": "swish", "gelu": "gelu", "exponential": "exp",
}

# Default loss by terminal activation when no training_config is present
# (reference KerasLoss: training_config normally supplies this).
_LOSS_BY_ACTIVATION = {"softmax": "mcxent", "sigmoid": "xent"}

_KERAS_LOSSES = {
    "categorical_crossentropy": "mcxent",
    "binary_crossentropy": "xent",
    "mean_squared_error": "mse", "mse": "mse",
    "mean_absolute_error": "mae", "mae": "mae",
    "sparse_categorical_crossentropy": "mcxent",
}


def map_activation(name: str) -> str:
    if name not in _ACTIVATIONS:
        raise UnsupportedKerasConfigurationException(
            f"Unsupported Keras activation {name!r}")
    return _ACTIVATIONS[name]


def map_loss(name: str) -> str:
    key = name.lower() if isinstance(name, str) else name
    if key not in _KERAS_LOSSES:
        raise UnsupportedKerasConfigurationException(
            f"Unsupported Keras loss {name!r}")
    return _KERAS_LOSSES[key]


class Mapped:
    """One Keras layer's translation: framework layer (or marker) plus the
    weight-transform from keras short-named arrays to our param dict."""

    def __init__(self, layer=None, *, skip: bool = False,
                 vertex=None,
                 weights: Optional[Callable[[Dict[str, np.ndarray]],
                                            Dict[str, np.ndarray]]] = None,
                 state: Optional[Callable[[Dict[str, np.ndarray]],
                                          Dict[str, np.ndarray]]] = None):
        self.layer = layer
        self.vertex = vertex
        self.skip = skip
        self.weights = weights
        self.state = state


def _act_of(cfg: dict) -> str:
    return map_activation(cfg.get("activation", "linear"))


def _pair(v) -> tuple:
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v), int(v))


def _conv_mode(cfg: dict):
    padding = cfg.get("padding", "valid")
    if padding == "same":
        return conv.ConvolutionMode.SAME
    if padding == "valid":
        return conv.ConvolutionMode.TRUNCATE
    raise UnsupportedKerasConfigurationException(
        f"Unsupported Keras padding {padding!r}")


def _check_data_format(cfg: dict, data_format: str):
    """Every spatial layer must agree with the model-wide ordering the
    importer detected (mixed-format models are genuinely ambiguous).
    channels_first itself is SUPPORTED on the sequential path: Keras
    stores conv kernels HWIO regardless of data_format, so only the
    input layout and the first dense after a Flatten need conversion
    (the reference's TensorFlowCnnToFeedForwardPreProcessor role) —
    both handled by the importer, not here."""
    # a missing key inherits the detected model-wide ordering (old
    # Keras Flatten configs carry no data_format at all); only an
    # EXPLICIT contradiction is a mixed-ordering error
    fmt = cfg.get("data_format") or data_format
    if fmt != data_format:
        raise UnsupportedKerasConfigurationException(
            f"Layer {cfg.get('name')!r} uses {fmt} but the model was "
            f"detected as {data_format}; mixed orderings are unsupported")


def _dense_weights(w: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    out = {"W": w["kernel"]}
    out["b"] = w.get("bias", np.zeros(w["kernel"].shape[-1], np.float32))
    return out


def _lstm_weights(units: int):
    def tx(w: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        def reorder(m):
            # keras blocks [i, f, c, o] → ours [i(=keras c), f, o, g(=keras i)]
            H = units
            blocks = [m[..., k * H:(k + 1) * H] for k in range(4)]
            ki, kf, kc, ko = blocks
            return np.concatenate([kc, kf, ko, ki], axis=-1)
        out = {"W": reorder(w["kernel"]),
               "RW": reorder(w["recurrent_kernel"])}
        b = w.get("bias")
        out["b"] = reorder(b) if b is not None \
            else np.zeros(4 * units, np.float32)
        return out
    return tx


def _bn_weights(w: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    n = w["moving_mean"].shape[0]
    return {"gamma": w.get("gamma", np.ones(n, np.float32)),
            "beta": w.get("beta", np.zeros(n, np.float32))}


def _bn_state(w: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    return {"mean": w["moving_mean"].astype(np.float32),
            "var": w["moving_variance"].astype(np.float32)}


def _embedding_weights(w: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    emb = w["embeddings"]
    return {"W": emb, "b": np.zeros(emb.shape[-1], np.float32)}


def map_layer(class_name: str, cfg: dict, *,
              is_terminal: bool, loss: Optional[str],
              data_format: str = "channels_last") -> Mapped:
    """Translate one Keras layer. `is_terminal` layers with parameters
    become loss heads (OutputLayer) so the imported net is trainable, like
    the reference's enforceTrainingConfig path (KerasModel.java:522-527)."""
    name = cfg.get("name", class_name)

    if class_name == "InputLayer":
        return Mapped(skip=True)

    if class_name == "Dense":
        act = _act_of(cfg)
        if is_terminal:
            layer = core_layers.OutputLayer(
                name=name, n_out=int(cfg["units"]), activation=act,
                loss=loss or _LOSS_BY_ACTIVATION.get(act, "mse"))
        else:
            layer = core_layers.DenseLayer(name=name, n_out=int(cfg["units"]),
                                           activation=act)
        return Mapped(layer, weights=_dense_weights)

    if class_name == "Activation":
        return Mapped(core_layers.ActivationLayer(name=name,
                                                  activation=_act_of(cfg)))

    if class_name == "Dropout":
        return Mapped(core_layers.DropoutLayer(
            name=name, dropout_rate=float(cfg.get("rate", 0.5))))

    if class_name in ("Flatten", "Reshape"):
        # NHWC reshape(batch, -1) == Keras channels_last Flatten; the
        # framework auto-inserts CnnToFeedForward at the next dense layer.
        if class_name == "Flatten":
            _check_data_format(cfg, data_format)
            return Mapped(skip=True)
        raise UnsupportedKerasConfigurationException(
            "Reshape import is not supported yet")

    if class_name in ("Conv2D", "Convolution2D"):
        _check_data_format(cfg, data_format)
        dil = _pair(cfg.get("dilation_rate", 1))
        return Mapped(conv.ConvolutionLayer(
            name=name, n_out=int(cfg["filters"]),
            kernel_size=_pair(cfg["kernel_size"]),
            stride=_pair(cfg.get("strides", 1)), dilation=dil,
            convolution_mode=_conv_mode(cfg), activation=_act_of(cfg)),
            weights=_dense_weights)

    if class_name in ("Conv1D", "Convolution1D"):
        _check_data_format(cfg, data_format)
        return Mapped(conv.Convolution1DLayer(
            name=name, n_out=int(cfg["filters"]),
            kernel_size=(int(_pair(cfg["kernel_size"])[0]),),
            stride=(int(_pair(cfg.get("strides", 1))[0]),),
            dilation=(int(_pair(cfg.get("dilation_rate", 1))[0]),),
            convolution_mode=_conv_mode(cfg), activation=_act_of(cfg)),
            weights=_dense_weights)

    if class_name in ("MaxPooling2D", "AveragePooling2D"):
        _check_data_format(cfg, data_format)
        ptype = conv.PoolingType.MAX if class_name.startswith("Max") \
            else conv.PoolingType.AVG
        pool = _pair(cfg.get("pool_size", 2))
        return Mapped(conv.SubsamplingLayer(
            name=name, kernel_size=pool,
            stride=_pair(cfg.get("strides") or pool),
            pooling_type=ptype, convolution_mode=_conv_mode(cfg)))

    if class_name in ("GlobalMaxPooling2D", "GlobalAveragePooling2D",
                      "GlobalMaxPooling1D", "GlobalAveragePooling1D"):
        ptype = conv.PoolingType.MAX if "Max" in class_name \
            else conv.PoolingType.AVG
        return Mapped(conv.GlobalPoolingLayer(name=name, pooling_type=ptype))

    if class_name == "ZeroPadding2D":
        _check_data_format(cfg, data_format)
        pad = cfg.get("padding", 1)
        if isinstance(pad, (list, tuple)) and pad and \
                isinstance(pad[0], (list, tuple)):
            flat = (int(pad[0][0]), int(pad[0][1]),
                    int(pad[1][0]), int(pad[1][1]))
        else:
            p = _pair(pad)
            flat = (p[0], p[0], p[1], p[1])
        return Mapped(conv.ZeroPaddingLayer(name=name, padding=flat))

    if class_name == "BatchNormalization":
        axis = cfg.get("axis", -1)
        if isinstance(axis, (list, tuple)):
            axis = axis[0]
        # channels_last: -1/3 (or 1 for dense features); channels_first:
        # ONLY axis=1 (the NCHW channel axis) maps to our trailing axis —
        # -1/3 would be BN over width, silently wrong if accepted
        ok = (1,) if data_format == "channels_first" else (-1, 3, 1)
        if axis not in ok:
            raise UnsupportedKerasConfigurationException(
                f"BatchNormalization over axis {axis} unsupported under "
                f"{data_format} (the feature axis must map to our "
                "trailing NHWC axis)")
        return Mapped(conv.BatchNormalization(
            name=name, decay=float(cfg.get("momentum", 0.99)),
            eps=float(cfg.get("epsilon", 1e-3))),
            weights=_bn_weights, state=_bn_state)

    if class_name == "Embedding":
        return Mapped(core_layers.EmbeddingLayer(
            name=name, n_in=int(cfg["input_dim"]),
            n_out=int(cfg["output_dim"])), weights=_embedding_weights)

    if class_name == "LSTM":
        units = int(cfg["units"])
        layer = recurrent.LSTM(
            name=name, n_out=units, activation=_act_of(cfg),
            gate_activation=map_activation(
                cfg.get("recurrent_activation", "sigmoid")))
        m = Mapped(layer, weights=_lstm_weights(units))
        m.return_sequences = bool(cfg.get("return_sequences", False))
        return m

    raise UnsupportedKerasConfigurationException(
        f"Unsupported Keras layer type {class_name!r} "
        f"(layer {name!r})")


# Functional-model merge layers → graph vertices
def map_merge_vertex(class_name: str):
    from ..nn.graph import vertices as V
    if class_name == "Concatenate":
        return V.MergeVertex()
    if class_name == "Add":
        return V.ElementWiseVertex(op="add")
    if class_name == "Subtract":
        return V.ElementWiseVertex(op="subtract")
    if class_name == "Average":
        return V.ElementWiseVertex(op="average")
    if class_name == "Maximum":
        return V.ElementWiseVertex(op="max")
    if class_name == "Multiply":
        return V.ElementWiseVertex(op="product")
    return None
