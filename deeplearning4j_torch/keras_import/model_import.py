"""Keras HDF5 → MultiLayerNetwork / ComputationGraph importer.

Reference parity: modelimport/keras/KerasModelImport.java (entry points),
KerasModel.java:59 (config parse) → getComputationGraphConfiguration()
:419 → getComputationGraph(true) :522-527 (helperCopyWeightsToModel :662),
KerasSequentialModel → MultiLayerNetwork. Fixture-tested end-to-end like
KerasModelEndToEndTest.java: import, predict, compare to recorded Keras
outputs.

Supported (the reference's Keras-1.x surface, modulo era): Dense, Conv1D/
2D, MaxPooling2D/AveragePooling2D, GlobalPooling, BatchNormalization,
Embedding, LSTM, Activation, Dropout, Flatten, ZeroPadding2D; functional
models with Concatenate/Add/Subtract/Average/Maximum/Multiply merges.

Port of `deeplearning4j_tpu/keras_import/model_import.py`: the same
translation onto the port's networks, whose weights are torch tensors on
the network's device (CUDA unless the caller passes `device`), conv kernels
in the port's OIHW layout (utils/params.py). The file is read by the port's
own HDF5 loader (`hdf5.py`).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..nn.conf.builders import NeuralNetConfiguration
from ..nn.conf.inputs import InputType
from ..nn.graph.graph import ComputationGraph
from ..nn.graph.vertices import LastTimeStepVertex
from ..nn.multilayer import MultiLayerNetwork
from ..utils import params as param_utils
from ..utils.device import DeviceLike
from .layer_mappers import (Mapped, map_layer, map_loss, map_merge_vertex)
from .reader import (Hdf5Archive, InvalidKerasConfigurationException,
                     UnsupportedKerasConfigurationException)


def _input_type_from_shape(shape, data_format="channels_last") -> InputType:
    """batch_shape [None, ...] → InputType (the KerasInput role). Under
    channels_first the [C, H, W] input maps to our NHWC layout — callers
    feed NHWC-transposed arrays, the reference's
    TensorFlowCnnToFeedForwardPreProcessor dim-ordering contract."""
    dims = [d for d in shape[1:]]
    if any(d is None for d in dims):
        raise UnsupportedKerasConfigurationException(
            f"Dynamic input dims unsupported (static input shapes): {shape}")
    if len(dims) == 1:
        return InputType.feed_forward(int(dims[0]))
    if len(dims) == 2:  # [time, features]
        if data_format == "channels_first":
            raise UnsupportedKerasConfigurationException(
                "channels_first 1-D (Conv1D-style) models are not "
                "supported; only 2-D CNN channels_first import is")
        return InputType.recurrent(int(dims[1]),
                                   timeseries_length=int(dims[0]))
    if len(dims) == 3:
        if data_format == "channels_first":  # [c, h, w] → (h, w, c)
            return InputType.convolutional(int(dims[1]), int(dims[2]),
                                           int(dims[0]))
        return InputType.convolutional(int(dims[0]), int(dims[1]),
                                       int(dims[2]))
    raise UnsupportedKerasConfigurationException(
        f"Unsupported input rank for shape {shape}")


def _detect_data_format(layer_cfgs) -> str:
    """Model-wide dim ordering: any layer declaring channels_first flips
    the whole model (Keras models are uniformly one ordering; mixtures
    are rejected layer-by-layer in _check_data_format)."""
    for lc in layer_cfgs:
        if lc.get("config", {}).get("data_format") == "channels_first":
            return "channels_first"
    return "channels_last"


def _permute_flatten_dense(weights_fn, h: int, w: int, c: int):
    """Wrap a dense weight transform so kernel ROWS reorder from Keras's
    channels_first flatten order (c, h, w) to our NHWC flatten order
    (h, w, c) — the TensorFlowCnnToFeedForwardPreProcessor fix."""
    perm = np.arange(c * h * w).reshape(c, h, w).transpose(1, 2, 0).reshape(-1)

    def fixed(kw):
        out = dict(weights_fn(kw))
        out["W"] = np.asarray(out["W"])[perm]
        return out
    return fixed


def _batch_shape(layer_cfg: dict) -> Optional[list]:
    cfg = layer_cfg.get("config", {})
    return cfg.get("batch_shape") or cfg.get("batch_input_shape")


def _loss_from_training_config(tc: Optional[dict]) -> Optional[str]:
    if not tc:
        return None
    loss = tc.get("loss")
    if loss is None:
        return None
    if isinstance(loss, dict):
        # keras serializes loss objects as {"class_name": ..} or per-output
        # dicts; take the first string-ish entry.
        loss = loss.get("class_name") or next(iter(loss.values()), None)
        if isinstance(loss, dict):
            loss = loss.get("class_name")
    if isinstance(loss, str):
        try:
            return map_loss(loss)
        except UnsupportedKerasConfigurationException:
            return None
    return None


def _reference_shape(t) -> tuple:
    """A port leaf's shape in the JAX package's (Keras's) layout: HWIO for a
    4-D conv kernel, which the port stores OIHW."""
    s = tuple(t.shape)
    return (s[2], s[3], s[1], s[0]) if len(s) == 4 else s


def _leaf(arr: np.ndarray, dtype, device):
    """A Keras array as a port leaf on `device`, cast to `dtype` if given."""
    t = param_utils.params_from_numpy({"leaf": np.asarray(arr)}, device)["leaf"]
    return t if dtype is None else t.to(dtype)


def _set_weights(tree_params: dict, tree_state: dict, mapped: Mapped,
                 kw: Dict[str, np.ndarray], dtype, device):
    """Overwrite one layer's initialized params/state with Keras values,
    shape-checked (reference helperCopyWeightsToModel, KerasModel.java:662)."""
    if mapped.weights is not None and tree_params and not kw:
        raise InvalidKerasConfigurationException(
            f"No weights found in the h5 file for layer "
            f"{mapped.layer.name!r} — silently keeping random init would "
            "produce garbage predictions")
    new_p = dict(tree_params)
    if mapped.weights is not None and kw:
        for pname, arr in mapped.weights(kw).items():
            if pname not in tree_params:
                raise InvalidKerasConfigurationException(
                    f"Layer {mapped.layer.name!r}: no parameter {pname!r} "
                    f"(has {sorted(tree_params)})")
            want = _reference_shape(tree_params[pname])
            got = tuple(arr.shape)
            if want != got:
                raise InvalidKerasConfigurationException(
                    f"Layer {mapped.layer.name!r} param {pname!r}: Keras "
                    f"shape {got} != expected {want}")
            new_p[pname] = _leaf(arr, dtype, device)
    new_s = dict(tree_state)
    if mapped.state is not None and kw:
        for sname, arr in mapped.state(kw).items():
            new_s[sname] = _leaf(arr, None, device)
    return new_p, new_s


class KerasModelImport:
    """Entry points (reference KerasModelImport.java)."""

    # ----------------------------------------------------------- sequential
    @staticmethod
    def import_keras_sequential_model_and_weights(
            path: str, enforce_training_config: bool = False,
            device: DeviceLike = None) -> MultiLayerNetwork:
        """Sequential .h5 → MultiLayerNetwork (reference
        importKerasSequentialModelAndWeights) on `device` (default: CUDA,
        raising when there is none)."""
        with Hdf5Archive(path) as ar:
            cfg = ar.model_config()
            if cfg.get("class_name") != "Sequential":
                raise InvalidKerasConfigurationException(
                    f"Not a Sequential model: {cfg.get('class_name')!r}; "
                    "use import_keras_model_and_weights")
            loss = _loss_from_training_config(ar.training_config())
            if enforce_training_config and loss is None:
                raise InvalidKerasConfigurationException(
                    "Model has no training_config (was it compiled before "
                    "saving?)")
            layer_cfgs = cfg["config"]["layers"]
            data_format = _detect_data_format(layer_cfgs)

            input_type = None
            mapped_layers: List[Tuple[Mapped, str]] = []  # (mapped, keras name)
            last_param_idx = max(
                (i for i, lc in enumerate(layer_cfgs)
                 if lc["class_name"] not in
                 ("InputLayer", "Activation", "Dropout", "Flatten")),
                default=-1)
            # Dense → Activation('softmax') tail (a very common Keras
            # idiom): fold the trailing activation INTO the loss head, so
            # the imported net both trains on post-activation outputs and
            # ends in an output layer as MultiLayerNetwork requires.
            terminal_act = None
            fold_idx = None
            tail_head = None
            if 0 <= last_param_idx < len(layer_cfgs) - 1:
                trailing = [(i, lc) for i, lc in
                            enumerate(layer_cfgs[last_param_idx + 1:],
                                      last_param_idx + 1)
                            if lc["class_name"] == "Activation"]
                term_cfg = layer_cfgs[last_param_idx]
                if len(trailing) == 1 and \
                        trailing[0][0] == len(layer_cfgs) - 1:
                    from .layer_mappers import map_activation
                    if term_cfg.get("config", {}).get(
                            "activation", "linear") == "linear":
                        # Linear param layer: fold the activation INTO the
                        # loss head.
                        fold_idx = trailing[0][0]
                        terminal_act = map_activation(
                            trailing[0][1]["config"].get("activation",
                                                         "linear"))
                    else:
                        # Dense(relu) → Activation(softmax): folding would
                        # drop the relu, so the Activation itself becomes
                        # the LossLayer head and the Dense stays plain.
                        last_param_idx = -1  # no param layer is terminal
                        fold_idx = trailing[0][0]
                        act = map_activation(
                            trailing[0][1]["config"].get("activation",
                                                         "linear"))
                        from ..nn.layers.core import LossLayer
                        from .layer_mappers import _LOSS_BY_ACTIVATION
                        tail_head = LossLayer(
                            name=trailing[0][1]["config"].get("name"),
                            activation=act,
                            loss=loss or _LOSS_BY_ACTIVATION.get(act,
                                                                 "mse"))
            for i, lc in enumerate(layer_cfgs):
                if i == fold_idx:
                    continue  # folded into the terminal loss head
                shape = _batch_shape(lc)
                if shape is not None and input_type is None:
                    input_type = _input_type_from_shape(shape, data_format)
                m = map_layer(lc["class_name"], lc.get("config", {}),
                              is_terminal=(i == last_param_idx), loss=loss,
                              data_format=data_format)
                if i == last_param_idx and terminal_act is not None and \
                        m.layer is not None:
                    m.layer.activation = terminal_act
                    if loss is None and hasattr(m.layer, "loss"):
                        from .layer_mappers import _LOSS_BY_ACTIVATION
                        m.layer.loss = _LOSS_BY_ACTIVATION.get(
                            terminal_act, "mse")
                if getattr(m, "return_sequences", True) is False:
                    raise UnsupportedKerasConfigurationException(
                        "LSTM(return_sequences=False) needs a last-time-step "
                        "vertex; use import_keras_model_and_weights (graph)")
                if not m.skip:
                    mapped_layers.append((m, lc["config"].get("name", "")))
            if tail_head is not None:
                mapped_layers.append((Mapped(tail_head), ""))
            if input_type is None:
                raise InvalidKerasConfigurationException(
                    "Could not find an input shape (no batch_shape on any "
                    "layer)")

            # Global default activation must be identity: layers without a
            # Keras activation (BN, pooling, dropout) would otherwise
            # inherit the DL4J-parity default (sigmoid) and corrupt parity.
            lb = NeuralNetConfiguration.builder().activation("identity").list()
            for m, _ in mapped_layers:
                lb.layer(m.layer)
            conf = lb.set_input_type(input_type).build()
            net = MultiLayerNetwork(conf).init(device=device)

            if data_format == "channels_first":
                # first dense after a CNN stage: Keras flattened (c,h,w),
                # we flatten (h,w,c) — permute its kernel rows (the
                # TensorFlowCnnToFeedForwardPreProcessor role)
                from ..nn.conf.inputs import CnnToFeedForwardPreProcessor
                for idx, (m, _) in enumerate(mapped_layers):
                    p = conf.preprocessor(idx)
                    if isinstance(p, CnnToFeedForwardPreProcessor) and \
                            m.weights is not None:
                        m.weights = _permute_flatten_dense(
                            m.weights, p.height, p.width, p.channels)

            params = list(net.params_tree)
            states = list(net.state_tree)
            for idx, (m, kname) in enumerate(mapped_layers):
                kw = ar.layer_weights(kname)
                params[idx], states[idx] = _set_weights(
                    params[idx], states[idx], m, kw, net._dtype, net.device)
            net.params_tree = tuple(params)
            net.state_tree = tuple(states)
            return net

    # ------------------------------------------------------------ functional
    @staticmethod
    def import_keras_model_and_weights(path: str, device: DeviceLike = None
                                       ) -> ComputationGraph:
        """Functional (or Sequential) .h5 → ComputationGraph (reference
        importKerasModelAndWeights) on `device` (default: CUDA, raising when
        there is none)."""
        with Hdf5Archive(path) as ar:
            cfg = ar.model_config()
            loss = _loss_from_training_config(ar.training_config())
            if cfg.get("class_name") == "Sequential":
                layer_cfgs, inbound, inputs, outputs = \
                    KerasModelImport._sequential_as_graph(cfg)
                if _detect_data_format(layer_cfgs) == "channels_first":
                    raise UnsupportedKerasConfigurationException(
                        "channels_first import is supported on the "
                        "sequential path only; use "
                        "import_keras_sequential_model_and_weights")
            elif cfg.get("class_name") in ("Functional", "Model"):
                gc = cfg["config"]
                layer_cfgs = gc["layers"]
                if _detect_data_format(layer_cfgs) == "channels_first":
                    raise UnsupportedKerasConfigurationException(
                        "channels_first functional models are not "
                        "supported (sequential channels_first is)")
                inbound = {lc["config"]["name"]:
                           _inbound_names(lc.get("inbound_nodes", []))
                           for lc in layer_cfgs}
                inputs = _node_refs(gc["input_layers"])
                outputs = _node_refs(gc["output_layers"])
            else:
                raise InvalidKerasConfigurationException(
                    f"Unsupported model class {cfg.get('class_name')!r}")
            return KerasModelImport._build_graph(
                ar, layer_cfgs, inbound, inputs, outputs, loss, device)

    @staticmethod
    def _sequential_as_graph(cfg):
        layer_cfgs = list(cfg["config"]["layers"])
        if layer_cfgs and layer_cfgs[0]["class_name"] != "InputLayer":
            # Keras 2.x Sequential h5: no InputLayer entry — the first
            # real layer carries batch_input_shape. Synthesize the input
            # node so the first layer is NOT mistaken for a graph input
            # (which would silently drop it and its weights).
            shape = _batch_shape(layer_cfgs[0])
            if shape is None:
                raise InvalidKerasConfigurationException(
                    "Sequential model without InputLayer or "
                    "batch_input_shape on its first layer")
            layer_cfgs.insert(0, {"class_name": "InputLayer",
                                  "config": {"name": "__keras_input__",
                                             "batch_shape": shape}})
        names = []
        inbound = {}
        prev = None
        for i, lc in enumerate(layer_cfgs):
            name = lc["config"].get("name") or f"layer{i}"
            lc["config"]["name"] = name
            inbound[name] = [prev] if prev is not None else []
            names.append(name)
            prev = name
        return layer_cfgs, inbound, [names[0]], [names[-1]]

    @staticmethod
    def _build_graph(ar, layer_cfgs, inbound, inputs, outputs, loss,
                     device: DeviceLike = None) -> ComputationGraph:
        # identity default: see sequential path (Keras-less layers must not
        # inherit the DL4J sigmoid default).
        gb = NeuralNetConfiguration.builder().activation("identity") \
            .graph_builder()
        graph_inputs: List[str] = []
        input_types: List[InputType] = []
        mapped: Dict[str, Mapped] = {}
        renames: Dict[str, str] = {}  # keras name → our sink node name
        out_set = set(outputs)

        for lc in layer_cfgs:
            cname = lc["class_name"]
            kname = lc["config"].get("name", cname)
            srcs = [renames.get(s, s) for s in inbound.get(kname, [])]
            if cname == "InputLayer" or (not srcs and kname in inputs):
                shape = _batch_shape(lc)
                if shape is None:
                    raise InvalidKerasConfigurationException(
                        f"Input layer {kname!r} has no batch_shape")
                graph_inputs.append(kname)
                input_types.append(_input_type_from_shape(shape))
                continue
            vertex = map_merge_vertex(cname)
            if vertex is not None:
                gb.add_vertex(kname, vertex, *srcs)
                continue
            m = map_layer(cname, lc.get("config", {}),
                          is_terminal=kname in out_set, loss=loss)
            if m.skip:
                renames[kname] = srcs[0] if srcs else kname
                continue
            mapped[kname] = m
            gb.add_layer(kname, m.layer, *srcs)
            if getattr(m, "return_sequences", True) is False:
                # Keras LSTM(return_sequences=False) == last time step.
                last = f"{kname}-last"
                gb.add_vertex(last, LastTimeStepVertex(), kname)
                renames[kname] = last

        gb.add_inputs(*graph_inputs)
        gb.set_outputs(*[renames.get(o, o) for o in outputs])
        gb.set_input_types(*input_types)
        graph = ComputationGraph(gb.build()).init(device=device)

        new_params = dict(graph.params_tree)
        new_states = dict(graph.state_tree)
        for kname, m in mapped.items():
            kw = ar.layer_weights(kname)
            new_params[kname], new_states[kname] = _set_weights(
                graph.params_tree[kname], graph.state_tree[kname], m, kw,
                graph._dtype, graph.device)
        graph.params_tree = new_params
        graph.state_tree = new_states
        return graph


def _inbound_names(inbound_nodes) -> List[str]:
    """Extract upstream layer names from Keras 3 (keras_history) or Keras
    1/2 (nested list) inbound-node records."""
    found: List[str] = []

    def walk(obj):
        if isinstance(obj, dict):
            if obj.get("class_name") == "__keras_tensor__":
                found.append(obj["config"]["keras_history"][0])
                return
            for v in obj.values():
                walk(v)
        elif isinstance(obj, (list, tuple)):
            # keras 1/2 format: ["layer_name", node_idx, tensor_idx, ...]
            if obj and isinstance(obj[0], str) and len(obj) >= 3 and \
                    isinstance(obj[1], int):
                found.append(obj[0])
                return
            for v in obj:
                walk(v)
    walk(inbound_nodes)
    # de-dup preserving order (a layer can feed twice legitimately — keep
    # duplicates; only collapse EXACT repeats produced by double-walking)
    return found


def _node_refs(refs) -> List[str]:
    """input_layers/output_layers entries: [name, 0, 0] or [[name,0,0],...]."""
    if refs and isinstance(refs[0], str):
        return [refs[0]]
    return [r[0] for r in refs]
