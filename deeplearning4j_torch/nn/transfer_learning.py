"""Transfer learning: fine-tune, freeze, and surgically edit trained nets.

Port of `deeplearning4j_tpu/nn/transfer_learning.py`. Reference parity: nn/transferlearning/TransferLearning.java (808 LoC:
Builder with fineTuneConfiguration / setFeatureExtractor / removeOutputLayer
/ removeLayersFromOutput / nOutReplace / addLayer),
FineTuneConfiguration.java, TransferLearningHelper.java (featurize frozen-
graph activations and train only the unfrozen tail).

Surgery happens on the config dataclasses + the per-layer parameter dicts
directly (no flat-buffer index juggling); frozen layers keep their
parameters and optimizer state through the `frozen` flag the step already
honors (`_layer_step`; reference FrozenLayer wrapper). Retained trees are
copied into the new network on the old one's device, never aliased."""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import List, Optional

import torch

from ..data.dataset import DataSet
from .conf.builders import (MultiLayerConfiguration, NeuralNetConfiguration)
from .layers.core import Layer
from .multilayer import MultiLayerNetwork
from .updaters import Updater
from ..utils.params import tree_map


def _copy(tree):
    return tree_map(torch.clone, tree)


@dataclass
class FineTuneConfiguration:
    """Hyperparameter overrides applied to every NON-frozen layer (reference
    nn/transferlearning/FineTuneConfiguration.java)."""

    updater: Optional[Updater] = None
    learning_rate: Optional[float] = None
    dropout_rate: Optional[float] = None
    l1: Optional[float] = None
    l2: Optional[float] = None
    seed: Optional[int] = None

    def apply(self, layer: Layer) -> None:
        if self.updater is not None:
            layer.updater = copy.deepcopy(self.updater)
        if self.learning_rate is not None and layer.updater is not None:
            layer.updater.learning_rate = self.learning_rate
        if self.dropout_rate is not None:
            layer.dropout_rate = self.dropout_rate
        if self.l1 is not None:
            layer.l1 = self.l1
        if self.l2 is not None:
            layer.l2 = self.l2


class TransferLearning:
    """Entry point: TransferLearning.builder(net) (reference
    TransferLearning.Builder)."""

    @staticmethod
    def builder(net: MultiLayerNetwork) -> "TransferLearningBuilder":
        return TransferLearningBuilder(net)


class TransferLearningBuilder:
    def __init__(self, net: MultiLayerNetwork):
        net._check_init()
        self._net = net
        self._fine_tune: Optional[FineTuneConfiguration] = None
        self._freeze_until: Optional[int] = None
        self._n_removed = 0
        self._replacements = {}  # idx -> new n_out
        self._added: List[Layer] = []

    def fine_tune_configuration(self, ftc: FineTuneConfiguration):
        self._fine_tune = ftc
        return self

    def set_feature_extractor(self, layer_index: int):
        """Freeze layers 0..layer_index inclusive (reference
        setFeatureExtractor)."""
        self._freeze_until = int(layer_index)
        return self

    def remove_output_layer(self):
        return self.remove_layers_from_output(1)

    def remove_layers_from_output(self, n: int):
        self._n_removed += int(n)
        return self

    def n_out_replace(self, layer_index: int, n_out: int):
        """Replace layer's n_out (and reinit it + the next layer's matching
        n_in) — reference nOutReplace."""
        self._replacements[int(layer_index)] = int(n_out)
        return self

    def add_layer(self, layer: Layer):
        self._added.append(layer)
        return self

    def build(self) -> MultiLayerNetwork:
        old = self._net
        layers = [copy.deepcopy(l) for l in old.conf.layers]
        old_params = list(old.params_tree)
        old_state = list(old.state_tree)

        if self._n_removed:
            if self._n_removed > len(layers):
                raise ValueError("Removing more layers than exist")
            layers = layers[:-self._n_removed]
            old_params = old_params[:-self._n_removed]
            old_state = old_state[:-self._n_removed]

        reinit = set()  # indices whose params must be re-initialized
        for idx, n_out in self._replacements.items():
            if idx >= len(layers):
                raise ValueError(f"n_out_replace index {idx} out of range")
            layers[idx].n_out = n_out
            reinit.add(idx)
            if idx + 1 < len(layers) and hasattr(layers[idx + 1], "n_in"):
                layers[idx + 1].n_in = n_out
                reinit.add(idx + 1)

        first_new = len(layers)
        layers.extend(copy.deepcopy(l) for l in self._added)

        if self._freeze_until is not None:
            for i in range(min(self._freeze_until + 1, len(layers))):
                layers[i].frozen = True

        if self._fine_tune is not None:
            for i, layer in enumerate(layers):
                if not layer.frozen:
                    self._fine_tune.apply(layer)

        # Re-run shape inference for the whole (edited) stack.
        global_conf = NeuralNetConfiguration(seed=old.conf.seed)
        from .conf.builders import ListBuilder
        lb = ListBuilder(global_conf)
        for layer in layers:
            lb.layer(layer)
        if old.conf.input_type is not None:
            lb.set_input_type(old.conf.input_type)
        lb._backprop_type = old.conf.backprop_type
        lb._tbptt_fwd = old.conf.tbptt_fwd_length
        lb._tbptt_back = old.conf.tbptt_back_length
        new_conf = lb.build()

        new_net = MultiLayerNetwork(new_conf).init(dtype=old._dtype,
                                                   device=old.device)
        # Copy retained weights (reference: params view copy); reinit'd and
        # newly added layers keep their fresh init.
        new_params = list(new_net.params_tree)
        new_state = list(new_net.state_tree)
        for i in range(min(first_new, len(old_params), len(new_params))):
            if i in reinit:
                continue
            new_params[i] = _copy(old_params[i])
            new_state[i] = _copy(old_state[i])
        new_net.params_tree = tuple(new_params)
        new_net.state_tree = tuple(new_state)
        return new_net


class TransferLearningHelper:
    """Featurize through the frozen front, train only the tail (reference
    nn/transferlearning/TransferLearningHelper.java)."""

    def __init__(self, net: MultiLayerNetwork, frozen_until: int):
        net._check_init()
        self.net = net
        self.frozen_until = int(frozen_until)
        tail_layers = [copy.deepcopy(l) for l in net.conf.layers[
            self.frozen_until + 1:]]
        for l in tail_layers:
            l.frozen = False
        tail_conf = MultiLayerConfiguration(
            layers=tail_layers,
            input_preprocessors={
                str(i - self.frozen_until - 1): p
                for i, p in ((int(k), v) for k, v in
                             net.conf.input_preprocessors.items())
                if int(i) > self.frozen_until},
            seed=net.conf.seed)
        self.unfrozen = MultiLayerNetwork(tail_conf).init(dtype=net._dtype,
                                                          device=net.device)
        self.unfrozen.params_tree = tuple(
            _copy(p) for p in net.params_tree[self.frozen_until + 1:])
        self.unfrozen.state_tree = tuple(
            _copy(s) for s in net.state_tree[self.frozen_until + 1:])

    def featurize(self, ds: DataSet) -> DataSet:
        """Activations at the frozen boundary (reference featurize)."""
        acts = self.net.feed_forward(ds.features, train=False)
        return DataSet(acts[self.frozen_until + 1], ds.labels,
                       ds.features_mask, ds.labels_mask)

    def fit_featurized(self, ds: DataSet, epochs: int = 1,
                       batch_size: int = 32):
        self.unfrozen.fit(ds, epochs=epochs, batch_size=batch_size)
        # write tail params back into the full network
        full = list(self.net.params_tree)
        full[self.frozen_until + 1:] = list(self.unfrozen.params_tree)
        self.net.params_tree = tuple(full)
        full_s = list(self.net.state_tree)
        full_s[self.frozen_until + 1:] = list(self.unfrozen.state_tree)
        self.net.state_tree = tuple(full_s)
        return self

    def output_from_featurized(self, features):
        return self.unfrozen.output(features)
