"""ComputationGraphConfiguration + GraphBuilder DSL.

Port of `deeplearning4j_tpu/nn/conf/graph_conf.py` (reference
nn/conf/ComputationGraphConfiguration.java and its GraphBuilder): named
inputs, add_layer/add_vertex with input names, set_outputs, per-layer
preprocessors, a MergeVertex inserted where a layer is given several
inputs, input-type-driven shape inference and preprocessor insertion, JSON
round trips. The same registered names and fields as the JAX package, so a
configuration written by either loads in the other and builds the same
topological order.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Optional

from ...utils import serde
from ..graph.vertices import GraphVertex, MergeVertex
from ..layers.core import Layer
from .builders import BackpropType, _normalize_input_type, _preprocessor_for
from .inputs import InputPreProcessor, InputType


@serde.register
@dataclass
class GraphNode:
    """One named node: a layer (with an optional preprocessor) or a vertex."""

    inputs: List[str] = dc_field(default_factory=list)
    layer: Optional[Layer] = None
    vertex: Optional[GraphVertex] = None
    preprocessor: Optional[InputPreProcessor] = None

    def is_layer(self) -> bool:
        return self.layer is not None


@serde.register
@dataclass
class ComputationGraphConfiguration:
    network_inputs: List[str] = dc_field(default_factory=list)
    network_outputs: List[str] = dc_field(default_factory=list)
    nodes: Dict[str, GraphNode] = dc_field(default_factory=dict)
    topo_order: List[str] = dc_field(default_factory=list)
    input_types: Optional[List[InputType]] = None
    seed: int = 12345
    backprop_type: BackpropType = BackpropType.STANDARD
    tbptt_fwd_length: int = 20
    tbptt_back_length: int = 20
    iteration_count: int = 0
    epoch_count: int = 0

    def to_json(self) -> str:
        return serde.to_json(self)

    @staticmethod
    def from_json(s: str) -> "ComputationGraphConfiguration":
        obj = serde.from_json(s)
        if not isinstance(obj, ComputationGraphConfiguration):
            raise ValueError("JSON did not decode to a "
                             "ComputationGraphConfiguration")
        return obj

    def clone(self) -> "ComputationGraphConfiguration":
        return copy.deepcopy(self)


def _toposort(nodes: Dict[str, GraphNode], inputs: List[str]) -> List[str]:
    """Kahn's algorithm (reference ComputationGraph.topologicalSortOrder),
    ready nodes taken in insertion order: the JAX package's order, which
    the walk, the regularization sum and feed_forward_named follow."""
    indeg = {name: 0 for name in nodes}
    dependents: Dict[str, List[str]] = {name: [] for name in nodes}
    for name, node in nodes.items():
        for inp in node.inputs:
            if inp not in nodes and inp not in inputs:
                raise ValueError(f"Node {name!r} references unknown input "
                                 f"{inp!r}")
            if inp in nodes:
                indeg[name] += 1
                dependents[inp].append(name)
    order: List[str] = []
    ready = [n for n in nodes if indeg[n] == 0]
    while ready:
        n = ready.pop(0)
        order.append(n)
        for d in dependents[n]:
            indeg[d] -= 1
            if indeg[d] == 0:
                ready.append(d)
    if len(order) != len(nodes):
        cyclic = sorted(set(nodes) - set(order))
        raise ValueError(f"Graph has a cycle involving {cyclic}")
    return order


class GraphBuilder:
    """Reference ComputationGraphConfiguration.GraphBuilder surface
    (`NeuralNetConfigurationBuilder.graph_builder()`)."""

    def __init__(self, global_conf):
        self._global = global_conf
        self._inputs: List[str] = []
        self._input_types: Optional[List[InputType]] = None
        self._outputs: List[str] = []
        self._nodes: Dict[str, GraphNode] = {}
        self._backprop_type = BackpropType.STANDARD
        self._tbptt_fwd = 20
        self._tbptt_back = 20

    def add_inputs(self, *names: str) -> "GraphBuilder":
        self._inputs = list(names)
        return self

    def set_input_types(self, *types: InputType) -> "GraphBuilder":
        self._input_types = list(types)
        return self

    def _check_new(self, name: str):
        if name in self._nodes or name in self._inputs:
            raise ValueError(f"Duplicate node name {name!r}")

    def add_layer(self, name: str, layer: Layer, *inputs: str,
                  preprocessor: Optional[InputPreProcessor] = None
                  ) -> "GraphBuilder":
        self._check_new(name)
        in_names = list(inputs)
        if len(in_names) > 1:
            # implicit merge, like the reference's "-merge" vertex
            merge_name = f"{name}-merge"
            if merge_name in self._nodes or merge_name in self._inputs:
                raise ValueError(
                    f"Implicit merge vertex name {merge_name!r} collides "
                    f"with an existing node; rename that node or merge "
                    f"explicitly via add_vertex")
            self._nodes[merge_name] = GraphNode(inputs=in_names,
                                                vertex=MergeVertex())
            in_names = [merge_name]
        self._nodes[name] = GraphNode(inputs=in_names, layer=layer,
                                      preprocessor=preprocessor)
        return self

    def add_vertex(self, name: str, vertex: GraphVertex, *inputs: str
                   ) -> "GraphBuilder":
        self._check_new(name)
        n = vertex.n_inputs()
        if n is not None and len(inputs) != n:
            raise ValueError(f"{type(vertex).__name__} needs {n} inputs, "
                             f"got {len(inputs)}")
        self._nodes[name] = GraphNode(inputs=list(inputs), vertex=vertex)
        return self

    def set_outputs(self, *names: str) -> "GraphBuilder":
        self._outputs = list(names)
        return self

    def backprop_type(self, t: BackpropType) -> "GraphBuilder":
        self._backprop_type = t
        return self

    def tbptt_fwd_length(self, n: int) -> "GraphBuilder":
        self._tbptt_fwd = int(n)
        return self

    def tbptt_back_length(self, n: int) -> "GraphBuilder":
        self._tbptt_back = int(n)
        return self

    def build(self) -> ComputationGraphConfiguration:
        if not self._inputs:
            raise ValueError("GraphBuilder: call add_inputs(...) first")
        if not self._outputs:
            raise ValueError("GraphBuilder: call set_outputs(...)")
        for out in self._outputs:
            if out not in self._nodes:
                raise ValueError(f"Output {out!r} is not a node")
        nodes = {name: GraphNode(inputs=list(n.inputs),
                                 layer=copy.deepcopy(n.layer),
                                 vertex=copy.deepcopy(n.vertex),
                                 preprocessor=n.preprocessor)
                 for name, n in self._nodes.items()}
        for node in nodes.values():
            if node.is_layer():
                self._global.merge_defaults(node.layer)
        # Output (loss-head) layers must be sinks: the training walk feeds a
        # head its INPUT, so a consumer would see other values in training
        # than in inference.
        for name, node in nodes.items():
            for inp in node.inputs:
                parent = nodes.get(inp)
                if parent is not None and parent.is_layer() and \
                        parent.layer.is_output_layer():
                    raise ValueError(
                        f"Node {name!r} consumes output layer {inp!r}; "
                        "output layers must be graph sinks")
        order = _toposort(nodes, self._inputs)

        # shape inference + preprocessor insertion along the order
        if self._input_types is not None:
            if len(self._input_types) != len(self._inputs):
                raise ValueError("set_input_types: need one type per input")
            types: Dict[str, InputType] = dict(zip(self._inputs,
                                                   self._input_types))
            for name in order:
                node = nodes[name]
                in_types = [types[i] for i in node.inputs]
                if node.is_layer():
                    it = in_types[0]
                    if node.preprocessor is None:
                        node.preprocessor = _preprocessor_for(node.layer, it)
                    if node.preprocessor is not None:
                        it = node.preprocessor.output_type(it)
                    types[name] = node.layer.set_input_type(
                        _normalize_input_type(it, node.layer))
                else:
                    types[name] = node.vertex.output_type(in_types)

        return ComputationGraphConfiguration(
            network_inputs=list(self._inputs),
            network_outputs=list(self._outputs),
            nodes=nodes,
            topo_order=order,
            input_types=self._input_types,
            seed=self._global.seed,
            backprop_type=self._backprop_type,
            tbptt_fwd_length=self._tbptt_fwd,
            tbptt_back_length=self._tbptt_back,
        )
