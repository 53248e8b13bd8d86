"""Sibling-convolution fusion for ComputationGraph configurations.

Port of the graph half of `deeplearning4j_tpu/nn/graph/fusion.py`. An
inception block fans one activation out into small parallel convolutions
(GoogLeNet's cnn1/cnn2/cnn3 are 1x1 convs of the same input). Branches that
share their input, geometry, activation, regularization and updater are one
convolution whose kernel is the concatenation of theirs on the
output-channel axis:

    conv(x, W1) ++ conv(x, W2) ++ conv(x, W3) == conv(x, W1 ++ W2 ++ W3)

`fuse_sibling_convs` rewrites a built configuration so: the sibling layer
nodes become one fused ConvolutionLayer (or DenseLayer) node plus a
SubsetVertex per member that keeps the member's name, so consumers, JSON and
network outputs are untouched. `fuse_params`/`unfuse_params` carry
parameters and optimizer state across (a concatenation or a slice, so the
fused network computes the same function; cuDNN may sum a wider conv in
another order) and `fuse_graph` does both for an initialized graph.

Exactness gates, as in the JAX package: the same conv geometry, activation,
regularization, updater and weight init; no gradient normalization (a
per-layer norm would couple the branches), no dropout, no preprocessor, one
input, not a network output. `sibling_conv_fusion_total` counts the groups
fused and the candidates rejected (the JAX package's metric family of that
name, a plain dict here until optimize/metrics.py is ported).

The multi-model serving merge (`merge_serving_conf`,
`build_fused_serving_net`) is the substrate of the serving plane's fused
groups (serving/model_pool.FusedModelGroup): N same-input graphs merged
under name prefixes into one inference-only graph whose `serving_concat`
MergeVertex puts every member's output side by side, sibling-fused, so one
forward answers for all of them.
"""
from __future__ import annotations

import copy
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ...utils import params as param_utils
from ...utils import serde
from ..conf.graph_conf import ComputationGraphConfiguration, GraphNode, _toposort
from ..layers.convolution import ConvolutionLayer
from ..layers.core import DenseLayer
from ..updaters import GradientNormalization
from .vertices import MergeVertex, SubsetVertex

#: decisions of the fusion pass in this process, by outcome
sibling_conv_fusion_total = {"fused": 0, "rejected": 0}
_count_lock = threading.Lock()


def _count_fusion(outcome: str, n: int = 1) -> None:
    with _count_lock:
        sibling_conv_fusion_total[outcome] += n


@dataclass(frozen=True)
class FusionGroup:
    """One fused sibling set: `members` (original node names, in
    topological order) now read `fused_name` through SubsetVertex slices of
    width `n_outs[i]` starting at `offsets[i]`."""

    fused_name: str
    input: str
    members: Tuple[str, ...]
    n_outs: Tuple[int, ...]

    @property
    def offsets(self) -> Tuple[int, ...]:
        out, off = [], 0
        for n in self.n_outs:
            out.append(off)
            off += n
        return tuple(out)


def _fusion_key(layer):
    """Everything that must match for the concatenation to be exact."""
    base = (
        type(layer).__name__,
        layer.n_in, layer.activation,
        layer.l1, layer.l2, layer.l1_bias, layer.l2_bias,
        layer.frozen,
        serde.to_json(layer.updater) if layer.updater else None,
        serde.to_json(layer.dist) if layer.dist else None,
        layer.weight_init,
    )
    if isinstance(layer, ConvolutionLayer):
        base += (tuple(layer.kernel_size), tuple(layer.stride),
                 tuple(layer.padding), tuple(layer.dilation),
                 layer._mode().value, layer.conv_algo)
    return base


# Strict types only: OutputLayer subclasses DenseLayer but is a loss head.
_FUSIBLE_TYPES = (ConvolutionLayer, DenseLayer)


def _fusible(node: GraphNode, name: str,
             conf: ComputationGraphConfiguration) -> bool:
    if not node.is_layer() or type(node.layer) not in _FUSIBLE_TYPES:
        return False
    if len(node.inputs) != 1 or node.preprocessor is not None:
        return False
    if name in conf.network_outputs:
        return False
    layer = node.layer
    if layer.n_out <= 0 or layer.dropout_rate:
        return False
    gn = layer.gradient_normalization
    return gn is None or gn == GradientNormalization.NONE


def find_sibling_conv_groups(conf: ComputationGraphConfiguration
                             ) -> List[FusionGroup]:
    """Same-input sibling layers whose fusion is exact, grouped by (input,
    fusion key) in topological order; a group needs two members."""
    buckets: Dict[tuple, List[str]] = {}
    for name in conf.topo_order:
        node = conf.nodes[name]
        if _fusible(node, name, conf):
            buckets.setdefault((node.inputs[0],) + _fusion_key(node.layer),
                               []).append(name)
    groups = []
    for key, members in buckets.items():
        if len(members) < 2:
            continue
        fused_name = "+".join(members)
        if fused_name in conf.nodes or fused_name in conf.network_inputs:
            _count_fusion("rejected", len(members))
            continue
        groups.append(FusionGroup(
            fused_name=fused_name, input=key[0], members=tuple(members),
            n_outs=tuple(conf.nodes[m].layer.n_out for m in members)))
    return groups


def fuse_sibling_convs(conf: ComputationGraphConfiguration
                       ) -> Tuple[ComputationGraphConfiguration,
                                  List[FusionGroup]]:
    """(fused configuration, groups). `conf` is not changed; with nothing
    to fuse the clone comes back as it was."""
    new = conf.clone()
    groups = find_sibling_conv_groups(new)
    for grp in groups:
        fused_layer = copy.deepcopy(new.nodes[grp.members[0]].layer)
        fused_layer.n_out = sum(grp.n_outs)
        fused_layer.name = grp.fused_name
        new.nodes[grp.fused_name] = GraphNode(inputs=[grp.input],
                                              layer=fused_layer)
        for m, n, off in zip(grp.members, grp.n_outs, grp.offsets):
            new.nodes[m] = GraphNode(
                inputs=[grp.fused_name],
                vertex=SubsetVertex(from_idx=off, to_idx=off + n - 1))
        _count_fusion("fused")
    if groups:
        new.topo_order = _toposort(new.nodes, new.network_inputs)
    return new, groups


# ---------------------------------------------------------------------------
# Parameters and optimizer state across the fusion boundary. The port's
# layout: OIHW kernels (output channels on axis 0), [n_in, n_out] dense
# weights, 1-D biases.
# ---------------------------------------------------------------------------

def _concat_leaves(leaves):
    a = leaves[0]
    if a.ndim == 4:
        return param_utils.place(torch.cat(leaves, dim=0), a.device)
    if a.ndim == 2:
        return torch.cat(leaves, dim=1)
    if a.ndim == 1:
        return torch.cat(leaves, dim=0)
    for other in leaves[1:]:
        if other.shape != a.shape:
            raise ValueError(f"Cannot fuse rank-{a.ndim} state leaves of shapes "
                             f"{[tuple(t.shape) for t in leaves]}")
    return a


def _slice_leaf(leaf, off: int, n: int):
    if leaf.ndim == 4:
        return param_utils.place(leaf[off:off + n], leaf.device)
    if leaf.ndim == 2:
        return leaf[:, off:off + n].contiguous()
    if leaf.ndim == 1:
        return leaf[off:off + n].contiguous()
    return leaf


def fuse_params(groups: Sequence[FusionGroup], tree: Dict[str, dict]
                ) -> Dict[str, dict]:
    """An unfused per-node tree (parameters, optimizer or layer state) on the
    fused graph: the members' entries concatenated into the fused node's,
    every other entry passed through."""
    members = {m for g in groups for m in g.members}
    out = {k: v for k, v in tree.items() if k not in members}
    for grp in groups:
        subs = [param_utils.tree_leaves(tree[m]) for m in grp.members]
        out[grp.fused_name] = param_utils.tree_unflatten(
            tree[grp.members[0]], [_concat_leaves(ls) for ls in zip(*subs)])
    return out


def unfuse_params(groups: Sequence[FusionGroup], tree: Dict[str, dict]
                  ) -> Dict[str, dict]:
    """Inverse of :func:`fuse_params`: the fused node's entry sliced back
    into the members' entries."""
    fused = {g.fused_name for g in groups}
    out = {k: v for k, v in tree.items() if k not in fused}
    for grp in groups:
        sub = tree[grp.fused_name]
        for m, n, off in zip(grp.members, grp.n_outs, grp.offsets):
            out[m] = param_utils.tree_map(lambda leaf: _slice_leaf(leaf, off, n),
                                          sub)
    return out


def fuse_graph(net):
    """An initialized ComputationGraph -> the fused graph carrying the same
    parameters, optimizer state and layer state (concatenated copies, not
    drawn anew), iteration and epoch, on the same device. Returns `net`
    itself when nothing is fusible."""
    from .graph import ComputationGraph
    fused_conf, groups = fuse_sibling_convs(net.conf)
    if not groups:
        return net
    out = ComputationGraph(fused_conf)

    def carried(tree):
        # copies in the fused graph's node order: a pass-through entry must
        # not alias the donor's tensors
        fused = fuse_params(groups, tree)
        return {n: param_utils.tree_map(torch.clone, fused[n])
                for n in out._layer_nodes}

    out._adopt(carried(net.params_tree), net._dtype, net.device,
               opt_state=carried(net.opt_state),
               state_tree=carried(net.state_tree))
    out.iteration = net.iteration
    out.epoch = net.epoch
    return out


# ---------------------------------------------------------------------------
# Multi-model serving merge (serving/model_pool.py FusedModelGroup substrate)
# ---------------------------------------------------------------------------

# Name of the synthetic concat head the merged serving graph ends in.
SERVING_CONCAT = "serving_concat"


class FusionIneligibleError(ValueError):
    """The member set cannot be merged into one fused serving forward
    (geometry/type/init/device mismatch). ModelPool catches this and falls
    back to independent per-model entries — never a hard failure."""


def _serving_member_ok(name: str, net) -> None:
    """Raise FusionIneligibleError unless `net` is a single-input,
    single-output, initialized ComputationGraph whose head is a sized
    layer (the shapes the column slicing needs)."""
    conf = getattr(net, "conf", None)
    if not isinstance(conf, ComputationGraphConfiguration):
        raise FusionIneligibleError(
            f"member {name!r} is not a ComputationGraph (only graph "
            "models can merge into a fused serving forward)")
    if not getattr(net, "_initialized", False):
        raise FusionIneligibleError(f"member {name!r} is not init()ed")
    if len(conf.network_inputs) != 1 or len(conf.network_outputs) != 1:
        raise FusionIneligibleError(
            f"member {name!r} must have exactly one input and one "
            f"output (has {len(conf.network_inputs)}/"
            f"{len(conf.network_outputs)})")
    if not conf.input_types:
        raise FusionIneligibleError(
            f"member {name!r} was built without set_input_types(...) — "
            "the fused engine cannot warm its buckets")
    head = conf.nodes[conf.network_outputs[0]]
    if not head.is_layer() or getattr(head.layer, "n_out", 0) <= 0:
        raise FusionIneligibleError(
            f"member {name!r} head {conf.network_outputs[0]!r} has no "
            "sized n_out to slice columns by")


def merge_serving_conf(named_members: Sequence[Tuple[str, object]]
                       ) -> Tuple[ComputationGraphConfiguration,
                                  Dict[str, Tuple[int, int]]]:
    """Merge N same-input-geometry single-head graphs into ONE inference
    config: every member's nodes are cloned under a ``{member}/`` name
    prefix, all members read one shared network input, and a final
    MergeVertex (``serving_concat``) channel-concatenates the member heads
    so one forward yields every member's output side by side.

    Returns (merged_conf, col_slices) where ``col_slices[member] = (offset,
    width)`` locates that member's columns in the concat. The merged config
    is INFERENCE-ONLY (a MergeVertex over output heads cannot train).

    Raises :class:`FusionIneligibleError` when members diverge (not graphs,
    different input types, devices or types, duplicate names, <2
    members)."""
    if len(named_members) < 2:
        raise FusionIneligibleError("a fused group needs >= 2 members")
    names = [nm for nm, _ in named_members]
    if len(set(names)) != len(names):
        raise FusionIneligibleError(f"duplicate member names in {names}")
    for nm, net in named_members:
        _serving_member_ok(nm, net)
    first_net = named_members[0][1]
    first = first_net.conf
    for nm, net in named_members[1:]:
        if net.conf.input_types != first.input_types:
            raise FusionIneligibleError(
                f"member {nm!r} input type {net.conf.input_types} != "
                f"{first.input_types} — fused batching needs identical "
                "input geometry")
        if net.device != first_net.device or net._dtype != first_net._dtype:
            raise FusionIneligibleError(
                f"member {nm!r} runs {net._dtype} on {net.device}, the first "
                f"member {first_net._dtype} on {first_net.device}")
    shared_input = first.network_inputs[0]
    nodes: Dict[str, GraphNode] = {}
    heads: List[str] = []
    col_slices: Dict[str, Tuple[int, int]] = {}
    off = 0
    for nm, net in named_members:
        conf = net.conf
        own_input = conf.network_inputs[0]

        def remap(inp, _nm=nm, _own=own_input):
            return shared_input if inp == _own else f"{_nm}/{inp}"

        for node_name, node in conf.nodes.items():
            nodes[f"{nm}/{node_name}"] = GraphNode(
                inputs=[remap(i) for i in node.inputs],
                layer=copy.deepcopy(node.layer),
                vertex=copy.deepcopy(node.vertex),
                preprocessor=copy.deepcopy(node.preprocessor))
        head = conf.network_outputs[0]
        heads.append(f"{nm}/{head}")
        width = conf.nodes[head].layer.n_out
        col_slices[nm] = (off, width)
        off += width
    nodes[SERVING_CONCAT] = GraphNode(inputs=heads, vertex=MergeVertex())
    merged = ComputationGraphConfiguration(
        network_inputs=[shared_input],
        network_outputs=[SERVING_CONCAT],
        nodes=nodes,
        topo_order=_toposort(nodes, [shared_input]),
        input_types=copy.deepcopy(first.input_types),
        seed=first.seed)
    return merged, col_slices


def fused_trees_from_members(groups: Sequence[FusionGroup],
                             named_members: Sequence[Tuple[str, object]],
                             order: Optional[Sequence[str]] = None
                             ) -> Tuple[Dict[str, dict], Dict[str, dict]]:
    """(params_tree, state_tree) for the fused serving graph, built from the
    members' CURRENT trees (namespace-prefix then fuse_params), in `order`
    (the fused graph's layer nodes) when given. Leaves are copies, never
    aliases: the solo members stay the source of truth and change
    independently (a hot swap rebuilds through here)."""
    merged_p: Dict[str, dict] = {}
    merged_s: Dict[str, dict] = {}
    for nm, net in named_members:
        for node, sub in net.params_tree.items():
            merged_p[f"{nm}/{node}"] = sub
        for node, sub in net.state_tree.items():
            merged_s[f"{nm}/{node}"] = sub

    def own(tree):
        fused = fuse_params(groups, tree)
        keys = list(order) if order is not None else list(fused)
        return {n: param_utils.tree_map(torch.clone, fused[n]) for n in keys}

    return own(merged_p), own(merged_s)


def build_fused_serving_net(named_members: Sequence[Tuple[str, object]]):
    """Members -> ONE inference-only ComputationGraph serving all of them,
    on the members' device and in their type: merge under name prefixes,
    run the sibling-fusion pass over the merged config (same-geometry first
    layers collapse into one concatenated conv or product), and carry the
    members' live parameters and layer state (nothing is drawn; the fused
    net holds no optimizer state).

    Returns (fused_net, groups, col_slices): run ``fused_net.output(x)``
    once, slice ``[:, off:off+width]`` per member. Raises
    :class:`FusionIneligibleError` when the member set cannot merge."""
    from .graph import ComputationGraph
    merged, col_slices = merge_serving_conf(named_members)
    fused_conf, groups = fuse_sibling_convs(merged)
    net = ComputationGraph(fused_conf)
    first = named_members[0][1]
    params, state = fused_trees_from_members(groups, named_members,
                                             order=net._layer_nodes)
    net._adopt(params, first._dtype, first.device, opt_state={},
               state_tree=state)
    return net, groups, col_slices
