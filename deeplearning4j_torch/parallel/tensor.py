"""TensorParallelWrapper: training with parameters sharded over the mesh's
"model" axis (tensor parallelism), optionally with data parallelism.

Port of `deeplearning4j_tpu/parallel/tensor.py`. The sharding rule is the
JAX package's (`model_param_spec`): every floating leaf of the parameters
and of the updater state is cut along its last dimension that the model
axis divides (features out for dense, attention and embedding weights, out
channels for conv kernels, the packed 4H gate axis for an LSTM); scalars
and leaves no dimension of which divides replicate, and so does the layer
state. Block j lives on the device of model shard j (`ShardedLeaf`), and
between steps that block, with its updater state's, is all that device
holds of the leaf.

Where the JAX package lets XLA partition every product, a step here runs
the plain layer math on whole leaves: a leaf is gathered where a layer
reads it (`_LeafView`, a `torch.cat` of the blocks on the reading shard's
device), and autograd hands each block its slice of the gradient. That is
right for every layer type, whatever it does with the leaf. The updaters
are element-wise, so each block is updated where it lives, with its own
updater state; a layer's gradient normalization takes its norms over all
blocks. A data axis cuts the batch into row blocks run as ParallelWrapper
runs them (nn/shards.py: dropout, BatchNormalization and the score meet
over the whole batch), each on the device of its data index's first model
shard.

Across processes every process feeds the identical global batch (the JAX
package's `place_global` contract) and runs every row block; the blocks of
a leaf are all-gathered over the process group, host-staged, once a step,
and each process keeps its own blocks' gradient (every process computes
the same gradient, so no reduction follows). A placed network checkpoints
with its leaves gathered (`utils/model_serializer.py`);
`materialize_local` gathers them back for plain use.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import List, Optional

import numpy as np
import torch

from ..nn import shards
from ..optimize import metrics as metrics_mod
from ..utils import params as param_utils
from . import mesh as mesh_lib
from .mesh import ShardedLeaf
from .wrapper import _cut, _cut_state, _merge_states, _rebuild, _state_items

Tensor = torch.Tensor


def _devices_arg(devices):
    """(devices, processes) for a mesh over `devices` (default: every
    process's devices, rank by rank)."""
    if devices is None:
        default = mesh_lib.create_mesh()
        return default.devices, default.processes
    return list(devices), None


def tensor_parallel_mesh(model_devices: Optional[int] = None,
                         data_devices: int = 1, devices=None) -> mesh_lib.Mesh:
    """A ("data", "model") mesh. Default: every device on the model axis
    (pure tensor parallelism); data_devices > 1 gives DP x TP."""
    devices, procs = _devices_arg(devices)
    if model_devices is None:
        model_devices = len(devices) // data_devices
    return mesh_lib.create_mesh([data_devices, model_devices],
                                (mesh_lib.DATA_AXIS, mesh_lib.MODEL_AXIS),
                                devices, procs)


#: A 4-D leaf is a conv kernel, [out, in, h, w] here and [h, w, in, out]
#: in the JAX package: the port's dims in the JAX layout's order.
_CONV_TO_REFERENCE = (2, 3, 1, 0)


def model_param_spec(arr, model_shards: int) -> tuple:
    """The tensor-parallel sharding rule: the spec ("model" at the last
    dimension the model axis divides, None elsewhere) of a floating leaf,
    () (replicated) for a scalar, a non-floating leaf or a leaf no
    dimension of which divides. "Last" is in the JAX package's layout, so a
    conv kernel shards its out channels first, as there; the spec is in the
    leaf's own layout (`reference_spec` turns it)."""
    t = arr if isinstance(arr, Tensor) else torch.as_tensor(np.asarray(arr))
    if t.ndim == 0 or not t.is_floating_point():
        return ()
    order = reversed(_CONV_TO_REFERENCE) if t.ndim == 4 else \
        range(t.ndim - 1, -1, -1)
    for dim in order:
        if t.shape[dim] >= model_shards and t.shape[dim] % model_shards == 0:
            spec = [None] * t.ndim
            spec[dim] = mesh_lib.MODEL_AXIS
            return tuple(spec)
    return ()


def reference_spec(spec) -> tuple:
    """A spec in the JAX package's layout (a conv kernel's dims turned)."""
    spec = tuple(spec)
    return tuple(spec[i] for i in _CONV_TO_REFERENCE) if len(spec) == 4 else spec


def _rank_of(process_group) -> int:
    return process_group.rank() if process_group is not None else \
        mesh_lib.process_index()


def shard_params_over_model(tree, mesh: mesh_lib.Mesh, model_shards: int,
                            process_group=None):
    """The tree with every leaf that `model_param_spec` shards cut into a
    `ShardedLeaf`: block j on the device of position (model j, first index
    on every other axis), None where another process owns that position.
    Every process holds the same whole tree (same-seed init or a restore)
    and keeps its own blocks."""
    rank = _rank_of(process_group)

    def place(t):
        if not isinstance(t, Tensor):
            return t
        spec = model_param_spec(t, model_shards)
        if mesh_lib.MODEL_AXIS not in spec:
            return t
        dim = spec.index(mesh_lib.MODEL_AXIS)
        blocks, ranks = [], []
        for j in range(model_shards):
            pos = mesh.position(**{mesh_lib.MODEL_AXIS: j})
            ranks.append(mesh.processes[pos])
            blocks.append(None if ranks[-1] != rank else mesh_lib.shard_slice(
                t.detach(), dim, j, model_shards).to(mesh.devices[pos], copy=True))
        group = process_group if any(b is None for b in blocks) else None
        return ShardedLeaf(blocks, dim, t.shape, ranks, group)
    return param_utils.tree_map(place, tree)


def place_model_tp(net, mesh: mesh_lib.Mesh, model_shards: int,
                   process_group=None) -> None:
    """Tensor-parallel placement: parameters and updater state sharded over
    "model", the layer state left whole on the network's device (shared by
    TensorParallelWrapper and SequenceParallelWrapper's 3-D mode)."""
    net.params_tree = shard_params_over_model(net.params_tree, mesh,
                                              model_shards, process_group)
    net.opt_state = shard_params_over_model(net.opt_state, mesh, model_shards,
                                            process_group)


# ---------------------------------------------------------------------------
# A step's leaves: the autograd leaves at home, gathered views per shard
# ---------------------------------------------------------------------------

def _gather(leaf, device):
    """`leaf` on `device`: a plain tensor moved, a sharded one gathered from
    its blocks (differentiably)."""
    if isinstance(leaf, ShardedLeaf):
        return torch.cat([s.to(device) for s in leaf.slices], leaf.dim)
    return leaf.to(device) if isinstance(leaf, Tensor) else leaf


class _LeafView(Mapping):
    """One layer's parameters as a shard's forward reads them: each on the
    shard's device, a sharded one gathered where a layer first reads it."""

    def __init__(self, leaves: dict, device: torch.device):
        self._leaves, self._device, self._cache = leaves, device, {}

    def __getitem__(self, name):
        if name not in self._cache:
            self._cache[name] = _gather(self._leaves[name], self._device)
        return self._cache[name]

    def __iter__(self):
        return iter(self._leaves)

    def __len__(self):
        return len(self._leaves)


def step_leaves(tree):
    """The autograd leaves of one step: every floating tensor (and every
    block this process holds of a sharded leaf) detached with
    requires_grad, where it lives."""
    def leaf(t):
        if isinstance(t, ShardedLeaf):
            return t.like([None if s is None else s.detach().requires_grad_()
                           for s in t.slices])
        if isinstance(t, Tensor) and t.is_floating_point():
            return t.detach().requires_grad_()
        return t
    return param_utils.tree_map(leaf, tree)


def flat_leaves(tree) -> List[Tensor]:
    """Every autograd leaf of `step_leaves(tree)`, in tree order."""
    out = []
    for t in param_utils.tree_leaves(tree):
        if isinstance(t, ShardedLeaf):
            out.extend(s for s in t.slices if s is not None)
        elif isinstance(t, Tensor) and t.requires_grad:
            out.append(t)
    return out


def grads_like(tree, grads: List[Optional[Tensor]]):
    """`tree` with each autograd leaf replaced by its gradient (zeros where
    the score did not reach it); `grads` in `flat_leaves` order."""
    by_leaf = {id(t): g for t, g in zip(flat_leaves(tree), grads)}

    def take(t):
        g = by_leaf[id(t)]
        return torch.zeros_like(t) if g is None else g

    def leaf(t):
        if isinstance(t, ShardedLeaf):
            return t.like([None if s is None else take(s) for s in t.slices])
        if isinstance(t, Tensor) and t.requires_grad:
            return take(t)
        return t
    return param_utils.tree_map(leaf, tree)


def gathered_across(tree, pg, device):
    """`tree` with every sharded leaf all-gathered whole on `device` over
    `pg` (differentiably; `_AllGatherBlocks`), the plain leaves as they
    are."""
    return param_utils.tree_map(
        lambda t: _AllGatherBlocks.apply(pg, t, device, *[s for _, s in t.local()])
        if isinstance(t, ShardedLeaf) else t, tree)


class _AllGatherBlocks(torch.autograd.Function):
    """A sharded leaf whole on `device` from every process's blocks: each
    process's blocks (in model order) all-gathered over the process group,
    host-staged; the backward keeps this process's blocks of the gradient,
    which every process computed whole, so none is summed."""

    @staticmethod
    def forward(ctx, pg, leaf, device, *local):
        ctx.local = [j for j, s in enumerate(leaf.slices) if s is not None]
        ctx.dim = leaf.dim
        ctx.devices = [b.device for b in local]
        ctx.n = len(leaf.slices)
        with shards.timed_transport("param_gather"):
            stacked = shards._wire(torch.stack([b.detach() for b in local]),
                                   shards._host_staged(pg))
            outs = [torch.empty_like(stacked) for _ in range(pg.size())]
            pg.allgather([outs], [stacked]).wait()
            per_rank = [list(shards._unwire(o, local[0].dtype, device))
                        for o in outs]
        blocks = [per_rank[r].pop(0) for r in leaf.ranks]
        return torch.cat(blocks, leaf.dim)

    @staticmethod
    def backward(ctx, g):
        parts = g.chunk(ctx.n, ctx.dim)
        return (None, None, None) + tuple(
            parts[j].to(dev) for j, dev in zip(ctx.local, ctx.devices))


def tree_view(tree, device: torch.device):
    """A network's tree of `_LeafView`s on `device` (tuple or dict)."""
    return _rebuild(tree, [(k, _LeafView(lp, device))
                           for k, lp in _state_items(tree)])


def layer_items(net):
    """[(tree key, layer)] of a network's parameter tree."""
    if hasattr(net, "_layer_nodes"):
        return [(n, net.conf.nodes[n].layer) for n in net._layer_nodes]
    return list(enumerate(net.layers))


def tree_bytes(tree) -> int:
    """Bytes of a tree's tensors, a sharded leaf counted whole."""
    total = 0
    for t in param_utils.tree_leaves(tree):
        if isinstance(t, ShardedLeaf):
            total += t.shape.numel() * t.dtype.itemsize
        elif isinstance(t, Tensor):
            total += t.numel() * t.element_size()
    return total


class TensorParallelWrapper:
    """Tensor-parallel (and DP x TP) trainer for MultiLayerNetwork and
    ComputationGraph: parameters and updater state sharded over the mesh's
    "model" axis, the batch over its "data" axis."""

    def __init__(self, model, mesh: Optional[mesh_lib.Mesh] = None,
                 process_group=None):
        self.model = model
        self.mesh = mesh if mesh is not None else tensor_parallel_mesh()
        if mesh_lib.MODEL_AXIS not in self.mesh.axis_names:
            raise ValueError(
                f"TensorParallelWrapper needs a mesh with a "
                f"'{mesh_lib.MODEL_AXIS}' axis; got {self.mesh.axis_names}")
        self.model_shards = self.mesh.axis_size(mesh_lib.MODEL_AXIS)
        self.data_shards = self.mesh.axis_size(mesh_lib.DATA_AXIS)
        self._pg = process_group if process_group is not None else (
            torch.distributed.group.WORLD if mesh_lib.is_multiprocess(self.mesh)
            else None)
        self._rank = _rank_of(self._pg)
        self._placed = False

    # -------------------------------------------------------------- sharding
    def _place_model(self):
        place_model_tp(self.model, self.mesh, self.model_shards, self._pg)
        self._placed = True

    def _unit_devices(self) -> List[torch.device]:
        """Where each row block runs: its data index's first model shard, or
        this process's first device where another process owns that."""
        mine = [d for d, p in zip(self.mesh.devices, self.mesh.processes)
                if p == self._rank]
        out = []
        for d in range(self.data_shards):
            pos = self.mesh.position(**{mesh_lib.DATA_AXIS: d})
            out.append(self.mesh.devices[pos]
                       if self.mesh.processes[pos] == self._rank else mine[0])
        return out

    # ------------------------------------------------------------------- fit
    def fit(self, data, labels=None, *, epochs: int = 1,
            batch_size: int = 128) -> "TensorParallelWrapper":
        self.model._check_init()
        if self.data_shards > 1:
            # an indivisible tail batch is refused before any step runs
            try:
                feats = data.features if hasattr(data, "features") else data
                if isinstance(feats, (list, tuple)):  # MultiDataSet
                    feats = feats[0]
                n = np.shape(feats)[0]
            except Exception:
                n = None  # iterator input: checked per batch
            if n is not None:
                tail = n % batch_size
                if tail and tail % self.data_shards:
                    raise ValueError(
                        f"final batch of {tail} examples does not divide "
                        f"the {self.data_shards}-way data axis; choose a "
                        f"batch size so every batch (incl. the tail) is "
                        f"divisible, or repartition")
        self.model.fit(data, labels, epochs=epochs, batch_size=batch_size,
                       step_fn=self.fit_batch)
        return self

    def fit_batch(self, ds) -> None:
        """One synchronous step: batch over "data", parameters over
        "model", through the network's own batch dispatch (so truncated-BPTT
        windows and the carry's reset are the single-device path's)."""
        net = self.model
        net._check_init()
        if not self._placed:
            self._place_model()
        if hasattr(net, "_pack"):  # ComputationGraph
            net.fit_batch(net._coerce(ds), do_step=self._tp_graph_step)
            return
        net._fit_batch(ds, do_step=self._tp_step)

    def _check_rows(self, n: int):
        if n % self.data_shards:
            raise ValueError(f"batch {n} must divide the {self.data_shards}-way "
                             f"data axis")

    def _tp_step(self, x, y, fmask, lmask) -> None:
        net = self.model
        self._check_rows(np.shape(x)[0] if not isinstance(x, Tensor) else x.shape[0])
        x, y = net._as_input(x), net._as_labels(y)
        fmask, lmask = net._as_mask(fmask), net._as_mask(lmask)
        self._step(x.shape[0], lambda params, state, cut, gen: net._loss(
            params, state, cut(x), cut(y), cut(fmask), cut(lmask), True, gen))

    def _tp_graph_step(self, inputs, labels, fm, lm) -> None:
        net = self.model
        n = next(iter(inputs.values())).shape[0]
        self._check_rows(n)
        self._step(n, lambda params, state, cut, gen: net._loss(
            params, state, cut(inputs), cut(labels), cut(fm), cut(lm), True, gen))

    def _step(self, rows: int, loss_fn) -> None:
        """Every row block's `loss_fn(its view of the parameters, its state,
        cut, its generator)` on its thread, one backward from shard 0's
        score into the blocks, then the block-wise update."""
        net = self.model
        D = self.data_shards
        c = rows // D
        dev0 = net.device
        home = step_leaves(net.params_tree)
        src = gathered_across(home, self._pg, dev0) if self._pg is not None \
            else home
        devs = self._unit_devices()
        state = net._merged_state()
        gen_state = net._dropout_gen.get_state()
        gens = []
        for _ in range(D):
            g = torch.Generator(device=net._dropout_gen.device)
            g.set_state(gen_state)
            gens.append(g)
        group = shards.ShardGroup(D) if D > 1 else None
        ctxs = [shards.ShardContext(i, D, i * c, c, rows, group) for i in range(D)]

        def body(i):
            d = devs[i]
            cut = lambda t: _cut(t, i * c, (i + 1) * c, d)
            return loss_fn(tree_view(src, d), _cut_state(state, i * c, (i + 1) * c, d),
                           cut, gens[i])

        outs = shards.run(D, body, ctxs)
        loss = outs[0][0]
        flat = flat_leaves(home)
        grads = torch.autograd.grad(loss, flat, allow_unused=True) if flat else ()
        grad_tree = grads_like(home, list(grads))
        new_state = _merge_states([o[1] for o in outs], dev0)
        net._dropout_gen.set_state(gens[0].get_state())
        net._apply_step(loss.detach(), grad_tree, new_state)
        metrics_mod.registry().counter(
            "tensor_parallel_steps_total",
            "TensorParallelWrapper optimizer steps (shard-labeled)"
            ).labels(model=str(self.model_shards), data=str(D)).inc()
        metrics_mod.record_train_step(1)
        for lst in net.listeners:
            lst.iteration_done(net, net.iteration)

    # ------------------------------------------------------------- evidence
    def materialize_local(self) -> None:
        """The parameters and updater state whole again on the network's
        device (all-gathered over the process group where blocks live in
        other processes: every process must call it in lockstep), so a
        plain `output`, `fit` or a checkpoint works; the next `fit_batch`
        places them again."""
        net = self.model
        for key in ("params_tree", "opt_state"):
            tree = getattr(net, key)
            with torch.no_grad():
                if self._pg is not None:
                    tree = gathered_across(tree, self._pg, net.device)
                setattr(net, key, mesh_lib.gather_replicated(tree, net.device))
        self._placed = False

    def param_shard_report(self) -> dict:
        """{"layer.param": spec} of every sharded parameter (the evidence
        that the run is tensor-parallel)."""
        if not self._placed:
            self._place_model()
        out = {}
        for k, lp in _state_items(self.model.params_tree):
            for name, leaf in lp.items():
                if isinstance(leaf, ShardedLeaf):
                    spec = [None] * len(leaf.shape)
                    spec[leaf.dim] = mesh_lib.MODEL_AXIS
                    out[f"{k}.{name}"] = reference_spec(spec)
        return out

    def shard_bytes(self) -> dict:
        """Bytes of parameters and updater state each model shard's device
        holds between steps (its blocks), those every device holds whole
        (the leaves no dimension of which divides), and the whole trees'."""
        if not self._placed:
            self._place_model()
        trees = (self.model.params_tree, self.model.opt_state)
        leaves = [t for tree in trees for t in param_utils.tree_leaves(tree)]
        return {"per_shard": [sum(t.nbytes(j) for t in leaves
                                  if isinstance(t, ShardedLeaf))
                              for j in range(self.model_shards)],
                "replicated": sum(t.numel() * t.element_size() for t in leaves
                                  if isinstance(t, Tensor)),
                "whole": sum(tree_bytes(t) for t in trees)}
