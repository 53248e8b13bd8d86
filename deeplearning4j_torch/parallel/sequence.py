"""SequenceParallelWrapper: training attention networks with the time axis
cut over a mesh's "seq" axis, optionally with data parallelism over "data"
and tensor parallelism over "model" (the 3-D DP x TP x SP mode).

Port of `deeplearning4j_tpu/parallel/sequence.py`. Every shard (d, m, s) of
the mesh holds rows block d and time block s of the batch and runs the
network's own forward on them, on its device, on a thread of its own
(nn/shards.py, under a `Grid`). Everything but attention is time-local;
attention runs the ring (`ops/attention.py:ring_attention_shard`), its
key/value blocks travelling shard to shard (`shards.ring_hop`), and a
recurrent layer runs on its row block's gathered sequence
(`shards.forward_layer`). Dropout draws the global batch's mask and each
shard keeps its block; the output layer scores the blocks concatenated
back along time and rows, once. One backward from that score runs the
whole graph, the reverse ring included, and the network's own update takes
the gradients. So a step is the single-device step on the global batch, up
to float32 reassociation in the ring's online softmax.

With a "model" axis the parameters and updater state shard over it
(`tensor.place_model_tp`, the TensorParallelWrapper rule) and attention
heads split over it where they divide it (a warning and whole heads where
they do not): model shard m runs the ring for its heads and the shards of
a block meet to gather every head's output.

Across processes (one seq ring spanning the ranks of a process group)
every process feeds the identical global batch and runs its own shards;
the ring's hops cross the processes over the group, host-staged
(gloo carries no CUDA point-to-point; NCCL where each rank has its own
GPU), the score all-gathers the outputs' blocks, and the gradients are
summed over the processes. Inference (`output`, `outputs`) runs each
process's shards and all-gathers their output blocks, so every process
returns the whole output. The model axis and the recurrent gather stay
within a process there.

Deliberate differences from the JAX package: BatchNormalization and the
layers that need the whole sequence but are not recurrent (convolutions,
pooling, LRN, the pretrain layers; `LastTimeStepVertex` and the other
non-time-local vertices) are refused under a seq axis rather than run on a
time block; inference (`output`, `outputs`) runs through the same shards.
"""
from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from ..data.padding import pad_lmask_zero_weight, repeat_tail_rows
from ..nn import shards
from ..nn.layers.recurrent import RECURRENT_CARRY_KEYS
from ..nn.multilayer import _regularization_score
from ..ops.attention import sequence_parallel
from ..optimize import metrics as metrics_mod
from . import mesh as mesh_lib
from .tensor import (_devices_arg, _rank_of, flat_leaves,
                     grads_like, layer_items, place_model_tp, step_leaves,
                     tree_view)
from .wrapper import _cut_state, _rebuild, _state_items

log = logging.getLogger(__name__)

Tensor = torch.Tensor


def seq_parallel_mesh(seq_devices: Optional[int] = None,
                      data_devices: int = 1, model_devices: int = 1,
                      devices=None) -> mesh_lib.Mesh:
    """A ("data", "seq") mesh, or ("data", "model", "seq") when
    model_devices > 1 (the 3-D DP x TP x SP grid). Default: every device on
    the seq axis."""
    devices, procs = _devices_arg(devices)
    if seq_devices is None:
        seq_devices = len(devices) // (data_devices * model_devices)
    if model_devices > 1:
        return mesh_lib.create_mesh(
            [data_devices, model_devices, seq_devices],
            (mesh_lib.DATA_AXIS, mesh_lib.MODEL_AXIS, mesh_lib.SEQ_AXIS),
            devices, procs)
    return mesh_lib.create_mesh([data_devices, seq_devices],
                                (mesh_lib.DATA_AXIS, mesh_lib.SEQ_AXIS),
                                devices, procs)


def _refused_under_seq(obj) -> Optional[str]:
    """Why a layer or vertex cannot run on a time block, or None."""
    from ..nn.graph import vertices as V
    from ..nn.layers import convolution as C
    from ..nn.layers import pretrain as PT
    if isinstance(obj, C.BatchNormalization):
        return ("BatchNormalization is not supported under a seq axis (its "
                "moments would be a time block's)")
    if isinstance(obj, (C.ConvolutionLayer, C.SubsamplingLayer,
                        C.GlobalPoolingLayer, C.LocalResponseNormalization,
                        C.ZeroPaddingLayer, PT.AutoEncoder,
                        PT.VariationalAutoencoder, PT.RBM)):
        return (f"{type(obj).__name__} needs the whole sequence; it is not "
                "supported under a seq axis")
    if isinstance(obj, V.GraphVertex) and not isinstance(
            obj, (V.MergeVertex, V.ElementWiseVertex, V.SubsetVertex,
                  V.ScaleVertex, V.ShiftVertex)):
        return (f"{type(obj).__name__} is not time-local; it is not "
                "supported under a seq axis")
    return None


class SequenceParallelWrapper:
    """Train a MultiLayerNetwork or ComputationGraph holding
    SelfAttentionLayer(s) with [batch, time] cut over a ("data", "seq")
    mesh; with a "model" axis of more than one shard, parameters shard over
    it too and the ring splits attention heads over it (3-D)."""

    def __init__(self, model, mesh: Optional[mesh_lib.Mesh] = None,
                 process_group=None):
        self.model = model
        self.mesh = mesh if mesh is not None else seq_parallel_mesh()
        if mesh_lib.SEQ_AXIS not in self.mesh.axis_names:
            raise ValueError(
                f"SequenceParallelWrapper needs a mesh with a "
                f"'{mesh_lib.SEQ_AXIS}' axis; got {self.mesh.axis_names}")
        self.seq_shards = self.mesh.axis_size(mesh_lib.SEQ_AXIS)
        self.data_shards = self.mesh.axis_size(mesh_lib.DATA_AXIS)
        self.model_shards = self.mesh.axis_size(mesh_lib.MODEL_AXIS)
        self._batch_axis = mesh_lib.DATA_AXIS if self.data_shards > 1 else None
        self._head_axis = mesh_lib.MODEL_AXIS if self.model_shards > 1 else None
        self._pg = process_group if process_group is not None else (
            torch.distributed.group.WORLD if mesh_lib.is_multiprocess(self.mesh)
            else None)
        self._rank = _rank_of(self._pg)
        if self._pg is not None and self.model_shards > 1:
            raise NotImplementedError(
                "the 3-D (data x model x seq) mode runs in one process; across "
                "processes use a data x seq mesh")
        self._check_layers()
        dims = (self.data_shards, self.model_shards, self.seq_shards)
        coord = lambda i: tuple(self.mesh.coords(i).get(a, 0) for a in (
            mesh_lib.DATA_AXIS, mesh_lib.MODEL_AXIS, mesh_lib.SEQ_AXIS))
        self._all = [(p, coord(i)) for i, p in enumerate(self.mesh.processes)]
        self._local = [i for i, p in enumerate(self.mesh.processes)
                       if p == self._rank]
        self._dims = dims
        self._coords = [coord(i) for i in self._local]
        self._devices = [self.mesh.devices[i] for i in self._local]
        self._placed = False
        self._warned_pad = False
        self._warned_window = False

    def _check_layers(self):
        net = self.model
        if hasattr(net, "_pack"):
            objs = [n.layer if n.is_layer() else n.vertex
                    for n in net.conf.nodes.values()]
        else:
            objs = list(net.layers)
        for obj in objs:
            why = _refused_under_seq(obj)
            if why is not None:
                raise ValueError(why)

    def _ctx(self):
        return sequence_parallel(self.mesh, mesh_lib.SEQ_AXIS, self._batch_axis,
                                 self._head_axis)

    def _place_model(self):
        if self._head_axis is not None:
            place_model_tp(self.model, self.mesh, self.model_shards)
        self._placed = True

    # ------------------------------------------------------------------- fit
    def fit(self, data, labels=None, *, epochs: int = 1,
            batch_size: int = 128) -> "SequenceParallelWrapper":
        """The network's own epoch loop with the sequence-parallel step; the
        wrapper pads its own tail batches (to the data axis, zero-weight)
        and cuts batches itself, so bucket padding and device prefetch are
        off."""
        self.model._check_init()
        self.model.fit(data, labels, epochs=epochs, batch_size=batch_size,
                       step_fn=self.fit_batch, pad_to_bucket=False,
                       prefetch_to_device=False)
        return self

    def fit_batch(self, ds) -> None:
        """One synchronous step with batch x time cut over the mesh, through
        the network's own batch dispatch (so truncated-BPTT windows and the
        carry's reset are the single-device path's). A DataSet for
        MultiLayerNetwork, a (Multi)DataSet for ComputationGraph."""
        net = self.model
        net._check_init()
        if not self._placed:
            self._place_model()
        if hasattr(net, "_pack"):  # ComputationGraph
            mds = net._coerce(ds)
            self._check_tbptt_windows(
                max((np.shape(f)[1] for f in mds.features if np.ndim(f) == 3),
                    default=0),
                windowing=all(np.ndim(l) == 3 for l in mds.labels))
            net.fit_batch(mds, do_step=self._sp_graph_step)
            return
        self._check_tbptt_windows(
            np.shape(ds.features)[1] if np.ndim(ds.features) == 3 else 0,
            windowing=np.ndim(ds.labels) == 3)
        net._fit_batch(ds, do_step=self._sp_step)

    def _check_tbptt_windows(self, T: int, windowing: bool) -> None:
        """A tBPTT window length that does not divide the seq axis would run
        every window dense: refused before any step. (A short final window
        alone falls back, warned once.)"""
        from ..nn.conf.builders import BackpropType
        if self.model.conf.backprop_type != BackpropType.TRUNCATED_BPTT \
                or not windowing or not T:
            return
        L = self.model.conf.tbptt_fwd_length
        if min(L, T) % self.seq_shards:
            raise ValueError(
                f"tBPTT window length {min(L, T)} "
                f"(min(tbptt_fwd_length={L}, T={T})) does not divide the "
                f"{self.seq_shards}-way seq axis: every tBPTT window "
                f"would fall back to dense attention; choose a window "
                f"length divisible by the seq axis")

    def _time_sharded_ok(self, t: int, windowed: bool) -> bool:
        """Whether a [., t, ...] batch can ride the ring: a short final
        tBPTT window that does not divide the seq axis runs dense (warned
        once); a whole sequence that does not divide raises."""
        if t % self.seq_shards == 0:
            return True
        if not windowed:
            raise ValueError(f"time axis {t} must divide the {self.seq_shards}"
                             f"-way seq axis")
        if not self._warned_window:
            log.warning(
                "tBPTT window of %d steps does not divide the %d-way seq "
                "axis; this window runs dense (sequence parallelism "
                "inactive for it)", t, self.seq_shards)
            self._warned_window = True
        return False

    def _pad_batch(self, n: int, rows, lmasks):
        """(pad, padded row tensors, padded labels masks): a batch the data
        axis does not divide gains zero-weight copies of its last row (the
        ParallelWrapper contract), and a running carry gains them too."""
        net = self.model
        pad = (-n) % self.data_shards
        if not pad:
            return 0, rows, lmasks
        if not self._warned_pad:
            log.warning("Batch size %d not divisible by %d data shards; padding "
                        "with zero-loss-weight copies of the tail example", n,
                        self.data_shards)
            self._warned_pad = True
        rows = [None if r is None else
                {k: repeat_tail_rows(v, pad) for k, v in r.items()}
                if isinstance(r, dict) else repeat_tail_rows(r, pad) for r in rows]
        lmasks = [net._as_mask(pad_lmask_zero_weight(
            None if m is None else m.cpu().numpy(), n, pad)) for m in lmasks]
        if net._rnn_carry is not None:
            padc = lambda v: repeat_tail_rows(v, pad) \
                if v.ndim and v.shape[0] == n else v
            net._rnn_carry = _rebuild(net._rnn_carry, [
                (k, {n_: padc(v) for n_, v in c.items()})
                for k, c in _state_items(net._rnn_carry)])
        return pad, rows, lmasks

    def _sp_step(self, x, y, fmask, lmask) -> None:
        net = self.model
        x, y = net._as_input(x), net._as_labels(y)
        fmask, lmask = net._as_mask(fmask), net._as_mask(lmask)
        t = x.shape[1]
        time_ok = self._time_sharded_ok(t, net._rnn_carry is not None)
        _, (x, y, fmask), (lmask,) = self._pad_batch(x.shape[0], [x, y, fmask],
                                                     [lmask])
        self._run(x.shape[0], t if time_ok else 0,
                  lambda params, state, cut, gen: net._loss(
                      params, state, cut(x), cut(y), cut(fmask, True),
                      cut(lmask, True), True, gen))

    def _sp_graph_step(self, inputs, labels, fm, lm) -> None:
        net = self.model
        n = next(iter(inputs.values())).shape[0]
        times = {a.shape[1] for a in inputs.values() if a.ndim == 3}
        if len(times) > 1:
            raise ValueError(f"inputs of several sequence lengths {sorted(times)} "
                             "cannot share one seq axis")
        t = times.pop() if times else 0
        time_ok = bool(t) and self._time_sharded_ok(t, net._rnn_carry is not None)
        pad, (inputs, labels, fm), _ = self._pad_batch(n, [inputs, labels, fm], [])
        if pad:
            lm = {name: net._as_mask(pad_lmask_zero_weight(
                None if lm.get(name) is None else lm[name].cpu().numpy(), n, pad))
                for name in labels}
        self._run(n + pad, t if time_ok else 0,
                  lambda params, state, cut, gen: net._loss(
                      params, state, cut(inputs), cut(labels), cut(fm, True),
                      cut(lm, True), True, gen))

    # ------------------------------------------------------------ the shards
    def _contexts(self, rows: int, T: int):
        """(grid, contexts, cut makers) of the local shards for a batch of
        `rows` rows and `T` steps (T 0: time not cut)."""
        D, _, S = self._dims
        c, tc = rows // D, (T // S if T else 0)
        grid = shards.Grid(self._dims, list(self._coords), list(self._devices),
                           heads=self._head_axis is not None,
                           positions=self._all if self._pg is not None else None,
                           rank=self._rank)
        L = len(self._coords)
        group = shards.ShardGroup(L) if L > 1 else None
        ctxs = [shards.ShardContext(i, L, d * c, c, rows, group, self._pg, grid,
                                    s * tc, tc, T)
                for i, (d, _, s) in enumerate(self._coords)]

        def cutter(i):
            d, _, s = self._coords[i]
            dev = self._devices[i]

            def cut(a, mask=False):
                if a is None:
                    return None
                if isinstance(a, dict):
                    return {k: cut(v, mask) for k, v in a.items()}
                a = a[d * c:(d + 1) * c]
                if tc and (a.ndim == 3 or (mask and a.ndim == 2)) \
                        and a.shape[1] == T:
                    a = a[:, s * tc:(s + 1) * tc]
                return a.to(dev)
            return cut
        return grid, ctxs, cutter

    def _run(self, rows: int, T: int, loss_fn) -> None:
        """One step: every local shard's `loss_fn(its parameter view, its
        state, cut, its generator)` on its thread, one backward from shard
        0's score, the gradients summed over the processes, the update."""
        net = self.model
        if rows % self.data_shards:
            raise ValueError(f"batch {rows} must divide the "
                             f"{self.data_shards}-way data axis")
        c = rows // self.data_shards
        grid, ctxs, cutter = self._contexts(rows, T)
        home = step_leaves(net.params_tree)
        state = net._merged_state()
        gen_state = net._dropout_gen.get_state()
        gens = []
        for _ in ctxs:
            g = torch.Generator(device=net._dropout_gen.device)
            g.set_state(gen_state)
            gens.append(g)

        def body(i):
            d = self._coords[i][0]
            dev = self._devices[i]
            return loss_fn(tree_view(home, dev),
                           _cut_state(state, d * c, (d + 1) * c, dev),
                           cutter(i), gens[i])

        with self._ctx():
            outs = shards.run(len(ctxs), body, ctxs)
        loss = outs[0][0]
        reported = loss.detach()
        if self._pg is not None:
            # each process's shard 0 holds 1/P of the score; its
            # regularization is scaled alike, so the sums are the batch's
            reg = self._regularization(home, net.device)
            P = self._pg.size()
            loss = loss - (1.0 - 1.0 / P) * reg
            reported = grid.last_score.to(net.device) + \
                (reg.detach() if isinstance(reg, Tensor) else reg)
        flat = flat_leaves(home)
        grads = list(torch.autograd.grad(loss, flat, allow_unused=True)) \
            if flat else []
        if self._pg is not None:
            grads = self._allreduce_sum(grads, flat)
        grad_tree = grads_like(home, grads)
        new_state = self._merge_states([o[1] for o in outs], net.device)
        net._dropout_gen.set_state(gens[0].get_state())
        net._apply_step(reported, grad_tree, new_state)
        metrics_mod.registry().counter(
            "sequence_parallel_steps_total",
            "SequenceParallelWrapper optimizer steps (shard-labeled)"
            ).labels(seq=str(self.seq_shards), data=str(self.data_shards),
                     model=str(self.model_shards)).inc()
        metrics_mod.record_train_step(1)
        for lst in net.listeners:
            lst.iteration_done(net, net.iteration)

    def _regularization(self, home, device):
        layers = layer_items(self.model)
        reg = _regularization_score([l for _, l in layers],
                                    [home[k] for k, _ in layers])
        return reg.to(device) if isinstance(reg, Tensor) else reg

    def _allreduce_sum(self, grads, flat):
        """The gradients summed over the process group, host-staged."""
        grads = [torch.zeros_like(t) if g is None else g
                 for g, t in zip(grads, flat)]
        if not grads:
            return grads
        dev = "cpu" if shards._host_staged(self._pg) else grads[0].device
        buf = torch.cat([g.detach().reshape(-1).to(dev, torch.float32)
                         for g in grads])
        self._pg.allreduce([buf]).wait()
        out, off = [], 0
        for g in grads:
            out.append(buf[off:off + g.numel()].view_as(g).to(g.device, g.dtype))
            off += g.numel()
        return out

    def _merge_states(self, states, dev):
        """The shards' new layer states as one: each recurrent carry from
        the (d, 0, 0) shards, concatenated by rows; the rest from shard 0."""
        first = states[0]
        items = []
        for k, st in _state_items(first):
            merged = {}
            for n, v in st.items():
                if n in RECURRENT_CARRY_KEYS:
                    parts = [states[self._coords.index((d, 0, 0))][k][n].to(dev)
                             for d in range(self._dims[0])]
                    merged[n] = torch.cat(parts, 0)
                else:
                    merged[n] = v.to(dev)
            items.append((k, merged))
        return _rebuild(first, items)

    # ------------------------------------------------------------- inference
    def _infer(self, rows: int, T: int, forward):
        """Every local shard's `forward(its view, its state, cut)` without
        gradients: {output key: whole output} assembled from the (d, 0, s)
        shards' blocks (cut in time where they hold a time block). Across
        processes the blocks are all-gathered over the group first, so
        every process returns the whole output."""
        net = self.model
        if rows % self.data_shards:
            raise ValueError(f"batch {rows} must divide the "
                             f"{self.data_shards}-way data axis")
        c = rows // self.data_shards
        _, ctxs, cutter = self._contexts(rows, T)
        tc = T // self.seq_shards if T else 0

        def body(i):
            d = self._coords[i][0]
            dev = self._devices[i]
            with torch.no_grad():
                return forward(tree_view(net.params_tree, dev),
                               _cut_state(net.state_tree, d * c, (d + 1) * c, dev),
                               cutter(i))

        with self._ctx():
            outs = shards.run(len(ctxs), body, ctxs)
        blocks = {key: dict(zip(self._coords, (o[key] for o in outs)))
                  for key in outs[0]}
        if self._pg is not None:
            owners = [p for p, _ in self._all]
            for key in blocks:
                got = shards.gather_positions([o[key] for o in outs], self._pg,
                                              owners, net.device)
                blocks[key] = {coord: g for (_, coord), g in zip(self._all, got)}
        result = {}
        for key, by_coord in blocks.items():
            rows_out = []
            for d in range(self._dims[0]):
                row = [by_coord[(d, 0, s)] for s in range(self._dims[2])]
                timed = tc and row[0].ndim == 3 and row[0].shape[1] == tc \
                    and tc < T
                rows_out.append(torch.cat([b.to(net.device) for b in row], 1)
                                if timed else row[0].to(net.device))
            result[key] = torch.cat(rows_out, 0)
        return result

    def outputs(self, *features, features_masks=None):
        """Sequence-parallel ComputationGraph inference over every network
        input and output (rank-3 inputs cut in time, rank-2 by rows only):
        the outputs in conf.network_outputs order, as numpy."""
        net = self.model
        if not hasattr(net, "_pack"):
            raise TypeError("outputs() is the ComputationGraph surface; "
                            "use output() for MultiLayerNetwork")
        net._check_init()
        if not self._placed:
            self._place_model()
        if len(features) == 1 and isinstance(features[0], (list, tuple)):
            features = tuple(features[0])
        if len(features) != len(net.conf.network_inputs):
            raise ValueError(f"Graph has {len(net.conf.network_inputs)} inputs, "
                             f"got {len(features)}")
        inputs, fms = net._pack_inputs(features, features_masks)
        times = {a.shape[1] for a in inputs.values() if a.ndim == 3}
        for t in times:
            self._time_sharded_ok(t, windowed=False)  # raises if bad
        T = max(times) if times else 0
        n = next(iter(inputs.values())).shape[0]
        out = self._infer(n, T, lambda params, state, cut: {
            k: v for k, v in net._walk(params, state, cut(inputs),
                                       fmasks=cut(fms, True))[0].items()
            if k in net.conf.network_outputs})
        from ..nn.multilayer import _to_numpy
        return [_to_numpy(out[k]) for k in net.conf.network_outputs]

    def output(self, x, features_mask=None):
        """Sequence-parallel inference through the same shards. For a
        ComputationGraph: one input or a list of inputs, the first output."""
        net = self.model
        net._check_init()
        if not self._placed:
            self._place_model()
        if hasattr(net, "_pack"):
            feats = list(x) if isinstance(x, (list, tuple)) else [x]
            masks = None if features_mask is None else (
                list(features_mask) if isinstance(features_mask, (list, tuple))
                else [features_mask])
            return self.outputs(*feats, features_masks=masks)[0]
        xs, fm = net._as_input(x), net._as_mask(features_mask)
        T = xs.shape[1]
        self._time_sharded_ok(T, windowed=False)
        out = self._infer(xs.shape[0], T, lambda params, state, cut: {
            "out": net._forward(params, state, cut(xs), fmask=cut(fm, True))[0]})
        return out["out"].cpu().numpy()
