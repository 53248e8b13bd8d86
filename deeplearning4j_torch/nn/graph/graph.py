"""ComputationGraph: DAG networks with fit/output/score.

Port of `deeplearning4j_tpu/nn/graph/graph.py` (reference
nn/graph/ComputationGraph.java): `init`, the topological walk, the loss
(every output head plus regularization), `output`, `outputs`,
`feed_forward_named`, `predict`, `fit` (arrays, DataSet, MultiDataSet or an
iterator of them), `fit_batch`, `score`, `compute_gradient_and_score`,
`params`, `set_params`, `num_params`, `summary`, and the `warmup` and
`_feature_struct` that ParallelInference calls.

As in the port's MultiLayerNetwork, the walk runs eagerly, the step takes
one autograd backward and then, per layer node in topological order and
under ``torch.no_grad``, normalizes the gradients, runs the updater and sets
``p - u``. Parameters, optimizer state and layer state are dicts keyed by
layer-node name, in topological order, holding the port's layout
(utils/params.py carries them to and from the JAX package's). The layer
state (BatchNormalization's running statistics) is threaded through the
walk as in the JAX package: `fit_batch` commits the new state with the new
parameters, and the inference and scoring calls run on it and leave it as
it is. An output layer's head takes
its input (after its dropout) to `compute_score` and does not run its
forward (graph.py:160-168 of the JAX package); output layers are sinks.
Dropout draws from the network's own ``torch.Generator``.

Recurrent nodes keep their streaming carry outside ``state_tree``, keyed by
node name, as MultiLayerNetwork does (nn/multilayer.py): truncated BPTT
(`_fit_tbptt`, windows over every rank-3 array of a MultiDataSet, rank-2
inputs passed whole into each window) and `rnn_time_step` merge it in and
split it back out, detached, when they commit.

`fit` takes the JAX package's signature and defaults and runs
MultiLayerNetwork's loop (nn/stepping.py): pad to bucket, device prefetch,
`steps_per_dispatch` groups through `fit_batches` (a loop of the same eager
step, bitwise the batches one by one), checkpoints with resume and the
divergence sentinel. As in the JAX package, groups, `fit_batches` and
`fit_batch_repeated` reject truncated BPTT. `evaluate` fills
eval/evaluation.Evaluation for one output.
"""
from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ...data.dataset import DataSet, MultiDataSet, SlicingMultiIterator
from ...optimize import metrics as metrics_mod
from ...optimize import telemetry as telemetry_mod
from ...utils import params as param_utils
from ..conf.builders import BackpropType
from ..conf.graph_conf import ComputationGraphConfiguration
from .. import shards
from ..layers.core import dropout
from ..multilayer import (_DeviceNetwork, _input_shape, _layer_step,
                          _regularization_score, _to_numpy)
from ..stepping import check_fit_args, commit_multi, data_pipeline, run_fit
from .vertices import LastTimeStepVertex

Tensor = torch.Tensor
log = logging.getLogger(__name__)


class ComputationGraph(_DeviceNetwork):
    def __init__(self, conf: ComputationGraphConfiguration):
        self.conf = conf
        self.params_tree: Optional[Dict[str, dict]] = None
        self.opt_state: Optional[Dict[str, Any]] = None
        self.state_tree: Optional[Dict[str, dict]] = None
        self.device: Optional[torch.device] = None
        self.iteration = 0
        self.epoch = 0
        self.listeners: List[Any] = []
        #: loss + regularization of the last training step, a 0-d tensor on
        #: the network's device
        self.score_value: Optional[Tensor] = None
        #: the fit loop's wait for the last batch, host and h2d shares
        self.last_etl_ms = self.last_etl_host_ms = self.last_etl_h2d_ms = 0.0
        self._dtype = torch.float32
        self._dropout_gen: Optional[torch.Generator] = None
        #: {recurrent node: its streaming carry {"h", "c"}}, or None outside
        #: truncated BPTT and rnn_time_step
        self._rnn_carry: Optional[Dict[str, dict]] = None
        self._initialized = False
        #: the shape-churn guard's label suffix (optimize/telemetry.py)
        self._probe_tag = telemetry_mod.probe_tag(self)
        self._layer_nodes = [n for n in conf.topo_order
                             if conf.nodes[n].is_layer()]

    # ------------------------------------------------------------------ init
    def _draw_params(self, gen: torch.Generator, dtype) -> Dict[str, dict]:
        return {name: self.conf.nodes[name].layer.init_params(gen, dtype)
                for name in self._layer_nodes}

    def _opt_init(self, params_tree) -> Dict[str, Any]:
        return {name: self.conf.nodes[name].layer.updater.init(params_tree[name])
                for name in self._layer_nodes}

    def _state_init(self, dtype) -> Dict[str, dict]:
        return {name: self.conf.nodes[name].layer.init_state(dtype)
                for name in self._layer_nodes}

    # --------------------------------------------------------------- forward
    def _walk(self, params, state, inputs: Dict[str, Tensor], *,
              train: bool = False,
              generator: Optional[torch.Generator] = None,
              fmasks: Optional[Dict[str, Tensor]] = None,
              for_score: bool = False):
        """The topological forward. Returns (activations by name, inputs
        included; the output heads' inputs when `for_score`; the new layer
        state by layer node, an output head's passed through)."""
        conf = self.conf
        fmasks = fmasks or {}
        acts: Dict[str, Tensor] = dict(inputs)
        masks: Dict[str, Optional[Tensor]] = {
            name: fmasks.get(name) for name in conf.network_inputs}
        heads: Dict[str, Tensor] = {}
        new_state: Dict[str, dict] = {}
        for name in conf.topo_order:
            node = conf.nodes[name]
            in_acts = [acts[n] for n in node.inputs]
            in_masks = [masks.get(n) for n in node.inputs]
            if node.is_layer():
                a = in_acts[0]
                if node.preprocessor is not None:
                    a = node.preprocessor(a)
                layer = node.layer
                if for_score and layer.is_output_layer():
                    if train and layer.dropout_rate and generator is not None:
                        a = dropout(a, layer.dropout_rate, train, generator)
                    heads[name] = a
                    acts[name] = a  # outputs are sinks: nothing reads it
                    new_state[name] = state[name]
                else:
                    acts[name], new_state[name] = shards.forward_layer(
                        layer, params[name], state[name], a, train=train,
                        generator=generator, mask=in_masks[0])
                masks[name] = in_masks[0]
            else:
                vertex = node.vertex
                if isinstance(vertex, LastTimeStepVertex) and \
                        vertex.mask_input is not None:
                    in_masks = [masks.get(vertex.mask_input)]
                acts[name] = vertex.forward(in_acts, train=train,
                                            generator=generator, masks=in_masks)
                masks[name] = vertex.output_mask(in_masks)
        return acts, heads, new_state

    def _loss(self, params, state, inputs, labels: Dict[str, Tensor], fmasks,
              lmasks, train: bool, generator):
        """(score, new layer state). The score is the sum of the output
        heads' losses plus regularization over the layer nodes in
        topological order (reference computeGradientAndScore sums the
        IOutputLayer scores)."""
        _, heads, new_state = self._walk(params, state, inputs, train=train,
                                         generator=generator, fmasks=fmasks,
                                         for_score=True)
        total = None
        for out_name, y in labels.items():
            layer = self.conf.nodes[out_name].layer
            if layer is None or not layer.is_output_layer():
                raise ValueError(f"Output node {out_name!r} is not an output "
                                 "layer")
            s = shards.score(layer, params[out_name], heads[out_name], y,
                             lmasks.get(out_name))
            total = s if total is None else total + s
        return total + _regularization_score(
            [self.conf.nodes[n].layer for n in self._layer_nodes],
            [params[n] for n in self._layer_nodes]), new_state

    def _value_and_grad(self, inputs, labels, fmasks, lmasks, train, generator,
                        state=None):
        """(score, gradients by node, new layer state) at the current
        parameters and `state` (default: the layer state, without a carry):
        one autograd backward; a parameter the score does not reach gets
        zeros."""
        tree = {n: {k: t.detach().requires_grad_() for k, t in lp.items()}
                for n, lp in self.params_tree.items()}
        flat = [t for lp in tree.values() for t in lp.values()]
        with torch.enable_grad():
            loss, new_state = self._loss(
                tree, self.state_tree if state is None else state, inputs,
                labels, fmasks, lmasks, train, generator)
        grads = torch.autograd.grad(loss, flat, allow_unused=True) if flat else ()
        flat_g = iter([torch.zeros_like(t) if g is None else g
                       for g, t in zip(grads, flat)])
        return loss.detach(), {n: {k: next(flat_g) for k in lp}
                               for n, lp in tree.items()}, new_state

    # ------------------------------------------------------------------ data
    @staticmethod
    def _coerce(data, labels=None) -> MultiDataSet:
        if isinstance(data, MultiDataSet):
            return data
        if isinstance(data, DataSet):
            return MultiDataSet.from_dataset(data)
        if labels is not None:
            as_list = lambda v: [np.asarray(a) for a in
                                 (v if isinstance(v, (list, tuple)) else [v])]
            return MultiDataSet(as_list(data), as_list(labels))
        raise ValueError("Expected MultiDataSet / DataSet / (features, labels)")

    def _pack_inputs(self, features, features_masks=None):
        conf = self.conf
        if len(features) != len(conf.network_inputs):
            raise ValueError(f"Graph has {len(conf.network_inputs)} inputs, "
                             f"got {len(features)}")
        inputs = {name: self._as_input(a)
                  for name, a in zip(conf.network_inputs, features)}
        fmasks = {}
        if features_masks is not None:
            fmasks = {name: self._as_mask(m) for name, m in
                      zip(conf.network_inputs, features_masks) if m is not None}
        return inputs, fmasks

    def _pack(self, mds: MultiDataSet):
        conf = self.conf
        if len(mds.labels) != len(conf.network_outputs):
            raise ValueError(f"Graph has {len(conf.network_outputs)} outputs, "
                             f"got {len(mds.labels)} label arrays")
        inputs, fmasks = self._pack_inputs(mds.features, mds.features_masks)
        labels = {name: self._as_labels(y)
                  for name, y in zip(conf.network_outputs, mds.labels)}
        lmasks = {}
        if mds.labels_masks is not None:
            lmasks = {name: self._as_mask(m) for name, m in
                      zip(conf.network_outputs, mds.labels_masks) if m is not None}
        return inputs, labels, fmasks, lmasks

    def _input_structs(self, batch_size: int,
                       time_steps: Optional[int] = None) -> Dict[str, Tensor]:
        """Meta tensors with the shape and type of each network input's
        batch, from conf.input_types."""
        conf = self.conf
        if not conf.input_types or \
                len(conf.input_types) != len(conf.network_inputs):
            raise ValueError("sizing an input batch needs set_input_types(...) "
                             "on the graph builder (one InputType per input)")
        structs = {}
        for name, it in zip(conf.network_inputs, conf.input_types):
            shape = _input_shape(it, batch_size, time_steps)
            if shape is None:
                raise ValueError(f"cannot size input {name!r} from "
                                 f"{type(it).__name__}")
            structs[name] = torch.empty(shape, dtype=self._dtype, device="meta")
        return structs

    def _feature_struct(self, batch_size: int,
                        time_steps: Optional[int] = None) -> Tensor:
        """The meta feature batch of a single-input graph (ParallelInference's
        call; MultiLayerNetwork has the same)."""
        if len(self.conf.network_inputs) != 1:
            raise ValueError("a feature batch is one array only for a "
                             "single-input graph")
        return next(iter(self._input_structs(batch_size, time_steps).values()))

    def warmup(self, batch_size: int = 1, *,
               time_steps: Optional[int] = None) -> "ComputationGraph":
        """Push one zero batch of `batch_size` through `outputs()` so the
        first real request at that size finds cuDNN's algorithms chosen and
        the kernels built."""
        self._check_init()
        self.outputs(*[torch.zeros(s.shape, dtype=s.dtype, device=self.device)
                       for s in self._input_structs(batch_size, time_steps).values()])
        return self

    # ------------------------------------------------------------- inference
    @staticmethod
    def _features(features):
        if len(features) == 1 and isinstance(features[0], (list, tuple)):
            return tuple(features[0])
        return features

    def outputs(self, *features, features_masks=None) -> List[np.ndarray]:
        """Every network output, in conf.network_outputs order (reference
        ComputationGraph.output(...))."""
        self._check_init()
        with torch.inference_mode():
            inputs, fmasks = self._pack_inputs(self._features(features),
                                               features_masks)
            telemetry_mod.note_step_signature(
                f"graph_output#{self._probe_tag}",
                telemetry_mod.shape_signature(*inputs.values(),
                                              *fmasks.values()))
            acts, _, _ = self._walk(self.params_tree, self.state_tree, inputs,
                                    fmasks=fmasks)
            return [_to_numpy(acts[n]) for n in self.conf.network_outputs]

    def output(self, *features, features_masks=None) -> np.ndarray:
        return self.outputs(*features, features_masks=features_masks)[0]

    def feed_forward_named(self, *features) -> Dict[str, np.ndarray]:
        """{node name: activation} of one inference forward over every
        node, the inputs included (reference feedForward())."""
        self._check_init()
        with torch.inference_mode():
            inputs, _ = self._pack_inputs(self._features(features))
            acts, _, _ = self._walk(self.params_tree, self.state_tree, inputs)
            return {n: _to_numpy(a) for n, a in acts.items()}

    def predict(self, *features) -> np.ndarray:
        return np.argmax(self.output(*features), axis=-1)

    # ------------------------------------------------------------------- fit
    def fit(self, data, labels=None, *, epochs: int = 1,
            batch_size: int = 32, step_fn=None, use_async: bool = True,
            async_queue_size: int = 8, steps_per_dispatch: int = 1,
            pad_to_bucket: bool = True, prefetch_to_device: bool = True,
            prefetch_depth: int = 2, prefetch_sharding=None,
            prefetch_divisor: int = 1,
            checkpoint=None, resume: bool = False, sentinel=None
            ) -> "ComputationGraph":
        """Train (reference fit(MultiDataSetIterator)) on a MultiDataSet, a
        DataSet, (features, labels) arrays (lists of them for several inputs
        or outputs, cut into `batch_size` rows), or an iterable of DataSets
        or MultiDataSets. The options are MultiLayerNetwork.fit's;
        `steps_per_dispatch > 1` raises NotImplementedError under truncated
        BPTT, as in the JAX package."""
        self._check_init()
        epochs, skip = check_fit_args(self, epochs, steps_per_dispatch,
                                      step_fn, checkpoint, resume, sentinel)
        tbptt = self.conf.backprop_type == BackpropType.TRUNCATED_BPTT
        if int(steps_per_dispatch) > 1 and tbptt:
            raise NotImplementedError(
                "steps_per_dispatch > 1 does not support truncated BPTT "
                "iterators; use fit_batch_repeated for resident batches")
        if hasattr(data, "__iter__") and not isinstance(
                data, (DataSet, MultiDataSet, list, tuple, np.ndarray)):
            iterator = data
            if epochs > 1 and not hasattr(iterator, "reset"):
                iterator = list(iterator)  # a generator: keep later epochs
        else:
            iterator = SlicingMultiIterator(self._coerce(data, labels), batch_size)
        wrapped = data_pipeline(
            self, iterator, pad=pad_to_bucket and not tbptt,
            use_async=use_async, queue_size=async_queue_size,
            prefetch_to_device=prefetch_to_device,
            prefetch_depth=prefetch_depth, prefetch_sharding=prefetch_sharding,
            prefetch_divisor=prefetch_divisor, multi=True)
        run_fit(self, wrapped, epochs=epochs, step=step_fn or self.fit_batch,
                spd=int(steps_per_dispatch), checkpoint=checkpoint,
                sentinel=sentinel, skip_batches=skip, coerce=self._coerce)
        return self

    def fit_batch(self, mds, do_step=None) -> None:
        """One training batch: under TRUNCATED_BPTT with a rank-3 input and
        rank-3 labels, one step per window (`_fit_tbptt`); otherwise one
        optimizer step on the whole batch. `do_step(inputs, labels,
        fmasks, lmasks)` replaces `_run_and_commit` (ParallelWrapper's
        sharded step)."""
        mds = self._coerce(mds)
        do_step = do_step or self._run_and_commit
        if self.conf.backprop_type == BackpropType.TRUNCATED_BPTT:
            if any(np.ndim(f) == 3 for f in mds.features) and \
                    all(np.ndim(y) == 3 for y in mds.labels):
                self._fit_tbptt(mds, do_step)
                return
            if not getattr(self, "_warned_tbptt_labels", False):
                log.warning("Truncated BPTT requires rank-3 features and labels; "
                            "using standard BPTT")
                self._warned_tbptt_labels = True
        self._rnn_carry = None   # standard BPTT: every batch starts from zeros
        do_step(*self._pack(mds))

    def _fit_tbptt(self, mds: MultiDataSet, do_step=None):
        """Truncated BPTT over the graph (reference doTruncatedBPTT): windows
        of tbptt_fwd_length over the time axis of every rank-3 array, one
        optimizer step each, the carry passed on detached; rank-2 inputs,
        and masks shorter than the longest sequence, go whole into every
        window."""
        T = max(np.shape(f)[1] for f in mds.features if np.ndim(f) == 3)
        L = self.conf.tbptt_fwd_length
        self.rnn_clear_previous_state()
        self._seed_recurrent_states(np.shape(mds.features[0])[0])

        def mask_win(m, s, e):
            if m is None:
                return None
            return m[:, s:e] if np.ndim(m) >= 2 and np.shape(m)[1] >= T else m

        for start in range(0, T, L):
            end = min(start + L, T)
            win = MultiDataSet(
                [f[:, start:end] if np.ndim(f) == 3 else f for f in mds.features],
                [y[:, start:end] for y in mds.labels],
                None if mds.features_masks is None else
                [mask_win(m, start, end) for m in mds.features_masks],
                None if mds.labels_masks is None else
                [mask_win(m, start, end) for m in mds.labels_masks])
            (do_step or self._run_and_commit)(*self._pack(win))
        self.rnn_clear_previous_state()

    def _train_step(self, inputs, labels, fmasks, lmasks) -> Tensor:
        """One optimizer step: forward, loss, one backward, then per layer
        node normalize -> update -> p - u; the new layer state (and carry)
        is committed with the new parameters. Returns the loss, a 0-d
        tensor on the device (no host sync)."""
        telemetry_mod.note_step_signature(
            f"graph_train_step#{self._probe_tag}",
            telemetry_mod.shape_signature(
                *inputs.values(), *labels.values(),
                *fmasks.values(), *lmasks.values()))
        return self._apply_step(*self._value_and_grad(
            inputs, labels, fmasks, lmasks, True, self._dropout_gen,
            state=self._merged_state()))

    def _apply_step(self, loss: Tensor, grads, new_state) -> Tensor:
        """The update half of `_train_step` (ParallelWrapper's sharded step
        feeds it its reduced gradients)."""
        with torch.no_grad():
            stepped = {n: _layer_step(self.conf.nodes[n].layer,
                                      self.params_tree[n], grads[n],
                                      self.opt_state[n], self.iteration)
                       for n in self._layer_nodes}
        self.params_tree = {n: p for n, (p, _) in stepped.items()}
        self.opt_state = {n: o for n, (_, o) in stepped.items()}
        self._commit_state(new_state)
        self.iteration += 1
        self.score_value = loss
        return loss

    def _run_and_commit(self, inputs, labels, fmasks, lmasks) -> None:
        """`_train_step`, counted, then the listeners."""
        self._train_step(inputs, labels, fmasks, lmasks)
        metrics_mod.record_train_step(1)
        for lst in self.listeners:
            lst.iteration_done(self, self.iteration)

    def _no_tbptt(self, what: str):
        if self.conf.backprop_type == BackpropType.TRUNCATED_BPTT:
            raise NotImplementedError(
                f"{what} does not support truncated BPTT windows; call "
                "fit_batch per batch")

    def fit_batches(self, batches) -> "ComputationGraph":
        """One optimizer step per minibatch of `batches` (same shapes; masks
        uniformly present or absent), back to back with no host sync; the
        listeners fire afterwards with each step's loss. Bitwise the same
        as `fit_batch` per batch."""
        self._check_init()
        packed = [self._pack(self._coerce(b)) for b in batches]
        self._no_tbptt("fit_batches")
        self._rnn_carry = None
        losses = [self._train_step(*p) for p in packed]
        commit_multi(self, losses, len(packed))
        return self

    def fit_batch_repeated(self, mds, steps: int) -> "ComputationGraph":
        """`steps` optimizer steps on one minibatch, copied to the device
        once: `fit_batch` in a loop."""
        self._check_init()
        self._no_tbptt("fit_batch_repeated")
        packed = self._pack(self._coerce(mds))
        self._rnn_carry = None
        losses = [self._train_step(*packed) for _ in range(int(steps))]
        commit_multi(self, losses, int(steps))
        return self

    # ------------------------------------------------------------- rnn state
    def _seed_recurrent_states(self, batch: int):
        """Start a zero carry for `batch` rows, unless one is running."""
        if self._rnn_carry is None:
            self._rnn_carry = {
                n: self.conf.nodes[n].layer.seed_recurrent_state(
                    batch, self._dtype, self.device)
                for n in self._layer_nodes if self.conf.nodes[n].layer.is_recurrent()}

    def _merged_state(self):
        """The layer state with the carry merged in, where one is running."""
        if self._rnn_carry is None:
            return self.state_tree
        return {n: {**st, **self._rnn_carry.get(n, {})}
                for n, st in self.state_tree.items()}

    def _commit_state(self, new_state):
        """Take a step's new state: the carry (detached) apart from the
        layer state, where one is running."""
        if self._rnn_carry is None:
            self.state_tree = new_state
            return
        split = {n: self._split_carry(st) for n, st in new_state.items()}
        self.state_tree = {n: st for n, (st, _) in split.items()}
        self._rnn_carry = {n: c for n, (_, c) in split.items() if c}

    def rnn_time_step(self, *features) -> List[np.ndarray]:
        """Streaming inference from the stored carry (reference
        ComputationGraph.rnnTimeStep): every network output, in
        conf.network_outputs order, for inputs of one step [batch, features]
        or several [batch, time, features]. Raises as
        MultiLayerNetwork.rnn_time_step does."""
        self._check_init()
        self._check_streaming((n, self.conf.nodes[n].layer) for n in self._layer_nodes)
        inputs, _ = self._pack_inputs(self._features(features))
        batch = next(iter(inputs.values())).shape[0]
        self._check_carry_batch(batch)
        self._seed_recurrent_states(batch)
        with torch.no_grad():
            acts, _, new_state = self._walk(self.params_tree, self._merged_state(),
                                            inputs)
        self._commit_state(new_state)
        return [_to_numpy(acts[n]) for n in self.conf.network_outputs]

    def evaluate(self, data, labels=None, batch_size: int = 128,
                 output_index: int = 0):
        """Classification metrics (eval/evaluation.Evaluation) for network
        output `output_index`, over `data` in `batch_size` rows,
        mask-aware."""
        from ...eval.evaluation import Evaluation
        self._check_init()
        mds = self._coerce(data, labels)
        ev = Evaluation()
        n = mds.num_examples()
        for start in range(0, n, batch_size):
            part = mds.slice(start, min(start + batch_size, n))
            outs = self.outputs(*part.features,
                                features_masks=part.features_masks)
            lm = None if part.labels_masks is None \
                else part.labels_masks[output_index]
            ev.eval(part.labels[output_index], outs[output_index], mask=lm)
        return ev

    # ----------------------------------------------------------------- score
    def score(self, data=None) -> float:
        """Loss summed over the output heads + regularization on `data`, no
        dropout, on the running layer state, which stays as it is; with no
        data, the score of the last training step."""
        self._check_init()
        if data is None:
            if self.score_value is None:
                raise ValueError("No data given and no cached score")
            return float(self.score_value)
        with torch.inference_mode():
            inputs, labels, fmasks, lmasks = self._pack(self._coerce(data))
            return float(self._loss(self.params_tree, self.state_tree, inputs,
                                    labels, fmasks, lmasks, False, None)[0])

    def compute_gradient_and_score(self, data):
        """(gradients by node in the port's layout, score) without updating
        the parameters, with train=False: no dropout, the running layer
        state, which stays as it is."""
        self._check_init()
        inputs, labels, fmasks, lmasks = self._pack(self._coerce(data))
        loss, grads, _ = self._value_and_grad(inputs, labels, fmasks, lmasks,
                                              False, None)
        return grads, float(loss)

    def summary(self) -> str:
        lines = ["name | type | params"]
        for name in self.conf.topo_order:
            node = self.conf.nodes[name]
            kind = type(node.layer if node.is_layer() else node.vertex).__name__
            n = (param_utils.num_params(self.params_tree[name])
                 if self._initialized and node.is_layer() else 0)
            lines.append(f"{name} | {kind} | {n}")
        if self._initialized:
            lines.append(f"Total params: {self.num_params()}")
        return "\n".join(lines)
