"""MultiLayerNetwork: sequential-stack network with fit/output/score.

Port of `deeplearning4j_tpu/nn/multilayer.py` (reference
nn/multilayer/MultiLayerNetwork.java): `init`, `output`, `predict`,
`feed_forward`, `warmup`, `_feature_struct`, and the training loop: `fit`,
`score`, `compute_gradient_and_score`.

Where the JAX package jits one pure forward, the port runs the layers
eagerly under ``torch.inference_mode``. Where it jits one pure train step,
the port runs the forward and the loss under autograd, takes one backward,
and then, per layer under ``torch.no_grad``, normalizes the gradients, runs
the updater and sets ``p - u`` (frozen layers keep theirs). Parameters,
optimizer state and layer state are tuples of per-layer dicts of tensors on
the network's device (``params_tree``, ``opt_state``, ``state_tree``), in
the port's layout (utils/params.py converts from and to the JAX
package's). The layer state (BatchNormalization's running statistics) is
threaded through every forward as the JAX package threads it: a training
step commits the new state with the new parameters; ``output``, ``score``,
``compute_gradient_and_score`` and ``feed_forward`` run on it and leave it
as it is. The features
mask (``DataSet.features_mask``, [batch, time]) reaches every layer's forward
as ``mask``, as in the JAX package. Labels and masks stay float32 (float64 in
a float64 network) whatever the parameters' type, as the JAX package keeps
them: in a bfloat16 network, casting them to bfloat16 would round a masked
score's step count (1001 present steps count as 1000).

Recurrent layers keep a streaming carry ({"h", "c"} per LSTM layer) outside
``state_tree``, as the JAX package does: it is merged into the layer state
only for truncated BPTT windows and `rnn_time_step` (`_merged_state`) and
split back out when a step commits (`_commit_state`), so ``state_tree`` and
``state.npz`` never hold it. A committed carry is detached: no gradient
crosses a window boundary, as none crosses the JAX package's jitted steps.
Truncated BPTT (`_fit_tbptt`) takes one optimizer step per window of
``tbptt_fwd_length`` steps, the last one partial, the backward over the whole
window (``tbptt_back_length`` is ignored, as in the JAX package).

`fit` takes the JAX package's signature and defaults: its loop
(nn/stepping.py, shared with ComputationGraph) pads ragged batches to the
epoch's batch shape (`pad_to_bucket`), stages batches onto the device on a
producer thread through pinned memory (`prefetch_to_device`), groups
`steps_per_dispatch` same-shaped batches into one `fit_batches` call, and
runs the checkpoint (`checkpoint`, `resume`) and divergence-sentinel
(`sentinel`) hooks, the spans and the metrics. Where the JAX package scans a
group in one jitted dispatch, the port runs it as a loop of the same eager
step with no host sync between steps, the losses staying on the device
until the group commits, so a group is bitwise the same batches fitted one
by one. `evaluate` / `evaluate_regression` fill eval/evaluation.py's
accumulators; `fit_solver` runs optimize/solvers.py. `pretrain` is the
greedy layerwise pretraining of the AutoEncoder, VariationalAutoencoder and
RBM layers; `params`, `set_params`, `num_params` and `clone` are shared with
ComputationGraph.

Checkpoints are utils/model_serializer.py's, shared with ComputationGraph
(nn/graph/graph.py), which reuses this module's casts and per-layer step.
"""
from __future__ import annotations

import logging
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ..data.dataset import DataSet
from ..data.iterators import as_iterator
from ..optimize import metrics as metrics_mod
from ..optimize import telemetry as telemetry_mod
from ..utils import params as param_utils
from ..utils.device import DeviceLike, resolve_device
from .conf.builders import BackpropType, MultiLayerConfiguration
from .conf.inputs import (ConvolutionalFlatType, ConvolutionalType,
                          FeedForwardType, RecurrentType)
from .layers.core import dropout
from . import shards
from .layers.recurrent import RECURRENT_CARRY_KEYS
from .stepping import check_fit_args, commit_multi, data_pipeline, run_fit
from .updaters import leafwise, normalize_layer_gradients

Tensor = torch.Tensor
log = logging.getLogger(__name__)


class RnnStateMismatchError(ValueError):
    """`rnn_time_step` was called with another batch size than the stored
    recurrent carry's. The carry is reset before this raises, so that the
    failed call leaves no stale carry to the next caller."""


def _regularization_score(layers, params):
    """L1 + 0.5*L2 penalty over all parameters (reference
    BaseLayer.calcL1/calcL2, summed into the score): a 0-d tensor on the
    parameters' device, or 0.0 when no parameter is regularized."""
    total = 0.0
    for layer, lp in zip(layers, params):
        for name, p in lp.items():
            l1, l2 = layer.param_reg(name)
            if l1:
                total = total + l1 * torch.sum(torch.abs(p))
            if l2:
                total = total + 0.5 * l2 * torch.sum(p * p)
    return total


def _to_numpy(t: Tensor) -> np.ndarray:
    """A host copy of `t`; bfloat16 as float32, which holds every bfloat16
    value exactly (numpy has no bfloat16, where the JAX package returns
    ml_dtypes' bfloat16 arrays)."""
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def _input_shape(it, batch_size: int, time_steps: Optional[int]):
    """The shape of a feature batch of `batch_size` rows of input type
    `it`, or None for an input type that does not size one."""
    b = int(batch_size)
    if isinstance(it, ConvolutionalType):
        return (b, it.height, it.width, it.channels)
    if isinstance(it, ConvolutionalFlatType):
        return (b, it.flat_size)
    if isinstance(it, RecurrentType):
        t = time_steps or it.timeseries_length
        if not t:
            raise ValueError(
                "a recurrent net needs time_steps= (or a RecurrentType "
                "with timeseries_length)")
        return (b, int(t), it.size)
    if isinstance(it, FeedForwardType):
        return (b, it.size)
    return None


def _layer_step(layer, params, grads, opt_state, iteration):
    """One layer's share of an optimizer step: normalize its gradients,
    run its updater, and set ``p - u`` (a frozen layer keeps its
    parameters and state). Returns (new params, new optimizer state)."""
    if layer.frozen:
        return params, opt_state
    g = normalize_layer_gradients(grads, layer.gradient_normalization,
                                  layer.gradient_normalization_threshold)
    updates, new_opt = layer.updater.update(g, opt_state, iteration)
    return {k: leafwise(lambda p, u: p - u.to(p.dtype), p, updates[k])
            for k, p in params.items()}, new_opt


class _DeviceNetwork:
    """What MultiLayerNetwork and ComputationGraph share: init (each draws
    its own tree, `_draw_params`, and builds its optimizer state,
    `_opt_init`, and its layer state, `_state_init`), the init check and the
    host-to-device casts of features, labels and masks."""

    def _check_init(self):
        if not self._initialized:
            raise RuntimeError("Call net.init() before using the network")

    def init(self, seed: Optional[int] = None, dtype=torch.float32,
             device: DeviceLike = None):
        """Draw every layer's parameters (a graph's layer nodes in
        topological order) from a generator seeded with `seed` (default: the
        configuration's) and place them on `device` (default: CUDA, raising
        when there is none); build each layer's optimizer state, its layer
        state and the dropout generator, on the same device and from the
        same seed."""
        dev = resolve_device(device)
        seed = self.conf.seed if seed is None else int(seed)
        params = self._draw_params(torch.Generator().manual_seed(seed), dtype)
        return self._adopt(param_utils.tree_map(
            lambda t: param_utils.place(t, dev), params), dtype, dev, seed)

    def _adopt(self, params_tree, dtype, device: torch.device,
               seed: Optional[int] = None, opt_state=None, state_tree=None):
        """Make `params_tree` (on `device`) the network's parameters, with
        `opt_state` or each layer's fresh optimizer state, `state_tree` or
        each layer's fresh layer state, the dropout generator on `device`
        seeded with `seed` (default: the configuration's), and the counters
        at 0."""
        self.device, self._dtype = device, dtype
        self.params_tree = params_tree
        self.opt_state = (self._opt_init(params_tree) if opt_state is None
                          else opt_state)
        if state_tree is None:
            state_tree = param_utils.tree_map(
                lambda t: param_utils.place(t, device), self._state_init(dtype))
        self.state_tree = state_tree
        self._dropout_gen = torch.Generator(device=device).manual_seed(
            self.conf.seed if seed is None else seed)
        self.iteration = 0
        self.epoch = 0
        self._rnn_carry = None
        self._initialized = True
        return self

    def _as_input(self, x) -> Tensor:
        """Features on the device: floating ones in the network's type,
        integer ones (embedding indices) as they are, as the JAX package's
        `_cast_features` does. A bfloat16 cast would round index 257 to 256."""
        x = torch.as_tensor(x, device=self.device)
        return x.to(self._dtype) if x.is_floating_point() else x

    def _as_labels(self, y) -> Tensor:
        """Labels (and masks) on the device, float32, or float64 in a
        float64 network."""
        if not isinstance(y, Tensor):
            y = np.asarray(y)
        return torch.as_tensor(y, device=self.device).to(
            torch.promote_types(self._dtype, torch.float32))

    def _as_mask(self, m) -> Optional[Tensor]:
        return None if m is None else self._as_labels(m)

    # ------------------------------------------------------------ param view
    def params(self) -> np.ndarray:
        """The flat parameter vector (reference params()): leaves in
        checkpoint order (dict keys sorted), each in the JAX package's
        layout, row-major."""
        self._check_init()
        return param_utils.flatten_params(self.params_tree)

    def set_params(self, flat) -> None:
        """Inverse of `params`: the parameters from a flat vector, each leaf
        keeping its type and device."""
        self._check_init()
        self.params_tree = param_utils.unflatten_params(self.params_tree, flat,
                                                        self.device)

    def num_params(self) -> int:
        self._check_init()
        return param_utils.num_params(self.params_tree)

    def clone(self):
        """A new network of a copy of the configuration holding copies of
        the parameters, the optimizer state and the layer state, on the same
        device, with the same counters; an uninitialized network clones
        uninitialized."""
        net = type(self)(self.conf.clone())
        if self._initialized:
            net._adopt(param_utils.tree_copy(self.params_tree), self._dtype,
                       self.device, opt_state=param_utils.tree_copy(self.opt_state),
                       state_tree=param_utils.tree_copy(self.state_tree))
            net.iteration, net.epoch = self.iteration, self.epoch
        return net

    def set_listeners(self, *listeners):
        """Replace the listeners (optimize/listeners.py): `iteration_done`
        after every optimizer step, `on_epoch_end` after every epoch."""
        self.listeners = list(listeners)
        return self

    def add_listener(self, listener):
        self.listeners.append(listener)
        return self

    # ------------------------------------------------------------- rnn state
    def rnn_clear_previous_state(self):
        """Drop the recurrent carry (reference rnnClearPreviousState())."""
        self._rnn_carry = None

    def _check_streaming(self, layers):
        """`rnn_time_step` needs every layer able to run step by step."""
        for name, layer in layers:
            if not layer.supports_streaming():
                raise NotImplementedError(
                    f"{type(layer).__name__} ({name!r}) does not support "
                    "rnn_time_step (it needs the whole sequence)")

    def _check_carry_batch(self, batch: int):
        """Raise RnnStateMismatchError, after resetting the carry, when a
        stored carry has another batch size than `batch`."""
        carries = (self._rnn_carry.values() if isinstance(self._rnn_carry, dict)
                   else self._rnn_carry or ())
        for carry in carries:
            if "h" in carry and carry["h"].shape[0] != batch:
                stored = carry["h"].shape[0]
                self._rnn_carry = None
                raise RnnStateMismatchError(
                    f"rnn_time_step batch size {batch} != stored state batch "
                    f"size {stored}; the stored recurrent state has been reset")

    @staticmethod
    def _split_carry(st: dict):
        """(layer state without the carry, the carry detached)."""
        return ({k: v for k, v in st.items() if k not in RECURRENT_CARRY_KEYS},
                {k: v.detach() for k, v in st.items() if k in RECURRENT_CARRY_KEYS})


class MultiLayerNetwork(_DeviceNetwork):
    def __init__(self, conf: MultiLayerConfiguration):
        self.conf = conf
        self.layers = list(conf.layers)
        if not self.layers:
            raise ValueError("Configuration has no layers")
        self.params_tree: Optional[Tuple[dict, ...]] = None
        self.opt_state: Optional[Tuple[Any, ...]] = None
        self.state_tree: Optional[Tuple[dict, ...]] = None
        self.device: Optional[torch.device] = None
        self.iteration = 0
        self.epoch = 0
        self.listeners: List[Any] = []
        #: loss + regularization of the last training step, a 0-d tensor on
        #: the network's device (read it with float() or score())
        self.score_value: Optional[Tensor] = None
        #: the fit loop's wait for the last batch (reference lastEtlTime),
        #: split by a device prefetcher into host wait and h2d copy
        self.last_etl_ms = self.last_etl_host_ms = self.last_etl_h2d_ms = 0.0
        self._dtype = torch.float32
        self._dropout_gen: Optional[torch.Generator] = None
        #: per layer, the streaming carry {"h", "c"} ({} for other layers),
        #: or None outside truncated BPTT and rnn_time_step
        self._rnn_carry: Optional[Tuple[dict, ...]] = None
        self._initialized = False
        #: the shape-churn guard's label suffix (optimize/telemetry.py)
        self._probe_tag = telemetry_mod.probe_tag(self)

    # ------------------------------------------------------------------ init
    def _draw_params(self, gen: torch.Generator, dtype) -> Tuple[dict, ...]:
        return tuple(layer.init_params(gen, dtype) for layer in self.layers)

    def _opt_init(self, params_tree) -> Tuple[Any, ...]:
        return tuple(layer.updater.init(p) for layer, p in
                     zip(self.layers, params_tree))

    def _state_init(self, dtype) -> Tuple[dict, ...]:
        return tuple(layer.init_state(dtype) for layer in self.layers)

    # --------------------------------------------------------------- forward
    def _forward(self, params, state, x: Tensor, train: bool = False,
                 generator: Optional[torch.Generator] = None,
                 fmask: Optional[Tensor] = None
                 ) -> Tuple[Tensor, Tuple[dict, ...], List[Tensor]]:
        """Run all layers; returns (final activation, new layer state, every
        activation)."""
        a = x
        activations, new_state = [], []
        for i, layer in enumerate(self.layers):
            p = self.conf.preprocessor(i)
            if p is not None:
                a = p(a)
            a, st = shards.forward_layer(layer, params[i], state[i], a,
                                         train=train, generator=generator,
                                         mask=fmask)
            new_state.append(st)
            activations.append(a)
        return a, tuple(new_state), activations

    def _loss(self, params, state, x: Tensor, y: Tensor,
              fmask: Optional[Tensor], lmask: Optional[Tensor], train: bool,
              generator: Optional[torch.Generator]
              ) -> Tuple[Tensor, Tuple[dict, ...]]:
        """(score, new layer state). Score = output-layer loss +
        regularization (reference computeGradientAndScore): every layer but
        the last, the output layer's preprocessor, its input dropout when
        training, then its `compute_score`; the output layer's state passes
        through."""
        a = x
        n = len(self.layers)
        new_state = []
        for i, layer in enumerate(self.layers[:-1]):
            p = self.conf.preprocessor(i)
            if p is not None:
                a = p(a)
            a, st = shards.forward_layer(layer, params[i], state[i], a,
                                         train=train, generator=generator,
                                         mask=fmask)
            new_state.append(st)
        new_state.append(state[n - 1])
        out_layer = self.layers[-1]
        if not out_layer.is_output_layer():
            raise ValueError("Last layer must be an output layer to compute score")
        p = self.conf.preprocessor(n - 1)
        if p is not None:
            a = p(a)
        if train and out_layer.dropout_rate and generator is not None:
            a = dropout(a, out_layer.dropout_rate, train, generator)
        loss = shards.score(out_layer, params[n - 1], a, y, lmask)
        return (loss + _regularization_score(self.layers, params),
                tuple(new_state))

    def _value_and_grad(self, x: Tensor, y: Tensor, fmask: Optional[Tensor],
                        lmask: Optional[Tensor], train: bool,
                        generator: Optional[torch.Generator], state=None):
        """(score, gradients, new layer state) at the current parameters and
        `state` (default: the layer state, without a carry): one autograd
        backward. A parameter the score does not reach gets zeros, as JAX's
        grad gives."""
        tree = tuple({k: t.detach().requires_grad_() for k, t in lp.items()}
                     for lp in self.params_tree)
        flat = [t for lp in tree for t in lp.values()]
        with torch.enable_grad():
            loss, new_state = self._loss(
                tree, self.state_tree if state is None else state, x, y, fmask,
                lmask, train, generator)
        grads = torch.autograd.grad(loss, flat, allow_unused=True) if flat else ()
        flat_g = iter([torch.zeros_like(t) if g is None else g
                       for g, t in zip(grads, flat)])
        return (loss.detach(), tuple({k: next(flat_g) for k in lp} for lp in tree),
                new_state)

    def _feature_struct(self, batch_size: int,
                        time_steps: Optional[int] = None) -> Tensor:
        """A meta tensor with the shape and dtype of a feature batch,
        inferred from conf.input_type (or the first layer's n_in when no
        input type was declared)."""
        b = int(batch_size)
        shape = _input_shape(getattr(self.conf, "input_type", None), b,
                             time_steps)
        if shape is None:
            n_in = getattr(self.layers[0], "n_in", None)
            if not n_in:
                raise ValueError(
                    "cannot infer the input shape: declare an input type on "
                    "the configuration")
            if self.layers[0].input_kind() == "rnn":
                if not time_steps:
                    raise ValueError("a recurrent net needs time_steps=")
                shape = (b, int(time_steps), int(n_in))
            else:
                shape = (b, int(n_in))
        return torch.empty(shape, dtype=self._dtype, device="meta")

    def warmup(self, batch_size: int = 1, *,
               time_steps: Optional[int] = None) -> "MultiLayerNetwork":
        """Serving cold-start eliminator: push one zero batch of
        `batch_size` through `output()` so the first real request at that
        size finds cuDNN's algorithms chosen and the kernels built."""
        self._check_init()
        x_s = self._feature_struct(batch_size, time_steps)
        self.output(torch.zeros(x_s.shape, dtype=x_s.dtype, device=self.device))
        return self

    # ------------------------------------------------------------- inference
    def output(self, x, features_mask=None) -> np.ndarray:
        """Forward pass, inference mode (reference output())."""
        self._check_init()
        with torch.inference_mode():
            xa, fm = self._as_input(x), self._as_mask(features_mask)
            telemetry_mod.note_step_signature(
                f"mln_output#{self._probe_tag}",
                telemetry_mod.shape_signature(xa, fm))
            out, _, _ = self._forward(self.params_tree, self.state_tree, xa,
                                      fmask=fm)
            return out.cpu().numpy()

    def feed_forward(self, x, train: bool = False) -> List[np.ndarray]:
        """All layer activations incl. input (reference feedForward()).
        With `train`, batch statistics normalize (and dropout, which then
        raises for want of a generator, as the JAX package's raises for want
        of a key); the new layer state is discarded. bfloat16 activations
        come back as float32 (`_to_numpy`)."""
        self._check_init()
        with torch.inference_mode():
            xa = self._as_input(x)
            _, _, acts = self._forward(self.params_tree, self.state_tree, xa,
                                       train=train)
            return [_to_numpy(a) for a in [xa] + acts]

    def predict(self, x) -> np.ndarray:
        """Argmax class predictions (reference predict())."""
        return np.argmax(self.output(x), axis=-1)

    # ------------------------------------------------------------------- fit
    def fit(self, data, labels=None, *, epochs: int = 1, batch_size: int = 32,
            use_async: bool = True, async_queue_size: int = 8,
            step_fn=None, steps_per_dispatch: int = 1,
            pad_to_bucket: bool = True, prefetch_to_device: bool = True,
            prefetch_depth: int = 2, prefetch_sharding=None,
            prefetch_divisor: int = 1,
            checkpoint=None, resume: bool = False, sentinel=None
            ) -> "MultiLayerNetwork":
        """Train (reference fit(DataSetIterator)). Accepts a DataSetIterator,
        a DataSet, or (features, labels) arrays cut into `batch_size` rows.
        `step_fn(ds)` replaces the per-batch step (ParallelWrapper's hook).

        `pad_to_bucket` pads a ragged batch to the epoch's batch shape with
        zero-weight rows (loss and gradients as on the unpadded batch;
        BatchNormalization's batch statistics see the pad rows, as in the
        JAX package); not under truncated BPTT, whose labels mask is
        windowed in time. `use_async` prefetches on a producer thread;
        `prefetch_to_device` makes that thread stage batches onto the
        network's device through pinned memory on its own stream, at most
        `prefetch_depth` ahead; ParallelWrapper passes its mesh's
        `prefetch_sharding` and `prefetch_divisor` (a batch whose rows the
        divisor does not divide stays on the host for the wrapper's pad).

        `steps_per_dispatch > 1` runs each `steps_per_dispatch` same-shaped
        batches as one `fit_batches` group (a batch of another shape
        flushes the group first; the epoch's tail group runs short); it
        cannot combine with `step_fn`, `checkpoint` or `sentinel`. Under
        truncated BPTT listeners then fire once per batch, not per window.

        `checkpoint` (optimize/resilience.CheckpointManager) saves at its
        cadence; `resume=True` first restores its newest valid checkpoint
        and skips what it covers, `epochs` counting the run's total epochs:
        resumed, a deterministic unshuffled run is bitwise an uninterrupted
        one for a model without dropout (the port does not store the
        dropout generator's state). `sentinel`
        (optimize/resilience.DivergenceSentinel) checks every step for a
        non-finite loss or parameter."""
        self._check_init()
        epochs, skip = check_fit_args(self, epochs, steps_per_dispatch,
                                      step_fn, checkpoint, resume, sentinel)
        tbptt = self.conf.backprop_type == BackpropType.TRUNCATED_BPTT
        wrapped = data_pipeline(
            self, as_iterator(data, labels, batch_size),
            pad=pad_to_bucket and not tbptt, use_async=use_async,
            queue_size=async_queue_size, prefetch_to_device=prefetch_to_device,
            prefetch_depth=prefetch_depth, prefetch_sharding=prefetch_sharding,
            prefetch_divisor=prefetch_divisor, multi=False)
        run_fit(self, wrapped, epochs=epochs, step=step_fn or self._fit_batch,
                spd=int(steps_per_dispatch), checkpoint=checkpoint,
                sentinel=sentinel, skip_batches=skip)
        return self

    def _tbptt_batch(self, ds) -> bool:
        """Whether `ds` runs as truncated-BPTT windows: rank-3 features and
        labels under TRUNCATED_BPTT. Rank-2 labels warn once and run whole
        (windowing them on axis 1 would cut the class axis)."""
        if self.conf.backprop_type != BackpropType.TRUNCATED_BPTT or \
                np.ndim(ds.features) != 3:
            return False
        if np.ndim(ds.labels) == 3:
            return True
        if not getattr(self, "_warned_tbptt_labels", False):
            log.warning("Truncated BPTT requires rank-3 (time-series) labels; "
                        "got rank-%d: using standard BPTT", np.ndim(ds.labels))
            self._warned_tbptt_labels = True
        return False

    def _fit_batch(self, ds: DataSet, do_step=None):
        """One batch: one step, or under truncated BPTT one per window;
        `do_step(x, y, fmask, lmask)` replaces `_do_step` (ParallelWrapper's
        sharded step)."""
        if self._tbptt_batch(ds):
            self._fit_tbptt(ds, do_step)
            return
        self._rnn_carry = None   # standard BPTT: every batch starts from zeros
        (do_step or self._do_step)(ds.features, ds.labels, ds.features_mask,
                                   ds.labels_mask)

    def _fit_tbptt(self, ds: DataSet, do_step=None) -> Tensor:
        """Truncated BPTT (reference doTruncatedBPTT): one optimizer step per
        window of tbptt_fwd_length steps, the last one partial, masks
        windowed alike; the carry starts from zeros, passes from window to
        window detached, and is dropped after the batch. Returns the last
        window's loss."""
        do_step = do_step or self._do_step
        T = np.shape(ds.features)[1]
        L = self.conf.tbptt_fwd_length
        self.rnn_clear_previous_state()
        self._seed_recurrent_states(np.shape(ds.features)[0])
        for start in range(0, T, L):
            end = min(start + L, T)
            win = lambda m: None if m is None else m[:, start:end]
            loss = do_step(ds.features[:, start:end], ds.labels[:, start:end],
                           win(ds.features_mask), win(ds.labels_mask))
        self.rnn_clear_previous_state()
        return loss

    def _train_step(self, x, y, fmask, lmask) -> Tensor:
        """One optimizer step: forward + loss + one backward, then per layer
        normalize -> update -> p - u, skipping frozen layers; the new layer
        state (and carry) is committed with the new parameters. Returns the
        loss, a 0-d tensor on the device (no host sync)."""
        x, y = self._as_input(x), self._as_labels(y)
        fmask, lmask = self._as_mask(fmask), self._as_mask(lmask)
        telemetry_mod.note_step_signature(
            f"mln_train_step#{self._probe_tag}",
            telemetry_mod.shape_signature(x, y, fmask, lmask))
        return self._apply_step(*self._value_and_grad(
            x, y, fmask, lmask, True, self._dropout_gen,
            state=self._merged_state()))

    def _apply_step(self, loss: Tensor, grads, new_state) -> Tensor:
        """The update half of `_train_step` (ParallelWrapper's sharded step
        feeds it its reduced gradients): per layer normalize -> update ->
        p - u, commit the new state, count the iteration."""
        with torch.no_grad():
            stepped = [_layer_step(layer, self.params_tree[i], grads[i],
                                   self.opt_state[i], self.iteration)
                       for i, layer in enumerate(self.layers)]
        self.params_tree = tuple(p for p, _ in stepped)
        self.opt_state = tuple(o for _, o in stepped)
        self._commit_state(new_state)
        self.iteration += 1
        self.score_value = loss
        return loss

    def _do_step(self, x, y, fmask, lmask) -> Tensor:
        """`_train_step`, counted, then the listeners."""
        loss = self._train_step(x, y, fmask, lmask)
        metrics_mod.record_train_step(1)
        for lst in self.listeners:
            lst.iteration_done(self, self.iteration)
        return loss

    def fit_batches(self, batches) -> "MultiLayerNetwork":
        """One optimizer step per batch of `batches` (same shapes and masks),
        run back to back with no host sync, the listeners firing afterwards
        with each step's loss (the JAX package runs them as one scanned
        dispatch; the ComputationGraph.fit_batches analog). Truncated-BPTT
        batches (rank-3 features AND labels) run their whole window schedule
        each, from a fresh carry, and fire one listener event per batch.
        Bitwise the same as fitting the batches one by one."""
        self._check_init()
        batches = list(batches)
        self._rnn_carry = None
        if self._tbptt_batch(batches[0]):
            windows = -(-np.shape(batches[0].features)[1]
                        // self.conf.tbptt_fwd_length)
            losses = [self._fit_tbptt(b, self._train_step) for b in batches]
            commit_multi(self, losses, len(batches) * windows,
                         listener_events=len(batches))
            return self
        if self.conf.backprop_type == BackpropType.TRUNCATED_BPTT and \
                not getattr(self, "_warned_tbptt_labels", False):
            log.warning("Truncated BPTT requires rank-3 (time-series) features "
                        "and labels: using standard BPTT")
            self._warned_tbptt_labels = True
        losses = []
        for b in batches:
            self._rnn_carry = None
            losses.append(self._train_step(b.features, b.labels,
                                           b.features_mask, b.labels_mask))
        commit_multi(self, losses, len(batches))
        return self

    def fit_batch_repeated(self, ds: DataSet, steps: int
                           ) -> "MultiLayerNetwork":
        """`steps` optimizer steps on one batch, copied to the device once.
        For truncated-BPTT batches each repeat runs the full window schedule
        from a fresh carry (one optimizer step PER WINDOW, so the iteration
        advances steps * ceil(T / L); one listener event per repeat)."""
        self._check_init()
        self._rnn_carry = None
        ds = DataSet(self._as_input(ds.features), self._as_labels(ds.labels),
                     self._as_mask(ds.features_mask), self._as_mask(ds.labels_mask))
        steps = int(steps)
        if self._tbptt_batch(ds):
            windows = -(-ds.features.shape[1] // self.conf.tbptt_fwd_length)
            losses = [self._fit_tbptt(ds, self._train_step) for _ in range(steps)]
            commit_multi(self, losses, steps * windows, listener_events=steps)
            return self
        losses = [self._train_step(ds.features, ds.labels, ds.features_mask,
                                   ds.labels_mask) for _ in range(steps)]
        commit_multi(self, losses, steps)
        return self

    def fit_solver(self, x, y, *, max_iterations: int = 100,
                   tolerance: float = 1e-6, fmask=None, lmask=None) -> float:
        """Full-batch optimization with the configured non-SGD solver
        (reference Solver dispatch; LINE_GRADIENT_DESCENT /
        CONJUGATE_GRADIENT / LBFGS). Returns the final score."""
        from ..optimize.solvers import solver_for
        solver = solver_for(self.conf.optimization_algo,
                            max_iterations=max_iterations, tolerance=tolerance)
        return solver.optimize(self, x, y, fmask, lmask)

    # ----------------------------------------------------------------- score
    def score(self, ds: Optional[DataSet] = None, x=None, y=None) -> float:
        """Mean loss + regularization (reference score()) on the running
        layer state, which stays as it is; with no data, the score of the
        last training step."""
        self._check_init()
        fmask = lmask = None
        if ds is not None:
            x, y = ds.features, ds.labels
            fmask, lmask = ds.features_mask, ds.labels_mask
        if x is None:
            if self.score_value is None:
                raise ValueError("No data given and no cached score")
            return float(self.score_value)
        with torch.inference_mode():
            return float(self._loss(self.params_tree, self.state_tree,
                                    self._as_input(x), self._as_labels(y),
                                    self._as_mask(fmask), self._as_mask(lmask),
                                    False, None)[0])

    def compute_gradient_and_score(self, ds: DataSet):
        """(gradients, score) without updating the parameters (reference
        computeGradientAndScore() + gradient()), with train=False: no
        dropout, the running layer state, which stays as it is. The
        gradients are per-layer dicts in the port's layout."""
        self._check_init()
        loss, grads, _ = self._value_and_grad(
            self._as_input(ds.features), self._as_labels(ds.labels),
            self._as_mask(ds.features_mask), self._as_mask(ds.labels_mask),
            False, None)
        return grads, float(loss)

    # ------------------------------------------------------------ evaluation
    def evaluate(self, data, labels=None, batch_size: int = 128):
        """Classification metrics (eval/evaluation.Evaluation) of `output`
        over `data` in `batch_size` rows, mask-aware."""
        from ..eval.evaluation import Evaluation
        return self._evaluate(Evaluation(), data, labels, batch_size)

    def evaluate_regression(self, data, labels=None, batch_size: int = 128):
        """Per-column regression metrics (RegressionEvaluation)."""
        from ..eval.evaluation import RegressionEvaluation
        return self._evaluate(RegressionEvaluation(), data, labels, batch_size)

    def _evaluate(self, ev, data, labels, batch_size: int):
        self._check_init()
        for ds in as_iterator(data, labels, batch_size):
            out = self.output(ds.features, features_mask=ds.features_mask)
            ev.eval(ds.labels, out, mask=ds.labels_mask)
        return ev

    def summary(self) -> str:
        """One line per layer (index, type, parameter count) and the total,
        as the JAX package's `summary()` prints them."""
        lines = ["idx | layer | params"]
        for i, layer in enumerate(self.layers):
            n = (param_utils.num_params(self.params_tree[i])
                 if self._initialized else "?")
            lines.append(f"{i} | {type(layer).__name__} | {n}")
        if self._initialized:
            lines.append(f"Total params: {self.num_params()}")
        return "\n".join(lines)

    # -------------------------------------------------------------- pretrain
    def pretrain(self, data, *, epochs: int = 1, batch_size: int = 32
                 ) -> "MultiLayerNetwork":
        """Greedy layerwise unsupervised pretraining (reference
        MultiLayerNetwork.pretrain(DataSetIterator)): for each pretrainable,
        unfrozen layer in order, `epochs` passes over `data` (a
        DataSetIterator, a DataSet, or a features array cut into
        `batch_size` rows; labels are ignored) stepping that layer by its
        own updater from a fresh state at iteration 0, on the inference-mode
        activations of the layers before it. The noise comes from the
        network's generator. The network's optimizer state and counters are
        not touched; `score_value` is the last step's loss."""
        self._check_init()
        if not isinstance(data, DataSet) and hasattr(data, "shape"):
            data = DataSet(data, np.zeros((data.shape[0], 1), np.float32))
        for i, layer in enumerate(self.layers):
            if not layer.is_pretrainable() or layer.frozen:
                continue
            params_i = self.params_tree[i]
            opt_i = layer.updater.init(params_i)
            iteration, last = 0, None
            for _ in range(epochs):
                for ds in as_iterator(data, None, batch_size):
                    with torch.no_grad():
                        x = self._prefix_activations(i, self._as_input(ds.features))
                    last, grads = layer.pretrain_grads(params_i, x,
                                                       self._dropout_gen)
                    with torch.no_grad():
                        params_i, opt_i = _layer_step(layer, params_i, grads,
                                                      opt_i, iteration)
                    iteration += 1
            if last is not None:
                self.score_value = last
            self.params_tree = tuple(params_i if j == i else p
                                     for j, p in enumerate(self.params_tree))
        return self

    def _prefix_activations(self, i: int, x: Tensor) -> Tensor:
        """The inference-mode input of layer i: layers 0..i-1 on the current
        parameters and layer state, then layer i's preprocessor."""
        a = x
        for j in range(i):
            p = self.conf.preprocessor(j)
            if p is not None:
                a = p(a)
            a, _ = self.layers[j].forward_with_state(
                self.params_tree[j], self.state_tree[j], a)
        p = self.conf.preprocessor(i)
        return a if p is None else p(a)

    # ------------------------------------------------------------- rnn state
    def _seed_recurrent_states(self, batch: int):
        """Start a zero carry for `batch` rows, unless one is running."""
        if self._rnn_carry is None:
            self._rnn_carry = tuple(
                layer.seed_recurrent_state(batch, self._dtype, self.device)
                if layer.is_recurrent() else {} for layer in self.layers)

    def _merged_state(self):
        """The layer state with the carry merged in, where one is running."""
        if self._rnn_carry is None:
            return self.state_tree
        return tuple({**st, **carry}
                     for st, carry in zip(self.state_tree, self._rnn_carry))

    def _commit_state(self, new_state):
        """Take a step's new state: the carry (detached) apart from the
        layer state, where one is running."""
        if self._rnn_carry is None:
            self.state_tree = new_state
            return
        split = [self._split_carry(st) for st in new_state]
        self.state_tree = tuple(st for st, _ in split)
        self._rnn_carry = tuple(c for _, c in split)

    def rnn_time_step(self, x) -> np.ndarray:
        """Streaming inference from the stored carry (reference
        rnnTimeStep()): x is [batch, features] (one step) or [batch, time,
        features]; the carry moves on. Raises NotImplementedError for a
        layer that needs the whole sequence, and RnnStateMismatchError
        (after resetting the carry) for another batch size than the
        carry's."""
        self._check_init()
        self._check_streaming(enumerate(self.layers))
        xa = self._as_input(x)
        self._check_carry_batch(xa.shape[0])
        self._seed_recurrent_states(xa.shape[0])
        with torch.no_grad():
            out, new_state, _ = self._forward(self.params_tree,
                                              self._merged_state(), xa)
        self._commit_state(new_state)
        return _to_numpy(out)
