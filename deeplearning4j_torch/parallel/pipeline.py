"""PipelineParallelWrapper: GPipe-style microbatched pipeline parallelism
over a mesh's "stage" axis.

Port of `deeplearning4j_tpu/parallel/pipeline.py`, with the same scope and
the same refusals (`_validate_layers`): the body of a MultiLayerNetwork,
S x k identical layers with n_in == n_out and no dropout, recurrent state,
layer state, per-layer gradient normalization or preprocessor, splits into
S stages of k layers; the output layer runs on the last stage. Each stage's
layers, with their updater state, live on the stage's device between
steps (`_place_model`). A step cuts the batch into M microbatches and runs
the GPipe schedule: at tick t (M + S - 1 of them) stage s works on
microbatch t - s, the activation moving to stage s + 1's device for the
next tick. The loss is the mean of the M microbatch means plus the
regularization of every parameter, one backward runs the schedule in
reverse, and the network's own update (frozen layers kept) runs where each
layer lives. Equal microbatches make the mean of means the batch mean, so a
step is the single-device step up to float32 reassociation.

Deliberate difference from the JAX package: its one SPMD program runs every
stage at every tick and masks the bubble's (S - 1) / (M + S - 1) idle
slots; here a stage runs only the ticks that carry a microbatch, which is
the same function.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..optimize import metrics as metrics_mod
from ..utils import params as param_utils
from . import mesh as mesh_lib
from .tensor import _devices_arg

Tensor = torch.Tensor


def pipeline_mesh(stages: Optional[int] = None, devices=None) -> mesh_lib.Mesh:
    """A ("stage",) mesh. Default: every device is one stage."""
    devices, procs = _devices_arg(devices)
    if stages is None:
        stages = len(devices)
    return mesh_lib.create_mesh([stages], (mesh_lib.STAGE_AXIS,), devices, procs)


class PipelineParallelWrapper:
    """Train a MultiLayerNetwork of S*k identical body layers + an output
    layer with the body split into S pipeline stages of k layers each,
    microbatched GPipe-style."""

    def __init__(self, model, mesh: Optional[mesh_lib.Mesh] = None,
                 n_microbatches: int = 4):
        self.model = model
        self.mesh = mesh if mesh is not None else pipeline_mesh()
        if mesh_lib.STAGE_AXIS not in self.mesh.axis_names:
            raise ValueError(
                f"PipelineParallelWrapper needs a mesh with a "
                f"'{mesh_lib.STAGE_AXIS}' axis; got {self.mesh.axis_names}")
        if mesh_lib.is_multiprocess(self.mesh):
            raise NotImplementedError("pipeline stages run in one process")
        self.stages = self.mesh.axis_size(mesh_lib.STAGE_AXIS)
        self.n_microbatches = int(n_microbatches)
        if self.n_microbatches < 1:
            raise ValueError("n_microbatches must be >= 1")
        self._validate_layers()
        self._placed = False

    # -------------------------------------------------------------- validate
    def _validate_layers(self):
        net = self.model
        if hasattr(net, "_pack"):
            raise NotImplementedError(
                "pipeline parallelism supports MultiLayerNetwork (the "
                "homogeneous-stack shape); ComputationGraph DAGs do not "
                "split into uniform SPMD stages")
        layers = net.layers
        if len(layers) < 2 or not layers[-1].is_output_layer():
            raise ValueError("need >= 1 body layer + an output layer")
        body = layers[:-1]
        if len(body) % self.stages:
            raise ValueError(
                f"{len(body)} body layers do not divide {self.stages} "
                f"stages")
        from ..utils import serde
        ref = serde.to_json(body[0])
        for i, l in enumerate(body[1:], 1):
            if serde.to_json(l) != ref:
                raise ValueError(
                    f"body layer {i} differs from layer 0 — the pipeline "
                    f"body must be IDENTICAL layers (got a heterogeneous "
                    f"stack; use TP/DP/SP for those)")
        # stateful layers first: they may lack n_in/n_out (BatchNormalization)
        for i, l in enumerate(layers):
            if l.init_state(torch.float32):
                raise ValueError(
                    f"layer {i} is stateful (non-empty init_state, e.g. "
                    f"batch-norm running statistics); stage_apply drops "
                    f"returned state, so its updates would be silently "
                    f"lost — stateful layers are unsupported under "
                    f"pipeline parallelism")
        l0 = body[0]
        if l0.n_in != l0.n_out:
            raise ValueError(
                f"body layers need n_in == n_out to chain across stages "
                f"(got {l0.n_in}->{l0.n_out})")
        from ..nn.updaters import GradientNormalization
        for i, l in enumerate(layers):
            if getattr(l, "dropout_rate", 0):
                raise ValueError(
                    f"layer {i} has dropout; the microbatch schedule "
                    f"cannot reproduce the single-batch dropout draw — "
                    f"disable dropout under pipeline parallelism")
            if l.is_recurrent():
                raise ValueError(
                    f"layer {i} is recurrent; carried state does not "
                    f"split across microbatches")
            if i < len(layers) - 1 and l.gradient_normalization not in (
                    None, GradientNormalization.NONE):
                raise ValueError(
                    f"body layer {i} uses per-layer gradient "
                    f"normalization, which would mix stages on the "
                    f"stacked gradient")
            if net.conf.preprocessor(i) is not None:
                raise ValueError(
                    f"input preprocessor at layer {i} breaks stage "
                    f"uniformity")
        self.k = len(body) // self.stages

    # ----------------------------------------------------------------- place
    def _stage_device(self, s: int) -> torch.device:
        return self.mesh.devices[self.mesh.position(**{mesh_lib.STAGE_AXIS: s})]

    def _layer_device(self, i: int) -> torch.device:
        """Body layer i's stage device; the output layer's is the last
        stage's."""
        return self._stage_device(min(i // self.k, self.stages - 1))

    def _move(self, device_of):
        net = self.model
        move = lambda i, tree: param_utils.tree_map(
            lambda t: t.to(device_of(i)) if isinstance(t, Tensor) else t, tree)
        net.params_tree = tuple(move(i, p) for i, p in enumerate(net.params_tree))
        net.opt_state = tuple(move(i, o) for i, o in enumerate(net.opt_state))

    def _place_model(self):
        """Each layer's parameters and updater state onto its stage's
        device."""
        self._move(self._layer_device)
        self._placed = True

    # ------------------------------------------------------------------ step
    def _loss(self, params, x_mb, y_mb):
        """The GPipe schedule's loss: the mean of the microbatch means of
        the output layer's score, plus the regularization of every
        parameter (each layer's term on its own device, summed on the last
        stage's)."""
        net = self.model
        S, k, M = self.stages, self.k, self.n_microbatches
        layers, out_layer = net.layers, net.layers[-1]
        n = len(layers)
        last = self._stage_device(S - 1)
        acts = {}   # microbatch -> activation entering its next stage
        scores = []
        for t in range(M + S - 1):
            for s in range(S):
                m = t - s
                if not 0 <= m < M:
                    continue   # the bubble: this stage idles at this tick
                dev = self._stage_device(s)
                h = (x_mb[m] if s == 0 else acts[m]).to(dev)
                for j in range(k):
                    i = s * k + j
                    h, _ = layers[i].forward_with_state(params[i], {}, h,
                                                        train=True)
                if s == S - 1:
                    scores.append(out_layer.compute_score(
                        params[n - 1], h.to(last), y_mb[m].to(last), None))
                else:
                    acts[m] = h
        from ..nn.multilayer import _regularization_score
        reg = 0.0
        for i, layer in enumerate(layers):
            r = _regularization_score([layer], [params[i]])
            reg = reg + (r.to(last) if isinstance(r, Tensor) else r)
        return torch.stack(scores).sum() / M + reg

    def fit_batch(self, ds) -> None:
        """One GPipe-scheduled optimizer step on one DataSet batch (the
        batch must divide n_microbatches; masks unsupported — the
        per-microbatch mean-loss recombination requires uniform
        denominators)."""
        net = self.model
        net._check_init()
        if not self._placed:
            self._place_model()
        if ds.features_mask is not None or ds.labels_mask is not None:
            raise NotImplementedError(
                "masks are unsupported under pipeline parallelism "
                "(non-uniform loss denominators break microbatch "
                "recombination)")
        M = self.n_microbatches
        n = np.shape(ds.features)[0] if not isinstance(ds.features, Tensor) \
            else ds.features.shape[0]
        if n % M:
            raise ValueError(f"batch {n} must divide {M} microbatches")
        x = net._as_input(ds.features)
        y = net._as_labels(ds.labels)
        x_mb, y_mb = x.chunk(M), y.chunk(M)
        leaves = tuple({name: t.detach().requires_grad_() for name, t in lp.items()}
                       for lp in net.params_tree)
        flat = [t for lp in leaves for t in lp.values()]
        with torch.enable_grad():
            loss = self._loss(leaves, x_mb, y_mb)
        grads = torch.autograd.grad(loss, flat, allow_unused=True) if flat else ()
        it = iter([torch.zeros_like(t) if g is None else g
                   for g, t in zip(grads, flat)])
        grad_tree = tuple({name: next(it) for name in lp} for lp in leaves)
        net._apply_step(loss.detach(), grad_tree, net.state_tree)
        metrics_mod.registry().counter(
            "pipeline_steps_total",
            "GPipe-scheduled optimizer steps (stage/microbatch-labeled)"
            ).labels(stages=str(self.stages),
                     microbatches=str(self.n_microbatches)).inc()
        metrics_mod.record_train_step(1)
        for lst in net.listeners:
            lst.iteration_done(net, net.iteration)

    def fit(self, data, labels=None, *, epochs: int = 1,
            batch_size: int = 128) -> "PipelineParallelWrapper":
        """Epoch loop. Indivisible batches are refused before any step:
        every batch, the tail included, must divide n_microbatches (pad rows
        would train for real in the schedule)."""
        self.model._check_init()
        M = self.n_microbatches
        if batch_size % M:
            raise ValueError(
                f"batch_size {batch_size} must divide {M} microbatches")
        try:
            feats = data.features if hasattr(data, "features") else data
            n = np.shape(feats)[0]
        except Exception:
            n = None  # iterator input: checked per batch
        if n is not None:
            tail = n % batch_size
            if tail and tail % M:
                raise ValueError(
                    f"final batch of {tail} examples does not divide "
                    f"{M} microbatches; choose a batch size so every "
                    f"batch (incl. the tail) divides, or repartition")
            if hasattr(data, "features_mask") and (
                    data.features_mask is not None
                    or data.labels_mask is not None):
                raise NotImplementedError(
                    "masks are unsupported under pipeline parallelism")
        self.model.fit(data, labels, epochs=epochs, batch_size=batch_size,
                       step_fn=self.fit_batch, pad_to_bucket=False,
                       prefetch_to_device=False)
        return self

    # -------------------------------------------------------------- evidence
    def bubble_fraction(self) -> float:
        """(S - 1) / (M + S - 1): the share of the schedule's stage-ticks
        that idle."""
        S, M = self.stages, self.n_microbatches
        return (S - 1) / (M + S - 1)

    def stage_shard_report(self) -> dict:
        """{"layer.param": ("stage", stage index, device)} of every body
        parameter: the evidence that the body lives stage by stage."""
        if not self._placed:
            self._place_model()
        net = self.model
        return {f"{i}.{name}": (mesh_lib.STAGE_AXIS, i // self.k, str(t.device))
                for i in range(len(net.layers) - 1)
                for name, t in net.params_tree[i].items()}

    def stage_bytes(self) -> list:
        """Bytes of parameters and updater state each stage's device holds
        between steps (the output layer on the last stage)."""
        if not self._placed:
            self._place_model()
        net = self.model
        out = [0] * self.stages
        for i in range(len(net.layers)):
            out[min(i // self.k, self.stages - 1)] += sum(
                t.numel() * t.element_size() for t in param_utils.tree_leaves(
                    (net.params_tree[i], net.opt_state[i])) if isinstance(t, Tensor))
        return out

    def materialize_local(self) -> None:
        """Every layer's parameters and updater state back on the network's
        device, so save / inference / plain fit work; the next fit_batch
        places them again."""
        self._move(lambda i: self.model.device)
        self._placed = False
