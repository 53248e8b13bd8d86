"""Training listeners.

Port of `deeplearning4j_tpu/optimize/listeners.py`. Reference parity: optimize/api/{IterationListener,TrainingListener}.java SPI
and impls in optimize/listeners/: ScoreIterationListener,
PerformanceListener (samples/sec, batches/sec, ETL time),
CollectScoresIterationListener, EvaluativeListener,
ComposableIterationListener, plus CheckpointListener-style periodic saving.

The contract: networks call `iteration_done(model, iteration)` after every
optimizer step and `on_epoch_end(model, epoch)` per epoch — same hook points
as the reference's Solver loop (StochasticGradientDescent.java:80).
"""
from __future__ import annotations

import logging
import time
from typing import Callable, List, Optional, Tuple

log = logging.getLogger("deeplearning4j_torch.listeners")


class IterationListener:
    """Base SPI (reference optimize/api/IterationListener.java)."""

    def iteration_done(self, model, iteration: int) -> None:
        pass

    def on_epoch_end(self, model, epoch: int) -> None:
        pass


class ScoreIterationListener(IterationListener):
    """Log score every N iterations (reference ScoreIterationListener)."""

    def __init__(self, print_iterations: int = 10, printer=None):
        self.n = max(1, int(print_iterations))
        self._printer = printer or (lambda msg: log.info("%s", msg))

    def iteration_done(self, model, iteration):
        if iteration % self.n == 0:
            self._printer(
                f"Score at iteration {iteration} is "
                # deliberate rate-limited sync: printing IS the read
                f"{float(model.score_value):.6f}")  # jaxlint: disable=JL101


class PerformanceListener(IterationListener):
    """Throughput reporting (reference PerformanceListener: samples/sec,
    batches/sec, iteration wall time). NB: fetches the score each report,
    which waits for the card's queue to drain: frequency matters.

    Beyond the reference: the ETL stall splits into host-wait vs
    h2d-wait when the device prefetcher is active. The ETL numbers come
    FROM the model, never recomputed here, and every report writes
    throughput + score back INTO the metrics registry, so a scrape and
    this log line can never disagree. Unlike the JAX package's, a report
    carries no compile count: torch runs eagerly and compiles nothing per
    shape.

    `fence=False` skips the score fetch: timings are then DISPATCH-SIDE
    only (CUDA launches return before the card finishes), but the
    listener adds no synchronization."""

    def __init__(self, frequency: int = 10, report_samples: bool = True,
                 printer=None, fence: bool = True):
        self.frequency = max(1, int(frequency))
        self.report_samples = report_samples
        self.fence = bool(fence)
        self._printer = printer or (lambda msg: log.info("%s", msg))
        self._last_time: Optional[float] = None
        self._last_iter: Optional[int] = None
        self._last_batch_size: Optional[int] = None

    def set_batch_size(self, n: int):
        self._last_batch_size = int(n)

    def iteration_done(self, model, iteration):
        if iteration % self.frequency != 0:
            return
        from .metrics import registry
        reg = registry()
        if self.fence:
            # fence: measure real device time, and publish the score
            # (the registry's train_score only updates on fenced reads;
            # nothing else may sync the card's queue)
            reg.gauge("train_score",
                      "Loss at the last fenced report").set(
                          float(model.score_value))  # jaxlint: disable=JL101
        now = time.perf_counter()
        if self._last_time is not None and iteration > self._last_iter:
            dt = now - self._last_time
            iters = iteration - self._last_iter
            msg = (f"iteration {iteration}: {iters / dt:.2f} batches/sec, "
                   f"{dt / iters * 1000:.1f} ms/iter")
            reg.gauge("train_batches_per_sec",
                      "Throughput at the last report").set(iters / dt)
            reg.gauge("train_ms_per_iter",
                      "Wall ms per optimizer step at the last report"
                      ).set(dt / iters * 1000)
            if self.report_samples and self._last_batch_size:
                sps = iters * self._last_batch_size / dt
                msg += f", {sps:.1f} samples/sec"
                reg.gauge("train_samples_per_sec",
                          "Example throughput at the last report"
                          ).set(sps)
            etl = getattr(model, "last_etl_ms", None)
            if etl is not None:
                msg += f", etl {etl:.2f} ms"
                host = getattr(model, "last_etl_host_ms", None)
                h2d = getattr(model, "last_etl_h2d_ms", None)
                if host is not None and h2d is not None:
                    msg += f" (host {host:.2f} ms, h2d {h2d:.2f} ms)"
            if not self.fence:
                msg += " [dispatch-side]"
            self._printer(msg)
        self._last_time = now
        self._last_iter = iteration


class ParamAndGradientIterationListener(IterationListener):
    """Per-iteration parameter/update magnitude logging (reference
    optimize/listeners/ParamAndGradientIterationListener.java:30:
    mean / min / max / mean-abs of every parameter tensor and its
    gradient, tab-delimited to console and/or file).

    As in the JAX package, the gradients are consumed inside the step, so
    the observable per-iteration signal is the applied UPDATE
    (param_new - param_old = -lr-scaled gradient): the same debugging role
    (exploding/vanishing detection), one subtraction instead of a second
    backward pass. Columns: <param>.{p,u}.{mean,absmean,min,max}."""

    def __init__(self, frequency: int = 1, print_header: bool = True,
                 print_mean: bool = True, print_min_max: bool = True,
                 print_mean_abs: bool = True,
                 output_to_console: bool = False,
                 file_path: Optional[str] = None, delimiter: str = "\t",
                 printer: Optional[Callable[[str], None]] = None):
        self.frequency = max(1, int(frequency))
        self.print_header = print_header
        self.print_mean = print_mean
        self.print_min_max = print_min_max
        self.print_mean_abs = print_mean_abs
        self.output_to_console = output_to_console
        self.file_path = file_path
        self.delimiter = delimiter
        self.printer = printer
        self._prev = None
        self._wrote_header = False

    @staticmethod
    def _named_params(model):
        from ..utils.params import params_to_numpy
        tree = params_to_numpy(model.params_tree)
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        for lname, pdict in items:
            for pname, arr in pdict.items():
                yield f"{lname}_{pname}", arr

    def _stats(self, name, arr):
        import numpy as np
        out = []
        if self.print_mean:
            out.append((f"{name}.mean", float(arr.mean())))
        if self.print_mean_abs:
            out.append((f"{name}.absmean", float(np.abs(arr).mean())))
        if self.print_min_max:
            out.append((f"{name}.min", float(arr.min())))
            out.append((f"{name}.max", float(arr.max())))
        return out

    def _emit(self, line: str):
        if self.printer is not None:
            self.printer(line)
        elif self.output_to_console:
            print(line)
        if self.file_path:
            try:
                with open(self.file_path, "a") as f:
                    f.write(line + "\n")
            except OSError as e:  # reference caps write-failure logging
                log.warning("ParamAndGradient write failed: %s", e)
                self.file_path = None

    def iteration_done(self, model, iteration):
        import numpy as np
        report = iteration % self.frequency == 0
        # A device->host param snapshot costs a full transfer + sync, so
        # take one ONLY when this iteration reports or the NEXT one will
        # (it needs a previous snapshot for the update columns).
        if not report and (iteration + 1) % self.frequency != 0:
            self._prev = None
            return
        current = list(self._named_params(model))
        prev, self._prev = self._prev, {n: a for n, a in current}
        if not report:
            return
        cols = [("iteration", float(iteration)),
                ("score", float(model.score_value))]
        for name, arr in current:
            cols.extend(self._stats(name + ".p", arr))
            # first iteration has no previous params: update = 0, keeping
            # every row the same width as the header
            upd = arr - prev[name] if prev is not None and name in prev \
                else np.zeros_like(arr)
            cols.extend(self._stats(name + ".u", upd))
        if self.print_header and not self._wrote_header:
            self._emit(self.delimiter.join(n for n, _ in cols))
            self._wrote_header = True
        self._emit(self.delimiter.join(repr(v) for _, v in cols))


class CollectScoresIterationListener(IterationListener):
    """Accumulate (iteration, score) pairs (reference
    CollectScoresIterationListener).

    The callback stores the raw device scalar: a ``float()`` here would
    wait for the card's queue on every collected iteration, stalling the
    step pipeline. Conversion to host floats happens lazily on the first
    read of :attr:`scores`: one wait for the whole batch of pending
    values, normally after fit returns.
    """

    def __init__(self, frequency: int = 1):
        self.frequency = max(1, int(frequency))
        self._raw = []
        self._scores: List[Tuple[int, float]] = []

    def iteration_done(self, model, iteration):
        if iteration % self.frequency == 0:
            self._raw.append((iteration, model.score_value))

    @property
    def scores(self) -> List[Tuple[int, float]]:
        if self._raw:
            pending, self._raw = self._raw, []
            self._scores.extend((i, float(s)) for i, s in pending)
        return self._scores


class EvaluativeListener(IterationListener):
    """Periodic evaluation against a held-out set (reference
    EvaluativeListener; invocation per N iterations or per epoch)."""

    def __init__(self, data, labels=None, frequency: int = 0,
                 each_epoch: bool = True, callback=None):
        self.data = data
        self.labels = labels
        self.frequency = int(frequency)
        self.each_epoch = each_epoch
        self.callback = callback
        self.evaluations = []

    def _evaluate(self, model):
        ev = model.evaluate(self.data, self.labels)
        self.evaluations.append(ev)
        if self.callback is not None:
            self.callback(model, ev)
        else:
            log.info("Evaluation: accuracy=%.4f f1=%.4f", ev.accuracy(),
                     ev.f1())

    def iteration_done(self, model, iteration):
        if self.frequency > 0 and iteration % self.frequency == 0:
            self._evaluate(model)

    def on_epoch_end(self, model, epoch):
        if self.each_epoch:
            self._evaluate(model)


class ComposableIterationListener(IterationListener):
    """Fan-out to several listeners (reference
    ComposableIterationListener)."""

    def __init__(self, *listeners: IterationListener):
        self.listeners = list(listeners)

    def iteration_done(self, model, iteration):
        for l in self.listeners:
            l.iteration_done(model, iteration)

    def on_epoch_end(self, model, epoch):
        for l in self.listeners:
            l.on_epoch_end(model, epoch)


class CheckpointListener(IterationListener):
    """Periodic checkpointing (reference CheckpointListener semantics:
    every N iterations or every N epochs, keep last K).

    Two modes: the classic `directory` mode writes bare
    ``checkpoint_{tag}.zip`` files (atomic via save_model's tmp+rename
    path) with simple keep-last pruning; passing ``manager=`` (a
    resilience.CheckpointManager) instead delegates cadence, manifest,
    checksums, and retention to the manager: the crash-safe, resumable
    format. With a manager, the every_n/keep_last
    args are ignored (the manager carries its own). Note the listener
    counts iteration_done events as "batches"; under truncated BPTT that
    over-counts windows — resume through fit(checkpoint=) counts true
    batches."""

    def __init__(self, directory: Optional[str] = None,
                 every_n_iterations: int = 0,
                 every_n_epochs: int = 0, keep_last: int = 3,
                 manager=None):
        import os
        if (directory is None) == (manager is None):
            raise ValueError("pass exactly one of directory= or manager=")
        self.manager = manager
        self.dir = directory if manager is None else manager.directory
        if manager is None:
            os.makedirs(directory, exist_ok=True)
        self.every_n_iterations = int(every_n_iterations)
        self.every_n_epochs = int(every_n_epochs)
        self.keep_last = int(keep_last)
        self.saved: List[str] = []
        self._batches_into_epoch = 0

    def _save(self, model, tag: str):
        import os
        from ..utils.model_serializer import save_model
        path = os.path.join(self.dir, f"checkpoint_{tag}.zip")
        save_model(model, path)
        self.saved.append(path)
        while len(self.saved) > self.keep_last:
            old = self.saved.pop(0)
            try:
                os.remove(old)
            except OSError:
                pass

    def iteration_done(self, model, iteration):
        if self.manager is not None:
            self._batches_into_epoch += 1
            self.manager.on_batch(model, self._batches_into_epoch)
            return
        if self.every_n_iterations > 0 and \
                iteration % self.every_n_iterations == 0:
            self._save(model, f"iter_{iteration}")

    def on_epoch_end(self, model, epoch):
        if self.manager is not None:
            self._batches_into_epoch = 0
            self.manager.on_epoch(model)
            return
        if self.every_n_epochs > 0 and epoch % self.every_n_epochs == 0:
            self._save(model, f"epoch_{epoch}")
