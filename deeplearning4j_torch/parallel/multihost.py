"""Multi-process training runner: the Spark-driver / TrainingMaster role.

Port of `deeplearning4j_tpu/parallel/multihost.py` (reference dl4j-spark
SparkDl4jMultiLayer.fit and ParameterAveragingTrainingMaster.java:346-357,
:867-896) on `torch.distributed`. Every process runs the same program over
a data-parallel mesh of every process's device; "broadcast" is same-seed
init (or the same checkpoint), "aggregate" is ParallelWrapper's gradient
all-reduce each step (sync) or its parameter average every F steps (local
SGD). This runner adds the process bootstrap, the per-process data
partitioning contract, lockstep guards, chief-only checkpointing and the
cluster health plane.

Launch contract (one process per device, like one Spark executor):

    runner = MultiHostRunner(coordinator_address="host0:1234",
                             num_processes=4, process_id=rank)
    runner.initialize()
    net = MultiLayerNetwork(conf).init(seed=SAME_EVERYWHERE,
                                       device=runner.device)
    runner.fit(net, local_x, local_y, epochs=..., batch_size=...)
    runner.save_checkpoint(net, "model.zip")   # the chief writes

Deliberate differences from the JAX package: the bootstrap is
`torch.distributed.init_process_group` over a TCP store, and its
environment fallbacks are torch's own ``MASTER_ADDR``/``MASTER_PORT``/
``WORLD_SIZE``/``RANK`` (the JAX package reads ``JAX_COORDINATOR_ADDRESS``/
``JAX_NUM_PROCESSES``/``JAX_PROCESS_ID``); the backend is NCCL where every
process of the host has a GPU of its own and gloo otherwise (so several
ranks on one GPU, which NCCL refuses, run over gloo, which all-reduces
CUDA tensors); and the dropout generator's state is kept beside each step
checkpoint (`StepCheckpointManager`), as the JAX package keeps its key.

`main` is the worker entry that spawned ranks run (`python -c "from
deeplearning4j_torch.parallel.multihost import main; ..."`): it trains a
network from a JSON configuration on seeded synthetic data or an npz, and
writes each rank's parameters and timings. Its `--mode tp` and `--mode sp`
train one model axis or one seq ring across the ranks instead
(TensorParallelWrapper, SequenceParallelWrapper; every rank feeds the
identical global batch): the ranks' leaf blocks are all-gathered and the
ring's hops cross them over the process group, host-staged, since gloo has
no CUDA point-to-point; where each rank has a GPU of its own the group is
NCCL (not exercised on a one-card machine).
"""
from __future__ import annotations

import collections
import json
import logging
import os
import pickle
import signal
import sys
import threading
import time
from datetime import timedelta
from typing import List, Optional

import numpy as np
import torch

from ..utils.device import canonical, exact_float32
from . import cluster_health as health_lib
from . import mesh as mesh_lib
from .cluster_health import HealthConfig
from .wrapper import ParallelWrapper

log = logging.getLogger(__name__)

_RNG_SUFFIX = ".rng.pt"


class StepCheckpointManager:
    """Step-numbered checkpoint directory with atomic writes and a
    retention bound, the substrate of auto-resume (beyond the reference,
    which has no elastic recovery). Bare ``checkpoint_step<N>.zip`` files,
    chief-written under cluster barriers, each with its dropout
    generator's state beside it (``.rng.pt``). Distinct from
    `optimize.resilience.CheckpointManager` (manifest, sha256, cadence);
    ``CheckpointManager`` here is the JAX package's old alias."""

    PATTERN = "checkpoint_step%d.zip"

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = int(keep)
        if self.keep < 1:
            raise ValueError("keep must be >= 1, got %d" % self.keep)
        os.makedirs(directory, exist_ok=True)

    def _entries(self):
        import re
        out = []
        for name in os.listdir(self.directory):
            m = re.match(r"^checkpoint_step(\d+)\.zip$", name)
            if m:
                out.append((int(m.group(1)),
                            os.path.join(self.directory, name)))
        return sorted(out)

    def latest(self):
        """(step, path) of the newest checkpoint, or None."""
        entries = self._entries()
        return entries[-1] if entries else None

    def latest_valid(self):
        """(step, path) of the newest checkpoint that passes structural
        validation: a torn newest file (a kill during a copy into the
        directory; the writer itself is atomic) is skipped with a warning
        and a ``checkpoint_corrupt_total`` bump."""
        from ..optimize import resilience
        from ..utils.model_serializer import (CheckpointCorruptError,
                                              validate_checkpoint)
        for step, path in reversed(self._entries()):
            try:
                validate_checkpoint(path, deep=True)
            except CheckpointCorruptError as e:
                resilience._counter("checkpoint_corrupt_total").inc()
                log.warning("skipping torn/corrupt checkpoint %s: %s",
                            path, e)
                continue
            return step, path
        return None

    def save(self, model, step: int) -> str:
        """Atomic write (tmp + rename) of the model and its generator
        state, then the retention prune."""
        from ..utils.model_serializer import save_model
        final = os.path.join(self.directory, self.PATTERN % step)
        gen = getattr(model, "_dropout_gen", None)
        if gen is not None:
            torch.save(gen.get_state(), final + _RNG_SUFFIX + ".tmp")
            os.replace(final + _RNG_SUFFIX + ".tmp", final + _RNG_SUFFIX)
        save_model(model, final + ".tmp")
        os.replace(final + ".tmp", final)
        for _, path in self._entries()[:-self.keep]:
            for p in (path, path + _RNG_SUFFIX):
                try:
                    os.remove(p)
                except OSError:
                    pass
        return final

    def restore_into(self, model) -> Optional[int]:
        """Load the newest valid checkpoint's trees, counters and generator
        state into the caller's model. Returns the step, or None."""
        entry = self.latest_valid()
        if entry is None:
            return None
        step, path = entry
        from ..utils.model_serializer import restore_model
        restored = restore_model(path, device=model.device)
        model.params_tree = restored.params_tree
        model.state_tree = restored.state_tree
        model.opt_state = restored.opt_state
        model.iteration = restored.iteration
        model.epoch = restored.epoch
        if os.path.exists(path + _RNG_SUFFIX):
            model._dropout_gen.set_state(torch.load(path + _RNG_SUFFIX))
        return step


#: The JAX package's older name of StepCheckpointManager.
CheckpointManager = StepCheckpointManager


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


class MultiHostRunner:
    def __init__(self, coordinator_address: Optional[str] = None,
                 num_processes: Optional[int] = None,
                 process_id: Optional[int] = None,
                 auto_detect: bool = False,
                 health: Optional[object] = None,
                 backend: Optional[str] = None,
                 device=None,
                 timeout_s: float = 300.0):
        if coordinator_address is None and os.environ.get("MASTER_ADDR"):
            coordinator_address = "%s:%s" % (
                os.environ["MASTER_ADDR"], os.environ.get("MASTER_PORT", "29500"))
        self.coordinator_address = coordinator_address
        self.num_processes = num_processes if num_processes is not None \
            else _env_int("WORLD_SIZE")
        self.process_id = process_id if process_id is not None \
            else _env_int("RANK")
        self.auto_detect = auto_detect
        self.backend = backend
        self._device = device
        self.timeout_s = float(timeout_s)
        self._initialized = False
        self._mesh = None
        # health=True/HealthConfig arms the plane, None defers to the
        # DL4JTPU_HEARTBEAT variable, False disables it
        if health is False:
            self.health_config: Optional[HealthConfig] = None
        elif isinstance(health, HealthConfig):
            self.health_config = health
        elif health is True or health_lib.health_enabled_from_env():
            self.health_config = HealthConfig.from_env()
        else:
            self.health_config = None
        self._monitor: Optional[health_lib.ClusterHealthMonitor] = None
        self.last_grace_step: Optional[int] = None
        # bounded: wrappers pin their models
        self._wrappers = collections.OrderedDict()
        self._wrapper_cache_size = 4

    def _wrapper_for(self, model, averaging_frequency: int) -> ParallelWrapper:
        key = (id(model), int(averaging_frequency))
        w = self._wrappers.get(key)
        if w is not None and w.model is model:
            self._wrappers.move_to_end(key)
            return w
        w = ParallelWrapper(model, mesh=self.mesh(),
                            averaging_frequency=averaging_frequency)
        self._wrappers[key] = w
        while len(self._wrappers) > self._wrapper_cache_size:
            self._wrappers.popitem(last=False)
        return w

    # ------------------------------------------------------------- bootstrap
    def _pick_backend(self, world: int) -> str:
        if self.backend:
            return self.backend
        local = _env_int("LOCAL_WORLD_SIZE") or world
        if torch.cuda.is_available() and torch.cuda.device_count() >= local:
            return "nccl"
        return "gloo"

    def initialize(self) -> "MultiHostRunner":
        """Join the process group (idempotent): a TCP store at the
        coordinator address, this process's rank and the world size;
        `auto_detect=True` reads torch's own environment (env://)."""
        if self._initialized:
            return self
        dist = torch.distributed
        n = self.num_processes
        if not dist.is_initialized() and ((n is not None and n > 1)
                                          or self.auto_detect):
            if self.auto_detect:
                n = int(os.environ.get("WORLD_SIZE", "1"))
                self.backend = self._pick_backend(n)
                dist.init_process_group(self.backend, init_method="env://",
                                        timeout=timedelta(seconds=self.timeout_s))
            else:
                if not self.coordinator_address:
                    raise ValueError(
                        "a multi-process run needs coordinator_address "
                        "(or MASTER_ADDR/MASTER_PORT)")
                self.backend = self._pick_backend(n)
                dist.init_process_group(
                    self.backend,
                    init_method=f"tcp://{self.coordinator_address}",
                    world_size=n, rank=int(self.process_id),
                    timeout=timedelta(seconds=self.timeout_s))
        if self.backend == "nccl":
            torch.cuda.set_device(self.device)
        self._initialized = True
        log.info("MultiHostRunner: process %d/%d on %s (%s)",
                 self.process_index, self.process_count, self.device,
                 self.backend or "no process group")
        return self

    @property
    def process_index(self) -> int:
        return mesh_lib.process_index()

    @property
    def process_count(self) -> int:
        return mesh_lib.process_count()

    def _device_of(self, rank: int) -> torch.device:
        if torch.cuda.is_available():
            local = _env_int("LOCAL_RANK")
            i = (local if local is not None and rank == self.process_index
                 else rank) % torch.cuda.device_count()
            return torch.device("cuda", i)
        return torch.device("cpu")

    @property
    def device(self) -> torch.device:
        """This process's device (given, or cuda:(local rank % GPUs), or
        the CPU without a GPU)."""
        if self._device is not None:
            return canonical(self._device)
        return self._device_of(self.process_index)

    @property
    def is_chief(self) -> bool:
        """Process 0: the only writer of checkpoints."""
        return self.process_index == 0

    def mesh(self) -> mesh_lib.Mesh:
        """The data-parallel mesh: one shard per process, in rank order."""
        if self._mesh is None:
            self.initialize()
            n = self.process_count
            devs = [self.device if r == self.process_index
                    else self._device_of(r) for r in range(n)]
            self._mesh = mesh_lib.create_mesh([n], (mesh_lib.DATA_AXIS,),
                                              devs, list(range(n)))
        return self._mesh

    def _coll_device(self) -> torch.device:
        return self.device if self.backend == "nccl" else torch.device("cpu")

    # -------------------------------------------------------- cluster health
    def start_health(self, on_failure=None
                     ) -> Optional[health_lib.ClusterHealthMonitor]:
        """Start the heartbeat watchdog (idempotent; a no-op when the plane
        is off or the job has one process). Process 0 hosts the beat
        channel at the coordinator's host on ``health_config.port``
        (default: the coordinator's port + 1)."""
        if self.health_config is None or self.process_count <= 1:
            return None
        if self._monitor is not None:
            return self._monitor
        host, port = self._beat_endpoint()
        if host is None:
            log.warning("cluster health enabled but no coordinator "
                        "address/port to derive the beat channel from; "
                        "set DL4JTPU_HEARTBEAT_PORT — watchdog disabled")
            return None
        transport = health_lib.HttpBeatTransport(
            self.process_index, host, port, chief=self.is_chief)
        self._monitor = health_lib.ClusterHealthMonitor(
            self.process_index, self.process_count, transport,
            config=self.health_config, on_failure=on_failure).start()
        log.info("cluster health watchdog up: beat channel %s "
                 "(interval %.1fs, timeout %.1fs)", transport.url,
                 self.health_config.interval_s, self.health_config.timeout_s)
        return self._monitor

    def stop_health(self) -> None:
        """Stop the watchdog and (on the chief) the beat server."""
        if self._monitor is not None:
            self._monitor.stop()
            self._monitor = None

    def _beat_endpoint(self):
        port = self.health_config.port if self.health_config else None
        addr = self.coordinator_address
        if addr and ":" in addr:
            host, _, coord_port = addr.rpartition(":")
            return host, (port if port else int(coord_port) + 1)
        if addr and port:
            return addr, port
        return (None, None) if not port else ("127.0.0.1", port)

    def _timed(self, fn, name: str):
        """A blocking collective under the health plane's deadline
        (straight through when the plane is off)."""
        cfg = self.health_config
        if cfg is None or not cfg.barrier_timeout_s:
            return fn()
        return health_lib.timed_collective(
            fn, name=name, timeout_s=cfg.barrier_timeout_s,
            monitor=self._monitor)

    def _allgather(self, obj):
        out = [None] * self.process_count
        torch.distributed.all_gather_object(out, obj)
        return out

    # ------------------------------------------------------------- lockstep
    def _assert_lockstep(self, *values: int):
        """Every process must agree on loop bounds, or the collectives
        hang (the Spark analog: TrainingMaster sizes every split alike)."""
        if self.process_count == 1:
            return
        mine = [int(v) for v in values]
        all_vals = self._timed(lambda: self._allgather(mine), "lockstep")
        if any(v != all_vals[0] for v in all_vals):
            raise ValueError(
                f"Processes disagree on batch/epoch counts: {all_vals} — "
                "every process must feed identically-shaped local "
                "partitions (repartition your data)")

    def barrier(self, name: str = "barrier",
                timeout_s: Optional[float] = None):
        """Cluster barrier; with the health plane armed (or an explicit
        `timeout_s`) a bounded wait that raises a typed
        `cluster_health.BarrierTimeoutError` (or the watchdog's diagnosis)
        instead of hanging."""
        if self.process_count <= 1:
            return
        fn = torch.distributed.barrier
        if timeout_s is not None:
            health_lib.timed_collective(fn, name=f"barrier:{name}",
                                        timeout_s=timeout_s,
                                        monitor=self._monitor)
        else:
            self._timed(fn, f"barrier:{name}")

    # ------------------------------------------------------------------- fit
    def fit(self, model, local_features, local_labels=None, *,
            epochs: int = 1, batch_size: int = 32,
            averaging_frequency: int = 1,
            checkpoint_dir: Optional[str] = None,
            checkpoint_every: Optional[int] = None,
            resume: bool = True) -> ParallelWrapper:
        """Train over the mesh; this process contributes its partition
        `local_features`/`local_labels`, so a global batch is batch_size x
        num_processes.

        With `checkpoint_dir` the run checkpoints every `checkpoint_every`
        optimizer steps (the chief writes, between barriers) and a
        restarted job resumes from the newest valid checkpoint, replaying
        the deterministic data order without stepping, so it ends where an
        uninterrupted run ends. With the health plane armed, a dead peer
        ends this process with `PeerLostError` and exit code 17 instead of
        a hang, and SIGTERM stops the whole cluster at one agreed step,
        writes one grace checkpoint and exits 0."""
        wrapper = self._wrapper_for(model, averaging_frequency)
        if hasattr(local_features, "num_examples"):     # DataSet
            n = local_features.num_examples()
        elif hasattr(local_features, "shape"):          # array
            n = np.shape(local_features)[0]
        else:                                           # opaque iterator
            n = -1  # the caller guarantees equal batch counts
        if n >= 0:
            self._assert_lockstep(n, batch_size, epochs)
        else:
            self._assert_lockstep(epochs)
        monitor = self.start_health()
        hook = None
        if monitor is not None:
            hook = monitor.notify_step
            wrapper.step_hooks.append(hook)
        try:
            return self._fit_guarded(wrapper, model, local_features,
                                     local_labels, epochs=epochs,
                                     batch_size=batch_size,
                                     checkpoint_dir=checkpoint_dir,
                                     checkpoint_every=checkpoint_every,
                                     resume=resume, monitor=monitor)
        finally:
            if hook is not None and hook in wrapper.step_hooks:
                wrapper.step_hooks.remove(hook)

    def _await_diagnosis(self, monitor) -> None:
        """After a collective failed (gloo raises when a peer's socket
        closes, where NCCL would hang): wait up to the beat timeout for the
        watchdog's diagnosis, whose default action exits with its code;
        raise it here when the action returned."""
        cfg = self.health_config
        deadline = time.monotonic() + cfg.timeout_s + 4 * cfg.interval_s
        while time.monotonic() < deadline and monitor.failure() is None:
            time.sleep(min(0.1, cfg.interval_s))
        monitor.check()

    def _fit_guarded(self, wrapper, model, local_features, local_labels, *,
                     epochs, batch_size, checkpoint_dir, checkpoint_every,
                     resume, monitor):
        if checkpoint_dir is None and monitor is None:
            wrapper.fit(local_features, local_labels, epochs=epochs,
                        batch_size=batch_size)
            return wrapper
        mgr = StepCheckpointManager(checkpoint_dir) if checkpoint_dir \
            else None
        skip = 0
        if resume and mgr is not None:
            restored = mgr.restore_into(model)
            if restored is not None:
                skip = int(model.iteration)
                # the loop re-runs every epoch, replay-skipping trained
                # batches, so epoch counting restarts with it
                model.epoch = 0
                log.info("resumed from checkpoint step %d", restored)
        self._assert_lockstep(skip)  # every process sees the same files

        def steps_in(ds):
            # optimizer steps one batch takes (tBPTT: one per window)
            from ..nn.conf.builders import BackpropType
            if model.conf.backprop_type != BackpropType.TRUNCATED_BPTT:
                return 1
            feats = getattr(ds, "features", None)
            if feats is None or np.ndim(feats) != 3:
                return 1
            return -(-np.shape(feats)[1] // model.conf.tbptt_fwd_length)

        remaining = [skip]
        grace_flag = [False]    # set by the SIGTERM handler
        calls = [0]
        cfg = self.health_config
        grace_every = max(1, int(cfg.grace_every)) if cfg else 1

        def grace_poll() -> bool:
            """Cluster-wide agreement on the preemption flag, at the same
            cadence on every process (replayed steps included)."""
            local = grace_flag[0] or (monitor is not None
                                      and monitor.grace_requested())
            if self.process_count <= 1:
                return local
            vote = torch.tensor([1 if local else 0], dtype=torch.int32,
                                device=self._coll_device())
            torch.distributed.all_reduce(vote,
                                         op=torch.distributed.ReduceOp.MAX)
            return bool(vote.item())

        def grace_checkpoint():
            step = int(model.iteration)
            log.info("preemption grace: coordinated checkpoint at step %d",
                     step)
            self.barrier("grace-pre-checkpoint")
            if self.is_chief and mgr is not None:
                mgr.save(model, step)
            self.barrier("grace-post-checkpoint")
            health_lib._counter("cluster_grace_checkpoints_total").inc()
            self.last_grace_step = step
            raise health_lib.GraceCheckpointed(step)

        def elastic_step(ds):
            calls[0] += 1
            if calls[0] % grace_every == 0 and grace_poll():
                grace_checkpoint()
            if remaining[0] > 0:
                n = steps_in(ds)  # replay-skip: trained before the restart
                if n > remaining[0]:
                    raise ValueError(
                        "checkpoint iteration falls inside a tBPTT batch's "
                        "window sequence — checkpoints from a different "
                        "batch/window schedule cannot resume this run")
                remaining[0] -= n
                return
            wrapper.fit_batch(ds)
            if monitor is not None:
                # a recorded failure surfaces in the main thread too
                monitor.check()
            if mgr is not None and checkpoint_every and \
                    model.iteration % int(checkpoint_every) == 0:
                self.barrier("pre-checkpoint")
                if self.is_chief:
                    mgr.save(model, int(model.iteration))
                self.barrier("post-checkpoint")

        # SIGTERM -> grace flag, read at the next step boundary (a signal
        # handler can only be installed from the main thread; elsewhere
        # grace still arms through a peer's flag on the beats)
        prev_handler = None
        installed = False
        if threading.current_thread() is threading.main_thread():
            def _on_sigterm(signum, frame):
                grace_flag[0] = True
                if monitor is not None:
                    monitor.request_grace()
            try:
                prev_handler = signal.signal(signal.SIGTERM, _on_sigterm)
                installed = True
            except ValueError:
                pass
        try:
            model.fit(local_features, local_labels, epochs=epochs,
                      batch_size=batch_size, step_fn=elastic_step,
                      use_async=False)
        except health_lib.GraceCheckpointed as g:
            log.info("grace checkpoint written at step %d — exiting 0 for "
                     "the restarter (resume=True picks it up)", g.step)
            self.stop_health()
            raise SystemExit(0)
        except RuntimeError as e:
            if monitor is not None and \
                    not isinstance(e, health_lib.ClusterHealthError):
                self._await_diagnosis(monitor)
            raise
        finally:
            if installed:
                signal.signal(signal.SIGTERM, prev_handler)
        wrapper.finalize()
        return wrapper

    # ------------------------------------------------------------ evaluation
    def evaluate(self, model, local_features, local_labels=None, *,
                 batch_size: int = 128):
        """Every process evaluates its partition; the Evaluations gather
        across the group and merge, and the merged one returns everywhere
        (the reference's evaluation flatmap + reduce)."""
        local = model.evaluate(local_features, local_labels,
                               batch_size=batch_size)
        if self.process_count == 1:
            return local
        merged = None
        for blob in self._allgather(pickle.dumps(local)):
            ev = pickle.loads(blob)
            merged = ev if merged is None else merged.merge(ev)
        return merged

    # --------------------------------------------------------- repartitioning
    @staticmethod
    def balanced_partition(n: int, num_partitions: int, partition: int
                           ) -> slice:
        """Row slice of `partition` under balanced partitioning (reference
        BalancedPartitioner.java: floor(n/P) each, the first n%P one
        more)."""
        if not 0 <= partition < num_partitions:
            raise ValueError(f"partition {partition} not in "
                             f"[0, {num_partitions})")
        base, extra = divmod(n, num_partitions)
        start = partition * base + min(partition, extra)
        return slice(start, start + base + (1 if partition < extra else 0))

    def my_partition(self, *arrays, drop_remainder: bool = True):
        """This process's share of each array's rows. With drop_remainder
        every process gets exactly floor(n/P) rows, which the lockstep
        contract needs (the dropped tail is logged)."""
        P, p = self.process_count, self.process_index
        out = []
        for a in arrays:
            a = np.asarray(a)
            n = a.shape[0]
            if n < P:
                raise ValueError(
                    f"cannot partition {n} rows over {P} processes — every "
                    "process would train on (almost) nothing")
            if drop_remainder:
                per = n // P
                if per * P != n:
                    log.info("my_partition: dropping %d tail rows (%d rows "
                             "over %d processes)", n - per * P, n, P)
                out.append(a[p * per:(p + 1) * per])
            else:
                out.append(a[self.balanced_partition(n, P, p)])
        return out[0] if len(out) == 1 else tuple(out)

    # ------------------------------------------------------------ checkpoint
    def save_checkpoint(self, model, path: str):
        """The chief writes, between barriers (reference: only the Spark
        driver persists)."""
        self.barrier("pre-checkpoint")
        if self.is_chief:
            from ..utils.model_serializer import save_model
            save_model(model, path)
        self.barrier("post-checkpoint")

    def materialize_local(self, model):
        """The model's trees on this process's device, for single-process
        inference after training (every process already holds whole
        trees; this moves them off a shared device if they are not on
        the model's)."""
        from ..utils import params as param_utils
        move = lambda t: param_utils.tree_map(lambda a: a.to(model.device), t)
        model.params_tree = move(model.params_tree)
        model.opt_state = move(model.opt_state)
        model.state_tree = move(model.state_tree)
        return model

    def shutdown(self):
        """Stop the watchdog and leave the process group."""
        self.stop_health()
        dist = torch.distributed
        if dist.is_initialized():
            dist.destroy_process_group()
        self._initialized = False
        self._mesh = None


# ---------------------------------------------------------------------------
# Worker entry
# ---------------------------------------------------------------------------

def _synthetic(conf, n: int, seed: int, dtype=np.float32):
    """n seeded rows of features shaped by the configuration's input type
    and one-hot labels over its output width."""
    from ..nn.multilayer import _input_shape
    shape = _input_shape(conf.input_type, n, None)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(dtype)
    k = conf.layers[-1].n_out
    y = np.eye(k, dtype=np.float32)[rng.integers(0, k, n)]
    return x, y


def _leaves_npz(model) -> dict:
    from ..utils import params as param_utils
    return {f"leaf{i:05d}": param_utils.leaf_to_reference_bits(t)[0]
            for i, t in enumerate(param_utils.tree_leaves(model.params_tree))}


def spawn_rank(process_id: int, num_processes: int, coordinator: str,
               args: List[str], *, env: Optional[dict] = None, **popen_kw):
    """Spawn one rank running `main` (callers SIGKILL or SIGTERM the
    handle for chaos drills); `args` are main's other arguments, `env`
    overlays the child's environment."""
    import subprocess
    cmd = [sys.executable, "-c",
           "import sys; from deeplearning4j_torch.parallel.multihost "
           "import main; sys.exit(main(sys.argv[1:]))",
           "--coordinator", coordinator,
           "--num-processes", str(int(num_processes)),
           "--process-id", str(int(process_id))] + list(args)
    child_env = dict(os.environ)
    child_env.update(env or {})
    return subprocess.Popen(cmd, env=child_env, **popen_kw)


#: Model or seq shards each rank holds in `--mode tp` / `sp`, as each
#: process of the JAX package's multi-host worker contributes two devices.
SHARDS_PER_RANK = 2


def _model_parallel_rank(args, runner, conf, x, y) -> None:
    """One rank of `--mode tp` or `--mode sp`: a ("data" 1, "model" or
    "seq" ranks x local shards) mesh, one `fit_batch` per `--batch-size`
    rows of the whole batch, per epoch. Writes `<out>.<mode>.rank<r>.npz`
    (parameters) and `.json` (iteration, step ms, the cross-process
    transports' ms, the shard report). In tp mode the trees are then
    gathered (`materialize_local`, every rank), the chief writes
    `<out>.tp.zip`, and every rank restores it into `.restored.npz`. With
    `--output` (sp) every rank then answers `output` on the whole batch
    twice, the second timed with its K3 launches and transports counted,
    into `.output.npy`."""
    from ..data.dataset import DataSet
    from ..nn import shards
    from ..nn.multilayer import MultiLayerNetwork
    from ..utils.model_serializer import restore_model
    from .sequence import SequenceParallelWrapper
    from .tensor import TensorParallelWrapper
    n, rank, L = runner.process_count, runner.process_index, SHARDS_PER_RANK
    devices = [runner.device if r == rank else runner._device_of(r)
               for r in range(n) for _ in range(L)]
    axis = mesh_lib.MODEL_AXIS if args.mode == "tp" else mesh_lib.SEQ_AXIS
    mesh = mesh_lib.create_mesh([1, n * L], (mesh_lib.DATA_AXIS, axis), devices,
                                [r for r in range(n) for _ in range(L)])
    net = MultiLayerNetwork(conf.clone()).init(seed=args.seed, device=runner.device)
    wrapper = (TensorParallelWrapper if args.mode == "tp"
               else SequenceParallelWrapper)(net, mesh)
    for k in shards.cross_ms:
        shards.cross_ms[k] = 0.0
    step_ms = []
    b = args.batch_size
    for _ in range(args.epochs):
        for lo in range(0, x.shape[0] - b + 1, b):
            t0 = time.perf_counter()
            wrapper.fit_batch(DataSet(x[lo:lo + b], y[lo:lo + b]))
            if net.device.type == "cuda":
                torch.cuda.synchronize(net.device)
            step_ms.append((time.perf_counter() - t0) * 1000.0)
            print(f"STEP {rank} {net.iteration}", flush=True)
    report = {"iteration": net.iteration, "step_ms": step_ms,
              "cross_ms": dict(shards.cross_ms), "backend": runner.backend,
              "device": str(runner.device), "mesh": list(mesh.dims)}
    base = f"{args.out}.{args.mode}.rank{rank}" if args.out else None
    if args.output:
        from ..ops import flash_attention as fa
        wrapper.output(x)   # warm: the process's first kernels and buffers
        runner.barrier("output")
        before = dict(shards.cross_ms)
        k3 = fa.fwd_launches
        t0 = time.perf_counter()
        out = wrapper.output(x)
        report["output_ms"] = (time.perf_counter() - t0) * 1000.0
        report["output_launches"] = {"flash_fwd": fa.fwd_launches - k3}
        report["output_cross_ms"] = {k: v - before[k]
                                     for k, v in shards.cross_ms.items()}
        if base:
            np.save(base + ".output.npy", out)
    if args.mode == "tp":
        report["shards"] = {k: list(v) for k, v in
                            wrapper.param_shard_report().items()}
        report["shard_bytes"] = wrapper.shard_bytes()
        wrapper.materialize_local()
    if base:
        np.savez(base + ".npz", **_leaves_npz(net))
    if args.mode == "tp" and args.out:
        ckpt = f"{args.out}.tp.zip"
        runner.save_checkpoint(net, ckpt)
        restored = restore_model(ckpt, device=runner.device)
        np.savez(base + ".restored.npz", **_leaves_npz(restored))
        runner.barrier("tp-ckpt-read")
    if base:
        with open(base + ".json", "w") as f:
            json.dump(report, f)
    print(f"DONE {rank} {args.mode} {net.iteration}", flush=True)


def main(argv: Optional[List[str]] = None) -> int:
    """One rank of a multi-process fit of a MultiLayerNetwork: the network
    from a JSON configuration (`--conf`), seeded synthetic data
    (`--rows N --data-seed S`, the global rows; each rank trains on its
    `my_partition`) or an npz with ``x`` and ``y`` (`--data`), then
    `MultiHostRunner.fit` once per `--averaging-frequency` value (a fresh
    network each). Each fit writes `<out>.f<F>.rank<r>.npz` (the
    parameters in the JAX package's layout, leaf order) and `.json`
    (iteration, per-step wall ms, all-reduce ms and the LRN kernels'
    launches). `--crash-at K` makes rank `--crash-rank` SIGKILL itself
    after step K (chaos drills); `--health` arms the cluster health plane;
    `--exact-float32` applies `utils.device.exact_float32(deterministic=
    True)`, to compare runs; each step prints ``STEP <rank> <iteration>``."""
    import argparse
    p = argparse.ArgumentParser(description="deeplearning4j_torch "
                                "multi-process training rank")
    p.add_argument("--coordinator", required=True, help="host:port")
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--conf", required=True, help="network JSON file")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--rows", type=int, default=0)
    p.add_argument("--data-seed", type=int, default=0)
    p.add_argument("--data", default=None)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--batch-size", type=int, required=True,
                   help="rows per process per step")
    p.add_argument("--averaging-frequency", default="1",
                   help="comma-separated; one fit each")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=None)
    p.add_argument("--device", default=None)
    p.add_argument("--backend", default=None)
    p.add_argument("--health", action="store_true")
    p.add_argument("--exact-float32", action="store_true",
                   help="utils.device.exact_float32(deterministic=True): no "
                        "TF32, bfloat16 products reduced in float32, cuDNN's "
                        "deterministic algorithms (to compare runs)")
    p.add_argument("--mode", choices=("dp", "tp", "sp"), default="dp",
                   help="dp: ParallelWrapper over a data axis of the ranks; tp "
                        "/ sp: one model axis / one seq ring across the ranks, "
                        "every rank fed the whole batch (--batch-size rows)")
    p.add_argument("--output", action="store_true",
                   help="sp: after the fit, answer `output` on the whole "
                        "batch through the wrapper (every rank the whole "
                        "output) into <out>.sp.rank<r>.output.npy; the "
                        "second of two calls' wall ms and K3 launches go "
                        "in the report")
    p.add_argument("--crash-at", type=int, default=-1)
    p.add_argument("--crash-rank", type=int, default=1)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    from ..nn.conf.builders import MultiLayerConfiguration
    from ..nn.multilayer import MultiLayerNetwork
    from ..ops import lrn as lrn_ops
    with open(args.conf) as f:
        conf = MultiLayerConfiguration.from_json(f.read())
    if args.exact_float32:
        exact_float32(deterministic=True)
    health = HealthConfig.from_env() if args.health else False
    runner = MultiHostRunner(args.coordinator, args.num_processes,
                             args.process_id, health=health,
                             backend=args.backend, device=args.device)
    runner.initialize()
    rank = runner.process_index
    if args.data:
        with np.load(args.data) as z:
            x, y = z["x"], z["y"]
    else:
        x, y = _synthetic(conf, args.rows, args.data_seed)
    if args.mode != "dp":
        _model_parallel_rank(args, runner, conf, x, y)
        runner.shutdown()
        return 0
    lx, ly = runner.my_partition(x, y)

    for freq in [int(f) for f in args.averaging_frequency.split(",")]:
        net = MultiLayerNetwork(conf.clone()).init(seed=args.seed,
                                                   device=runner.device)
        wrapper = runner._wrapper_for(net, freq)
        step_ms: List[float] = []
        allreduce_ms: List[float] = []
        last = [time.perf_counter()]

        class _Report:
            def iteration_done(self, model, iteration):
                if model.device.type == "cuda":
                    torch.cuda.synchronize(model.device)
                now = time.perf_counter()
                step_ms.append((now - last[0]) * 1000.0)
                allreduce_ms.append(wrapper.last_allreduce_ms)
                last[0] = now
                print(f"STEP {rank} {iteration}", flush=True)
                if iteration == args.crash_at and rank == args.crash_rank:
                    print(f"CRASHING {rank} at {iteration}", flush=True)
                    os.kill(os.getpid(), signal.SIGKILL)

        net.set_listeners(_Report())
        k0 = (lrn_ops.launches, lrn_ops.bwd_launches)
        runner.fit(net, lx, ly, epochs=args.epochs,
                   batch_size=args.batch_size, averaging_frequency=freq,
                   checkpoint_dir=args.checkpoint_dir,
                   checkpoint_every=args.checkpoint_every)
        if args.out:
            base = f"{args.out}.f{freq}.rank{rank}"
            np.savez(base + ".npz", **_leaves_npz(net))
            with open(base + ".json", "w") as f:
                json.dump({"iteration": net.iteration, "epoch": net.epoch,
                           "step_ms": step_ms, "allreduce_ms": allreduce_ms,
                           "launches": {"lrn_fwd": lrn_ops.launches - k0[0],
                                        "lrn_bwd": lrn_ops.bwd_launches - k0[1]},
                           "backend": runner.backend,
                           "device": str(runner.device)}, f)
        print(f"DONE {rank} f{freq} {net.iteration}", flush=True)
    runner.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
