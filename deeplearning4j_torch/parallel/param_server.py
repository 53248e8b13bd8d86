"""Asynchronous parameter-server data parallelism.

Port of `deeplearning4j_tpu/parallel/param_server.py` (reference
parallelism/parameterserver/ParameterServerTrainer{,Context}.java:43-66):
workers pull parameters, compute a gradient and push it, with no barrier
between workers, and the server applies each push through the model's own
updater chain (gradient normalization included) the moment it arrives.

The server is an in-process parameter host on one device, its transport a
lock; worker threads each own a device (several may share one, the
reference's threads-per-GPU knob). Python threads work because the hot
parts, the forward and backward on the device and the server's update,
run in torch kernels that release the GIL.

Staleness: a push carries the version it was computed at. The server
applies it only if ``current - version <= max_staleness`` and drops it
otherwise (the worker re-pulls and redoes it): bounded-staleness async
SGD. ``max_staleness=0`` applies only gradients of the newest parameters.

Each worker draws dropout from its own generator: worker 0 continues the
network's own stream and worker w > 0 one seeded from the network's seed
and w, so one worker at ``max_staleness=0`` is the network's sequential
`fit`, step for step.

`ParameterServerHttpNode`, `HttpParameterServerClient` and
`remote_worker_fit` carry the same protocol across processes over the
port's JSON HTTP server; parameters and gradients travel as npz in the
JAX package's layout (utils/model_serializer.py), so either package's
client can talk to either package's node.
"""
from __future__ import annotations

import base64
import json
import logging
import queue
import threading
import time
import urllib.request
from typing import List, Optional

import numpy as np
import torch

from ..data.dataset import MultiDataSet
from ..data.iterators import as_iterator
from ..nn.multilayer import _layer_step
from ..optimize import metrics as metrics_mod
from ..optimize import resilience
from ..utils import faults
from ..utils import params as param_utils
from ..utils.device import canonical
from ..utils.http_server import JsonHttpServer
from ..utils.model_serializer import _npz_bytes_to_tree, _tree_to_npz_bytes

log = logging.getLogger(__name__)


def _worker_failure(errors: list) -> RuntimeError:
    """Every collected worker error in one exception message."""
    msgs = "; ".join(f"[worker error {i}] {type(e).__name__}: {e}"
                     for i, e in enumerate(errors))
    return RuntimeError(
        f"parameter-server worker failed ({len(errors)} error(s)): {msgs}")


def _layer_map(net):
    """(key, layer) pairs addressing the net's trees: indices of a
    MultiLayerNetwork, node names of a ComputationGraph."""
    if hasattr(net, "layers"):
        return list(enumerate(net.layers))
    return [(name, net.conf.nodes[name].layer) for name in net._layer_nodes]


def _reject_stateful(net):
    states = (net.state_tree.values() if isinstance(net.state_tree, dict)
              else net.state_tree)
    if any(len(st) for st in states):
        # BN running statistics have no owner under asynchronous updates
        # (whose statistics win?): the sync paths commit state, this
        # one cannot
        raise NotImplementedError(
            "async parameter-server training does not support stateful "
            "layers (e.g. BatchNormalization running statistics); use "
            "ParallelWrapper")


def _to(tree, device: torch.device):
    return param_utils.tree_map(lambda t: t.to(device), tree)


def loss_and_grads(net, params, state, data, generator):
    """(loss, gradients) of the network's training loss at `params`
    (any device), the layer state left as it is."""
    leaves = param_utils.tree_map(lambda t: t.detach().requires_grad_(),
                                  params)
    flat = param_utils.tree_leaves(leaves)
    with torch.enable_grad():
        loss, _ = net._loss(leaves, state, *data, True, generator)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for g, t in zip(grads, flat)]
    return loss.detach(), param_utils.tree_unflatten(leaves, grads)


class ParameterServer:
    """In-process parameter host (ParameterServerNode role)."""

    def __init__(self, net, max_staleness: int = 2,
                 device: Optional[torch.device] = None):
        self._net = net
        self.device = canonical(device if device is not None
                                else net.device)
        self.max_staleness = int(max_staleness)
        self._lock = threading.Lock()
        self.version = 0
        self.stale_drops = 0
        self.applied = 0
        self.params = _to(net.params_tree, self.device)
        self.opt_state = _to(net.opt_state, self.device)
        self._entries = _layer_map(net)

    def _apply(self, grads):
        out = {key: _layer_step(layer, self.params[key], grads[key],
                                self.opt_state[key], self.version)
               for key, layer in self._entries}
        if isinstance(self.params, dict):
            return ({k: p for k, (p, _) in out.items()},
                    {k: o for k, (_, o) in out.items()})
        n = len(self._entries)
        return (tuple(out[i][0] for i in range(n)),
                tuple(out[i][1] for i in range(n)))

    def pull(self, device: Optional[torch.device] = None):
        """Current (version, params), the parameters copied to the
        worker's device (the ParameterServerClient.getParams round trip).
        The server replaces its trees on every push, never writes into
        them, so a pulled tree stays valid under later pushes."""
        with self._lock:
            params, version = self.params, self.version
        if device is not None and canonical(device) != self.device:
            params = _to(params, canonical(device))
        return version, params

    def push(self, version: int, grads) -> bool:
        """Apply a gradient computed at `version`; False = dropped as too
        stale (the worker re-pulls and redoes it)."""
        return self.push_versioned(version, grads)[0]

    def push_versioned(self, version: int, grads):
        """push() that also returns the version after it, read under the
        same lock (`server.version` read afterwards may already be another
        push's)."""
        pushes = metrics_mod.registry().counter(
            "param_server_pushes_total",
            "Gradient pushes by outcome (applied vs dropped as stale)")
        with self._lock:
            if self.version - version > self.max_staleness:
                self.stale_drops += 1
                pushes.labels(result="stale_drop").inc()
                return False, self.version
            with torch.no_grad():
                self.params, self.opt_state = self._apply(
                    _to(grads, self.device))
            self.version += 1
            self.applied += 1
            pushes.labels(result="applied").inc()
            return True, self.version

    def stats(self) -> dict:
        """A consistent (version, applied, stale_drops) snapshot."""
        with self._lock:
            return {"version": self.version, "applied": self.applied,
                    "stale_drops": self.stale_drops}


class ParameterServerTrainer:
    """Async data-parallel fit loop (ParameterServerTrainerContext role):
    one worker thread per device entry, round-robin minibatch feed, no
    barrier. Drives MultiLayerNetwork and ComputationGraph (one input and
    one output)."""

    def __init__(self, net, workers: Optional[int] = None,
                 devices: Optional[List] = None,
                 max_staleness: int = 2, queue_size: int = 4,
                 max_worker_restarts: int = 2):
        net._check_init()
        _reject_stateful(net)
        self.net = net
        devs = [canonical(d) for d in (devices or [net.device])]
        n = workers or len(devs)
        # workers may outnumber devices (threads sharing one card, the
        # reference's threads-per-GPU knob)
        self.devices = [devs[i % len(devs)] for i in range(n)]
        self.server = ParameterServer(net, max_staleness=max_staleness)
        self.queue_size = int(queue_size)
        self.losses: List[float] = []
        # a respawn budget shared by every worker: a transiently failing
        # worker loop restarts in place, a systematically failing fleet
        # still surfaces its error
        self.max_worker_restarts = int(max_worker_restarts)
        self._restarts_left = self.max_worker_restarts
        self._restart_lock = threading.Lock()
        self._is_graph = not hasattr(net, "layers")
        #: per applied push: (pull ms, gradient ms, push ms) on the host
        #: clock, the gradient fenced by its loss
        self.timings: List[tuple] = []

    def _generator(self, wid: int, attempt: int) -> torch.Generator:
        net = self.net
        g = torch.Generator(device=self.devices[wid])
        if wid == 0 and attempt == 0 and \
                canonical(g.device) == canonical(net._dropout_gen.device):
            g.set_state(net._dropout_gen.get_state())
        else:
            g.manual_seed(int(net.conf.seed) + 1000 + wid + 100000 * attempt)
        return g

    def _pack_item(self, item, dev: torch.device):
        """(x, y, fmask, lmask) as the network's loss arguments on `dev`."""
        x, y, fmask, lmask = item
        net = self.net
        if self._is_graph:
            data = net._pack(MultiDataSet(
                [x], [y], None if fmask is None else [fmask],
                None if lmask is None else [lmask]))
        else:
            data = (net._as_input(x), net._as_labels(y), net._as_mask(fmask),
                    net._as_mask(lmask))
        return param_utils.tree_map(lambda t: t.to(dev), data)

    def _worker(self, wid: int, q: "queue.Queue", errors: list,
                stop: threading.Event):
        """Respawn shell: restarts the worker loop in place on error while
        the shared budget lasts; only then does the worker die and surface
        its error to fit()."""
        attempt = 0
        while True:
            try:
                self._worker_loop(wid, attempt, q, stop)
                return
            except Exception as e:
                with self._restart_lock:
                    allowed = self._restarts_left > 0 and not stop.is_set()
                    if allowed:
                        self._restarts_left -= 1
                if not allowed:
                    errors.append(e)
                    log.exception("parameter-server worker %d died", wid)
                    return
                attempt += 1
                metrics_mod.registry().counter(
                    "worker_respawns_total",
                    "Parameter-server worker loops respawned after an "
                    "error").inc()
                log.warning("parameter-server worker %d failed (%s: %s); "
                            "respawning (restarts left: %d)", wid,
                            type(e).__name__, e, self._restarts_left)

    def _worker_loop(self, wid: int, attempt: int, q: "queue.Queue",
                     stop: threading.Event):
        dev = self.devices[wid]
        gen = self._generator(wid, attempt)
        state = _to(self.net.state_tree, dev)
        steps = metrics_mod.registry().counter(
            "param_server_worker_steps_total",
            "Applied async-SGD steps per worker thread"
            ).labels(worker=str(wid))
        while not stop.is_set():
            try:
                item = q.get(timeout=0.2)
            except queue.Empty:
                continue
            if item is None:
                return
            data = self._pack_item(item, dev)
            # the stale-push redo loop checks stop too: an aborting fit
            # must not leave a worker spinning pull/push
            while not stop.is_set():
                t0 = time.perf_counter()
                faults.fire("ps.pull")
                version, params = self.server.pull(dev)
                t1 = time.perf_counter()
                loss, grads = loss_and_grads(self.net, params, state, data,
                                             gen)
                loss_f = float(loss)
                t2 = time.perf_counter()
                faults.fire("ps.push")
                applied = self.server.push(version, grads)
                t3 = time.perf_counter()
                if applied:
                    self.losses.append(loss_f)
                    self.timings.append(((t1 - t0) * 1e3, (t2 - t1) * 1e3,
                                         (t3 - t2) * 1e3))
                    steps.inc()
                    break
                # dropped as stale: re-pull fresh params and redo

    def fit(self, data, labels=None, *, epochs: int = 1,
            batch_size: int = 32) -> "ParameterServerTrainer":
        it = as_iterator(data, labels, batch_size)
        q: "queue.Queue" = queue.Queue(maxsize=self.queue_size)
        errors: list = []
        stop = threading.Event()
        threads = [threading.Thread(target=self._worker,
                                    args=(i, q, errors, stop), daemon=True)
                   for i in range(len(self.devices))]
        for t in threads:
            t.start()

        def put_checked(item):
            # a bounded put that keeps checking worker health: a plain
            # blocking put hangs if every worker died with the queue full
            while True:
                if errors:
                    raise _worker_failure(errors) from errors[0]
                try:
                    q.put(item, timeout=0.2)
                    return
                except queue.Full:
                    continue

        host = lambda a: None if a is None else (
            a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a))
        try:
            for _ in range(epochs):
                it.reset()
                for ds in it:
                    put_checked((host(ds.features), host(ds.labels),
                                 host(ds.features_mask),
                                 host(ds.labels_mask)))
            for _ in threads:
                put_checked(None)  # graceful drain: workers finish the
            for t in threads:      # queue before seeing their sentinel
                t.join()
        finally:
            # orderly shutdown on both paths: abort, drain what the feeder
            # left, then join everyone with a bounded wait
            stop.set()
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            for t in threads:
                t.join(timeout=10.0)
            alive = [t.name for t in threads if t.is_alive()]
            if alive:
                log.warning("parameter-server shutdown: %d worker thread(s) "
                            "still alive after join timeout: %s",
                            len(alive), alive)
        if errors:
            raise _worker_failure(errors) from errors[0]
        # commit the server's latest state back into the network
        net = self.net
        net.params_tree = _to(self.server.params, net.device)
        net.opt_state = _to(self.server.opt_state, net.device)
        net.iteration = self.server.version
        if self.losses:
            net.score_value = torch.tensor(self.losses[-1])
        return self


# ---------------------------------------------------------------------------
# Cross-process transport (the dl4j-spark-parameterserver role)
# ---------------------------------------------------------------------------

def _encode(tree) -> str:
    return base64.b64encode(_tree_to_npz_bytes(tree)).decode()


class ParameterServerHttpNode:
    """HTTP front of a ParameterServer, so workers in other processes or
    hosts push and pull (the reference's Aeron ParameterServerNode and
    dl4j-spark-parameterserver's training hook), over stdlib HTTP.

    Routes:  GET  /params -> {"version": v, "blob": b64-npz(params)}
             POST /push {"version": v, "blob": b64-npz(grads)}
                        -> {"applied": bool, "version": v'}
             GET  /stats -> {"version", "applied", "stale_drops"}
    """

    def __init__(self, server: ParameterServer, port: int = 0):
        self.server = server

        def get_params(_):
            version, params = server.pull()
            return 200, {"version": version, "blob": _encode(params)}

        def post_push(payload):
            grads = _npz_bytes_to_tree(base64.b64decode(payload["blob"]),
                                       server.params, server.device)
            applied, version = server.push_versioned(
                int(payload["version"]), grads)
            return 200, {"applied": bool(applied), "version": version}

        self._http = JsonHttpServer(
            get_routes={"/params": get_params,
                        "/stats": lambda _: (200, server.stats())},
            post_routes={"/push": post_push}, port=port)

    def start(self) -> "ParameterServerHttpNode":
        self._http.start()
        return self

    def stop(self):
        self._http.stop()

    @property
    def url(self) -> str:
        return self._http.url


class HttpParameterServerClient:
    """Worker-side pull/push over HTTP (reference ParameterServerClient).
    `template` is a matching parameter tree that decodes the wire blobs
    onto `device` (default: the template's).

    pull and push retry transient transport failures with backoff under
    `retry` (a resilience.RetryPolicy; default from the DL4JTPU_RETRY_*
    environment). The ``ps.pull``/``ps.push`` fault points fire once per
    attempt, so injected faults within the budget are absorbed."""

    def __init__(self, url: str, template,
                 retry: Optional[resilience.RetryPolicy] = None,
                 device: Optional[torch.device] = None):
        self.url = url.rstrip("/")
        self._template = template
        self.device = torch.device(device) if device is not None else \
            param_utils.tree_leaves(template)[0].device
        self.retry = retry

    def _get(self, path):
        with urllib.request.urlopen(self.url + path, timeout=60) as r:
            return json.loads(r.read())

    def pull(self):
        def attempt():
            faults.fire("ps.pull")
            return self._get("/params")
        rec = resilience.retry_call(attempt, edge="ps.pull",
                                    policy=self.retry)
        params = _npz_bytes_to_tree(base64.b64decode(rec["blob"]),
                                    self._template, self.device)
        return int(rec["version"]), params

    def push(self, version: int, grads) -> bool:
        body = json.dumps({"version": int(version),
                           "blob": _encode(grads)}).encode()
        req = urllib.request.Request(
            self.url + "/push", data=body,
            headers={"Content-Type": "application/json"})

        def attempt():
            faults.fire("ps.push")
            with urllib.request.urlopen(req, timeout=60) as r:
                return bool(json.loads(r.read())["applied"])
        return resilience.retry_call(attempt, edge="ps.push",
                                     policy=self.retry)

    def stats(self) -> dict:
        return self._get("/stats")


def remote_worker_fit(net, url: str, data, labels=None, *, epochs: int = 1,
                      batch_size: int = 32, seed: int = 0,
                      retry: Optional[resilience.RetryPolicy] = None) -> int:
    """One remote worker's loop against an HTTP parameter server: pull,
    local gradient, push, redoing dropped (stale) pushes on fresh
    parameters (the ParameterServerTrainingHook loop of a Spark executor).
    Returns the number of applied pushes."""
    net._check_init()
    _reject_stateful(net)
    if not hasattr(net, "layers"):
        raise NotImplementedError(
            "remote_worker_fit drives MultiLayerNetwork; use the "
            "in-process ParameterServerTrainer for ComputationGraph")
    client = HttpParameterServerClient(url, net.params_tree, retry=retry)
    gen = torch.Generator(device=net.device).manual_seed(int(seed))
    it = as_iterator(data, labels, batch_size)
    applied = 0
    for _ in range(epochs):
        it.reset()
        for ds in it:
            batch = (net._as_input(ds.features), net._as_labels(ds.labels),
                     None, None)
            while True:
                version, params = client.pull()
                _, grads = loss_and_grads(net, params, net.state_tree, batch,
                                          gen)
                if client.push(version, grads):
                    applied += 1
                    break
    return applied
