"""NDArray pub/sub streaming + serve routes.

Reference parity: dl4j-streaming's Kafka pipeline —
streaming/kafka/{NDArrayPublisher,NDArrayConsumer,NDArrayKafkaClient}
(byte-serialized NDArrays through topics) and
streaming/routes/DL4jServeRouteBuilder.java (consume a topic, run the
model, publish predictions).

Port of `deeplearning4j_tpu/streaming/ndarray_stream.py`, line for line:
Kafka/Camel are infrastructure choices, not behavior; the behavioral
surface (named topics, non-blocking publish, blocking consume, a serve
route wiring a model between topics) is kept over an in-process broker
with an optional stdlib-HTTP transport for cross-process use. Arrays ride
as JSON (shape + flat float32 values), the JAX package's wire format, so a
client of either package talks to a server of the other. A ServeRoute
calls `model.output` from its own thread, which on the GPU drives CUDA
from that thread; a failing call counts in `errors` and the route goes
on."""
from __future__ import annotations

import queue
import threading
from typing import Dict, List, Optional

import numpy as np

from ..utils.http_server import JsonHttpServer


def _encode(arr: np.ndarray) -> dict:
    arr = np.asarray(arr, np.float32)
    return {"shape": list(arr.shape), "data": arr.reshape(-1).tolist()}


def _decode(obj: dict) -> np.ndarray:
    return np.asarray(obj["data"], np.float32).reshape(obj["shape"])


class NDArrayTopic:
    """One named topic: fan-out to every subscriber queue (the Kafka
    topic/consumer-group role, single-partition semantics)."""

    def __init__(self, name: str, queue_size: int = 256):
        self.name = name
        self._queue_size = queue_size
        self._subscribers: List["queue.Queue"] = []
        self._lock = threading.Lock()

    def subscribe(self) -> "queue.Queue":
        q: "queue.Queue" = queue.Queue(maxsize=self._queue_size)
        with self._lock:
            self._subscribers.append(q)
        return q

    def unsubscribe(self, q: "queue.Queue") -> None:
        with self._lock:
            if q in self._subscribers:
                self._subscribers.remove(q)

    def publish(self, arr: np.ndarray) -> None:
        arr = np.asarray(arr, np.float32)
        with self._lock:
            subs = list(self._subscribers)
        for q in subs:
            try:
                q.put_nowait(arr)
            except queue.Full:
                pass  # slow consumer drops, publisher never blocks


class Broker:
    """The pluggable transport seam (the reference swaps
    brokers at the Camel/Kafka component level —
    kafka/NDArrayKafkaClient.java:10). An implementation maps topic
    names to objects with the NDArrayTopic surface: `publish(arr)`,
    `subscribe() -> queue.Queue`, `unsubscribe(q)`. Publishers,
    consumers, and serve routes are broker-agnostic; an external-system
    adapter (Kafka, Pub/Sub, ...) implements `topic` with a consumer
    thread feeding the returned queue. Ships: InProcessBroker (default)
    and HttpBrokerClient (a remote NDArrayStreamServer)."""

    def topic(self, name: str):
        raise NotImplementedError


class InProcessBroker(Broker):
    """Topics live in this process (the single-JVM embedded-broker
    role); NDArrayStreamServer exposes the SAME broker over HTTP for
    cross-process use."""

    def __init__(self):
        self._topics: Dict[str, NDArrayTopic] = {}
        self._lock = threading.Lock()

    def topic(self, name: str) -> NDArrayTopic:
        with self._lock:
            t = self._topics.get(name)
            if t is None:
                t = self._topics[name] = NDArrayTopic(name)
            return t


_Broker = InProcessBroker  # back-compat alias
_default_broker: Broker = InProcessBroker()


def get_default_broker() -> Broker:
    return _default_broker


def set_default_broker(broker: Broker) -> Broker:
    """Swap the process-wide default transport (e.g. to an external
    adapter); returns the previous broker so callers can restore it."""
    global _default_broker
    prev = _default_broker
    _default_broker = broker
    return prev


class _HttpTopic:
    """Client-side topic over a remote NDArrayStreamServer: publish
    POSTs; subscribe long-polls /consume on a daemon thread into a
    local queue (the consumer-thread pattern an external-broker adapter
    uses too)."""

    def __init__(self, base_url: str, name: str, client_id: str,
                 poll_timeout: float):
        self._url = base_url.rstrip("/")
        self.name = name
        self._client_id = client_id
        self._poll_timeout = poll_timeout
        self._pollers: List[tuple] = []  # (queue, stop_event, thread)
        self._n = 0
        self._lock = threading.Lock()

    def _post(self, route: str, payload: dict) -> dict:
        import json
        import urllib.request
        req = urllib.request.Request(
            self._url + route, json.dumps(payload).encode(),
            {"Content-Type": "application/json"})
        with urllib.request.urlopen(
                req, timeout=self._poll_timeout + 10) as resp:
            return json.loads(resp.read())

    def publish(self, arr) -> None:
        self._post("/publish", {"topic": self.name,
                                **_encode(np.asarray(arr, np.float32))})

    def subscribe(self) -> "queue.Queue":
        q: "queue.Queue" = queue.Queue(maxsize=256)
        stop = threading.Event()
        with self._lock:  # unique client id under concurrent subscribes
            self._n += 1
            client = f"{self._client_id}-{self._n}"
        # Register the server-side subscription SYNCHRONOUSLY (a
        # zero-wait consume) so subscribe-then-publish cannot lose the
        # first message to the poller's startup window — the
        # InProcessBroker ordering guarantee holds over HTTP too. The
        # registration consume can itself return a message (a publish
        # raced between a previous subscriber's registration and now, or
        # the server pre-seeded the queue) — dropping that payload would
        # silently lose the first message, so deliver it here.
        out = self._post("/consume", {"topic": self.name, "client": client,
                                      "timeout": 0.0})
        if not out.get("empty", True):
            q.put_nowait(_decode(out))

        warned = [False]

        def run():
            try:
                while not stop.is_set():
                    try:
                        out = self._post("/consume", {
                            "topic": self.name, "client": client,
                            "timeout": self._poll_timeout})
                    except Exception as e:
                        if not warned[0]:  # visible, once (dead server)
                            import logging
                            logging.getLogger(__name__).warning(
                                "HTTP broker poll of %s/%s failing (%s); "
                                "retrying", self._url, self.name, e)
                            warned[0] = True
                        if stop.wait(0.2):
                            return
                        continue
                    if not out.get("empty", True):
                        try:
                            q.put_nowait(_decode(out))
                        except queue.Full:
                            pass  # slow consumer drops, like NDArrayTopic
            finally:
                # the POLLER posts the goodbye, strictly AFTER its last
                # /consume — an unsubscribe posted from another thread
                # could be overtaken by an in-flight consume that
                # re-registers the queue server-side
                try:
                    self._post("/unsubscribe", {"topic": self.name,
                                                "client": client})
                except Exception:
                    pass  # server gone: its consumer map died with it

        t = threading.Thread(target=run, daemon=True)
        t.start()
        with self._lock:
            self._pollers.append((q, stop, t))
        return q

    def unsubscribe(self, q: "queue.Queue") -> None:
        """Stops the poller; the poller itself then releases the
        server-side queue (see run()'s finally) so publishes stop
        fanning into a dead subscription."""
        with self._lock:
            ents = [e for e in self._pollers if e[0] is q]
            for ent in ents:
                self._pollers.remove(ent)
        for ent in ents:
            ent[1].set()


class HttpBrokerClient(Broker):
    """Broker over a remote NDArrayStreamServer — the cross-process
    transport as a first-class Broker implementation (so a serve route
    can consume from one machine's topics and publish to another's)."""

    def __init__(self, base_url: str, client_id: Optional[str] = None,
                 poll_timeout: float = 2.0):
        import uuid
        self._base_url = base_url
        self._client_id = client_id or uuid.uuid4().hex[:8]
        self._poll_timeout = float(poll_timeout)
        self._topics: Dict[str, _HttpTopic] = {}
        self._lock = threading.Lock()

    def topic(self, name: str) -> _HttpTopic:
        with self._lock:
            t = self._topics.get(name)
            if t is None:
                t = self._topics[name] = _HttpTopic(
                    self._base_url, name, self._client_id,
                    self._poll_timeout)
            return t


class NDArrayPublisher:
    """Reference kafka/NDArrayPublisher: publish(arr) onto a topic."""

    def __init__(self, topic: str, broker: Optional[Broker] = None):
        self._topic = (broker or _default_broker).topic(topic)

    def publish(self, arr) -> None:
        self._topic.publish(np.asarray(arr, np.float32))


class NDArrayConsumer:
    """Reference kafka/NDArrayConsumer: blocking getArrays()."""

    def __init__(self, topic: str, broker: Optional[Broker] = None):
        self._queue = (broker or _default_broker).topic(topic).subscribe()

    def get(self, timeout: Optional[float] = None) -> np.ndarray:
        return self._queue.get(timeout=timeout)

    def poll(self) -> Optional[np.ndarray]:
        try:
            return self._queue.get_nowait()
        except queue.Empty:
            return None


class ServeRoute:
    """Reference streaming/routes/DL4jServeRouteBuilder: consume arrays
    from `input_topic`, run the model, publish predictions to
    `output_topic` — on a background thread until stop()."""

    def __init__(self, model, input_topic: str, output_topic: str,
                 broker: Optional[Broker] = None):
        self.model = model
        self._consumer = NDArrayConsumer(input_topic, broker)
        self._publisher = NDArrayPublisher(output_topic, broker)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.served = 0
        self.errors = 0

    def start(self) -> "ServeRoute":
        import logging
        log = logging.getLogger(__name__)

        def run():
            while not self._stop.is_set():
                try:
                    arr = self._consumer.get(timeout=0.1)
                except queue.Empty:
                    continue
                try:
                    self._publisher.publish(self.model.output(arr))
                    self.served += 1
                except Exception:  # one bad input must not kill the route
                    self.errors += 1
                    log.exception("ServeRoute: dropping bad input of shape "
                                  "%s", np.shape(arr))
        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


class NDArrayStreamServer(JsonHttpServer):
    """Cross-process transport: POST /publish {topic, shape, data};
    POST /consume {topic, timeout} (long-poll; registers the caller's
    subscription on first consume)."""

    def __init__(self, port: int = 0, broker: Optional[Broker] = None,
                 subscriber_idle_ttl: float = 300.0):
        super().__init__(get_routes={"/health": self._health},
                         post_routes={"/publish": self._publish,
                                      "/consume": self._consume,
                                      "/unsubscribe": self._unsubscribe},
                         port=port)
        # Default to the SHARED broker so in-process publishers/consumers
        # and remote HTTP clients see the same topics.
        self._broker = broker or _default_broker
        # (topic, client) → (queue, last_seen); idle entries evict so
        # departed clients don't leak permanently-subscribed queues.
        self._consumers: Dict[tuple, tuple] = {}
        self._ttl = float(subscriber_idle_ttl)
        self._lock = threading.Lock()

    def _health(self, _):
        return 200, {"status": "ok"}

    def _publish(self, req: dict):
        self._broker.topic(req["topic"]).publish(_decode(req))
        return 200, {"ok": True}

    def _unsubscribe(self, req: dict):
        """Prompt release of a remote client's subscription (the idle
        TTL sweep is only the departed-without-goodbye fallback)."""
        key = (req["topic"], str(req.get("client", "default")))
        with self._lock:
            ent = self._consumers.pop(key, None)
        if ent is not None:
            self._broker.topic(key[0]).unsubscribe(ent[0])
        return 200, {"ok": ent is not None}

    def _consume(self, req: dict):
        import time
        # Subscriptions key on (topic, client) so DISTINCT remote clients
        # each get full fan-out, matching in-process NDArrayConsumer
        # semantics; pass a stable "client" id per consumer process.
        key = (req["topic"], str(req.get("client", "default")))
        now = time.time()
        with self._lock:
            # evict subscriptions idle past the TTL (departed clients)
            for k in [k for k, (_, seen) in self._consumers.items()
                      if now - seen > self._ttl]:
                q_dead, _ = self._consumers.pop(k)
                self._broker.topic(k[0]).unsubscribe(q_dead)
            ent = self._consumers.get(key)
            if ent is None:
                q = self._broker.topic(key[0]).subscribe()
            else:
                q = ent[0]
            self._consumers[key] = (q, now)
        # Clamp the wait below the TTL so an ACTIVE long-poll can never be
        # evicted mid-wait by another client's sweep; refresh last_seen
        # when the wait ends.
        wait = min(float(req.get("timeout", 5.0)), self._ttl * 0.5)
        try:
            arr = q.get(timeout=wait)
        except queue.Empty:
            arr = None
        with self._lock:
            if key in self._consumers:
                self._consumers[key] = (self._consumers[key][0],
                                        time.time())
        if arr is None:
            return 200, {"empty": True}
        return 200, {"empty": False, **_encode(arr)}
