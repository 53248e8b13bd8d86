"""Remote stats: POST training stats to a central receiver.

Reference parity: deeplearning4j-ui-remote-iterationlisteners'
RemoteUIStatsStorageRouter (workers POST SBE-encoded stats) +
deeplearning4j-play's RemoteReceiverModule (accepts them into the
attached StatsStorage) — the mechanism Spark workers use to report to one
central UI. Port of `deeplearning4j_tpu/ui/remote.py`, over the port's
`utils/http_server.py`. JSON over stdlib HTTP here; the storage API
on both ends is the same StatsStorage the local pipeline uses, so a
multi-host run can point every process's StatsListener at one chief-side
receiver."""
from __future__ import annotations

import json
import queue
import threading
import urllib.request
from typing import Optional

from ..utils.http_server import JsonHttpServer
from .stats import StatsStorage


class RemoteStatsStorageRouter(StatsStorage):
    """StatsStorage facade that forwards put_update over HTTP (reference
    RemoteUIStatsStorageRouter). Posts happen on a background thread so a
    slow receiver never stalls the train loop; retries are bounded."""

    def __init__(self, url: str, queue_size: int = 256, retries: int = 3,
                 timeout: float = 5.0):
        self.url = url.rstrip("/") + "/stats"
        self.retries = int(retries)
        self.timeout = float(timeout)
        self._queue: "queue.Queue" = queue.Queue(maxsize=queue_size)
        # dropped is bumped from both the caller thread (queue full) and
        # the pump thread (retries exhausted): += is a read-modify-write,
        # so both sites go through _drop() under this lock
        self._drop_lock = threading.Lock()
        self.dropped = 0
        self._shutdown = False
        self._thread = threading.Thread(target=self._pump, daemon=True)
        self._thread.start()

    def _drop(self) -> None:
        with self._drop_lock:
            self.dropped += 1

    def put_update(self, session_id: str, record: dict) -> None:
        try:
            self._queue.put_nowait({"session": session_id, **record})
        except queue.Full:
            self._drop()  # never stall training on a slow receiver

    def _pump(self):
        while True:
            item = self._queue.get()
            try:
                if item is None:
                    return
                body = json.dumps(item).encode()
                for attempt in range(self.retries):
                    try:
                        req = urllib.request.Request(
                            self.url, data=body,
                            headers={"Content-Type": "application/json"})
                        urllib.request.urlopen(req, timeout=self.timeout)
                        break
                    except Exception:
                        if attempt == self.retries - 1:
                            self._drop()
            finally:
                self._queue.task_done()

    def flush(self, timeout: float = 10.0):
        """Block until queued records have been POSTED (not merely
        dequeued — unfinished_tasks counts the in-flight record too)."""
        import time
        deadline = time.time() + timeout
        while self._queue.unfinished_tasks and time.time() < deadline:
            time.sleep(0.02)

    def shutdown(self):
        if not self._shutdown:
            self._shutdown = True
            self._queue.put(None)
            self._thread.join(timeout=5)

    # remote router is write-only (reference: the router interface)
    def list_session_ids(self):
        raise NotImplementedError("RemoteStatsStorageRouter is write-only; "
                                  "query the receiver's storage")

    def get_updates(self, session_id):
        raise NotImplementedError("RemoteStatsStorageRouter is write-only; "
                                  "query the receiver's storage")


class StatsReceiverServer(JsonHttpServer):
    """HTTP receiver writing into a local StatsStorage (reference
    RemoteReceiverModule): POST /stats {session, ...record}; GET /sessions
    lists what arrived."""

    def __init__(self, storage: StatsStorage, port: int = 0):
        super().__init__(get_routes={"/sessions": self._sessions},
                         post_routes={"/stats": self._stats}, port=port)
        self.storage = storage

    def _sessions(self, _):
        return 200, {"sessions": self.storage.list_session_ids()}

    def _stats(self, rec: dict):
        sid = rec.pop("session", "remote")
        self.storage.put_update(sid, rec)
        return 200, {"ok": True}
