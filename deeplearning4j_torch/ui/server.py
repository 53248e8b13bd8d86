"""Live training UI server — attach a StatsStorage and watch while fit()
runs. Port of `deeplearning4j_tpu/ui/server.py`: the same routes and
bytes, over the port's metrics registry and span ring.

Reference parity: deeplearning4j-play's PlayUIServer
(`ui/play/PlayUIServer.java:15-22`): `UIServer.getInstance()`,
`attach(statsStorage)`, pluggable modules (train overview, histograms,
update magnitudes), browse while training. Here the Play framework is a
stdlib ThreadingHTTPServer; every page request re-renders from the
attached storage, so the browser always sees the CURRENT run state, and
the page self-refreshes (watch mode). The remote-receiver module
counterpart lives in ui/remote.py (POST /stats); both can share one
storage so cluster workers report into the same live view.

Routes:
  GET /                  live HTML overview (self-refreshing)
  GET /train/sessions    JSON session ids
  GET /train/data        JSON all updates of the newest session
  GET /metrics           Prometheus text exposition of the process-global
                         MetricsRegistry (docs/observability.md)
  GET /trace             Chrome trace-event JSON of the tracing ring
                         (load in chrome://tracing / Perfetto)
  GET /tsne              embedding scatter plot (attach_embedding /
                         POST /tsne/upload — the tsne UI module role)
  POST /tsne/upload      {"points": [[x,y],...], "labels": [...]}
"""
from __future__ import annotations

import json
import threading
import zlib
from typing import Optional, Sequence

import numpy as np

from ..optimize import metrics as metrics_mod
from ..optimize import tracing
from ..utils.http_server import JsonHttpServer
from .report import render_html
from .stats import StatsStorage


def _scatter_svg(points: np.ndarray, labels: Sequence[str],
                 width=640, height=480, pad=24) -> str:
    """2-D embedding scatter (the tsne module's view). Points colored by
    label hash; labels legend capped at 12 entries."""
    import html as _html
    if len(points) == 0:
        return "<svg></svg>"
    p = np.asarray(points, np.float64)
    lo, hi = p.min(0), p.max(0)
    span = np.where(hi - lo > 0, hi - lo, 1.0)
    xy = (p - lo) / span
    uniq = []
    for l in labels:
        if l not in uniq:
            uniq.append(l)
    # crc32, not hash(): Python hash() is salted per process, which would
    # recolor every label on restart / across workers sharing one view
    color = {l: f"hsl({(zlib.crc32(str(l).encode()) % 360)},65%,45%)"
             for l in uniq}
    dots = "".join(
        f'<circle cx="{pad + x * (width - 2 * pad):.1f}" '
        f'cy="{height - pad - y * (height - 2 * pad):.1f}" r="3" '
        f'fill="{color[l]}"><title>{_html.escape(str(l))}</title>'
        f'</circle>'
        for (x, y), l in zip(xy, labels))
    legend = "".join(
        f'<text x="{pad + 90 * i}" y="14" font-size="11" '
        f'fill="{color[l]}">{_html.escape(str(l))[:10]}</text>'
        for i, l in enumerate(uniq[:12]))
    return (f'<svg viewBox="0 0 {width} {height}" width="{width}" '
            f'height="{height}" xmlns="http://www.w3.org/2000/svg">'
            f'<rect width="{width}" height="{height}" fill="#fafafa"/>'
            f'{legend}{dots}</svg>')


class UIServer:
    """PlayUIServer role; one instance per process via get_instance()."""

    _instance: Optional["UIServer"] = None
    _instance_lock = threading.Lock()

    def __init__(self, port: int = 0, refresh_seconds: float = 2.0):
        self._storages: list[StatsStorage] = []
        self._lock = threading.Lock()
        self.refresh_seconds = float(refresh_seconds)
        self._embedding = None  # (points [n,2], labels [n])
        self._model = None   # network shown on /model (flow module)
        self._activations = None  # ([(name, png_bytes)...], iteration)
        self._server = JsonHttpServer(
            get_routes={"/train/sessions": self._sessions,
                        "/train/data": self._data},
            post_routes={"/tsne/upload": self._tsne_upload},
            raw_get_routes={"/": self._index, "/tsne": self._tsne_page,
                            "/model": self._model_page,
                            "/activations": self._activations_page,
                            "/metrics": self._metrics,
                            "/trace": self._trace},
            port=port)

    # ----------------------------------------------------------- lifecycle
    @classmethod
    def get_instance(cls, port: int = 0) -> "UIServer":
        """Reference UIServer.getInstance(): lazily start the singleton."""
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls(port=port).start()
            return cls._instance

    def start(self) -> "UIServer":
        self._server.start()
        return self

    def stop(self):
        self._server.stop()
        with UIServer._instance_lock:
            if UIServer._instance is self:
                UIServer._instance = None

    @property
    def url(self) -> str:
        return self._server.url

    @property
    def port(self) -> int:
        return self._server.port

    # -------------------------------------------------------------- attach
    def attach(self, storage: StatsStorage) -> "UIServer":
        """Reference UIServer.attach(statsStorage): pages render from the
        newest session across all attached storages from now on."""
        with self._lock:
            if storage not in self._storages:
                self._storages.append(storage)
        return self

    def detach(self, storage: StatsStorage) -> "UIServer":
        with self._lock:
            if storage in self._storages:
                self._storages.remove(storage)
        return self

    def _pick(self):
        """(storage, session_id) of the most recently updated session."""
        with self._lock:
            storages = list(self._storages)
        best = None
        for st in storages:
            for sid in st.list_session_ids():
                updates = st.get_updates(sid)
                if not updates:
                    continue
                ts = updates[-1].get("timestamp", 0)
                if best is None or ts > best[2]:
                    best = (st, sid, ts)
        return (best[0], best[1]) if best else (None, None)

    # -------------------------------------------------------------- routes
    def _index(self):
        st, sid = self._pick()
        if st is None:
            body = (b"<!doctype html><meta http-equiv='refresh' "
                    b"content='2'><body>waiting for an attached "
                    b"StatsStorage with updates...</body>")
            return 200, "text/html; charset=utf-8", body
        doc = render_html(st, sid, refresh_seconds=self.refresh_seconds)
        return 200, "text/html; charset=utf-8", doc.encode()

    def _sessions(self, _):
        with self._lock:
            storages = list(self._storages)
        out = []
        for st in storages:
            out.extend(st.list_session_ids())
        return 200, {"sessions": out}

    def _data(self, _):
        st, sid = self._pick()
        if st is None:
            return 404, {"error": "no attached session"}
        return 200, {"session": sid, "updates": st.get_updates(sid)}

    # ------------------------------------------------- observability scrape
    def _metrics(self):
        """Prometheus scrape target: the process-global registry, so one
        endpoint covers every network/wrapper in the process."""
        body = metrics_mod.registry().prometheus_text().encode()
        return 200, "text/plain; version=0.0.4; charset=utf-8", body

    def _trace(self):
        """Chrome trace-event JSON of the span ring (empty traceEvents
        list until tracing.enable() has been called)."""
        body = json.dumps(tracing.export_trace_events()).encode()
        return 200, "application/json", body

    # --------------------------------------------------------- flow module
    def attach_model(self, net) -> "UIServer":
        """Show the network's architecture on /model (the reference flow
        UI module: layer boxes in execution order with connections).
        Works for MultiLayerNetwork (chain) and ComputationGraph (DAG in
        topological order)."""
        with self._lock:
            self._model = net
        return self

    def _model_page(self):
        with self._lock:
            net = self._model
        if net is None:
            return (200, "text/html; charset=utf-8",
                    b"<!doctype html><body>no model attached - "
                    b"attach_model(net)</body>")
        import html as _html
        rows = []
        if hasattr(net, "layers"):  # MultiLayerNetwork chain
            for i, layer in enumerate(net.layers):
                rows.append((f"layer{i}", type(layer).__name__,
                             [f"layer{i-1}"] if i else []))
        else:  # ComputationGraph DAG
            for name in net.conf.topo_order:
                node = net.conf.nodes[name]
                kind = type(node.layer if node.is_layer()
                            else node.vertex).__name__
                rows.append((name, kind, list(node.inputs)))
        ypos = {name: 26 + i * 44 for i, (name, _, _) in enumerate(rows)}
        boxes, edges = [], []
        for name, kind, inputs in rows:
            y = ypos[name]
            boxes.append(
                f'<rect x="150" y="{y}" width="340" height="32" rx="6" '
                f'fill="#eef4ff" stroke="#88a"/>'
                f'<text x="160" y="{y + 20}" font-size="12">'
                f'{_html.escape(name)}: {_html.escape(kind)}</text>')
            for src in inputs:
                if src in ypos:
                    edges.append(
                        f'<line x1="320" y1="{ypos[src] + 32}" x2="320" '
                        f'y2="{y}" stroke="#668" marker-end="url(#a)"/>')
                else:  # network input
                    edges.append(
                        f'<text x="40" y="{y + 20}" font-size="11" '
                        f'fill="#486">{_html.escape(src)} &#8594;</text>')
        h = 26 + len(rows) * 44 + 20
        doc = (f"<!doctype html><html><head><meta charset='utf-8'>"
               f"<title>Model</title></head><body><h1>Model "
               f"({len(rows)} nodes)</h1>"
               f'<svg viewBox="0 0 640 {h}" width="640" height="{h}" '
               f'xmlns="http://www.w3.org/2000/svg">'
               f'<defs><marker id="a" markerWidth="8" markerHeight="8" '
               f'refX="6" refY="3" orient="auto">'
               f'<path d="M0,0 L6,3 L0,6 z" fill="#668"/></marker></defs>'
               f'{"".join(edges)}{"".join(boxes)}</svg></body></html>')
        return 200, "text/html; charset=utf-8", doc.encode()

    # ------------------------------------------------- convolutional module
    def attach_activations(self, grids, iteration: int) -> "UIServer":
        """Show per-conv-layer activation grids on /activations (the
        reference play `convolutional` module; fed by
        ui.convolutional.ConvolutionalIterationListener). `grids`:
        [(layer_name, png_bytes), ...]."""
        with self._lock:
            self._activations = (list(grids), int(iteration))
        return self

    def _activations_page(self):
        import base64
        import html as _html
        with self._lock:
            snap = self._activations
        if snap is None:
            return (200, "text/html; charset=utf-8",
                    b"<!doctype html><meta http-equiv='refresh' "
                    b"content='2'><body>no activations yet - add a "
                    b"ConvolutionalIterationListener</body>")
        grids, iteration = snap
        parts = [f"<!doctype html><html><head><meta charset='utf-8'>"
                 f"<meta http-equiv='refresh' "
                 f"content='{self.refresh_seconds}'>"
                 f"<title>Activations</title></head><body>"
                 f"<h1>Conv activations @ iteration {iteration}</h1>"]
        for name, png in grids:
            b64 = base64.b64encode(png).decode()
            parts.append(
                f"<h3>{_html.escape(str(name))}</h3>"
                f'<img style="image-rendering:pixelated" width="512" '
                f'src="data:image/png;base64,{b64}"/>')
        parts.append("</body></html>")
        return 200, "text/html; charset=utf-8", "".join(parts).encode()

    # --------------------------------------------------------- tsne module
    def attach_embedding(self, points, labels=None) -> "UIServer":
        """Show a 2-D embedding on /tsne (the reference tsne UI module:
        upload t-SNE coordinates, browse the scatter). Pairs naturally
        with clustering.tsne.TSNE output."""
        points = np.asarray(points, np.float64)
        if points.ndim != 2 or points.shape[1] != 2:
            raise ValueError(f"need [n, 2] points, got {points.shape}")
        labels = [""] * len(points) if labels is None else \
            [str(l) for l in labels]
        if len(labels) != len(points):
            raise ValueError("labels length != points length")
        with self._lock:
            self._embedding = (points, labels)
        return self

    def _tsne_upload(self, payload):
        self.attach_embedding(payload["points"], payload.get("labels"))
        return 200, {"count": len(payload["points"])}

    def _tsne_page(self):
        with self._lock:
            emb = self._embedding
        if emb is None:
            body = ("<!doctype html><body>no embedding attached — "
                    "attach_embedding(points, labels) or POST "
                    "/tsne/upload</body>").encode()
            return 200, "text/html; charset=utf-8", body
        doc = (f"<!doctype html><html><head><meta charset='utf-8'>"
               f"<title>t-SNE</title></head><body>"
               f"<h1>Embedding ({len(emb[0])} points)</h1>"
               f"{_scatter_svg(emb[0], emb[1])}</body></html>")
        return 200, "text/html; charset=utf-8", doc.encode()
