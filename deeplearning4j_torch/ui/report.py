"""Static training report from a StatsStorage.

Port of `deeplearning4j_tpu/ui/report.py`, byte for byte in what it renders.
Reference parity: the role of deeplearning4j-play's train UI module
(PlayUIServer score chart, model tab, system tab), rendered as a
self-contained static HTML file (inline SVG, zero JS dependencies) plus a
machine-readable JSON export: a file artifact is greppable and archivable.
"""
from __future__ import annotations

import html
import json
from typing import Any, Dict, List

from .stats import StatsStorage


def export_json(storage: StatsStorage, session_id: str = None) -> str:
    """All updates for one (or the only) session as a JSON document."""
    sessions = storage.list_session_ids()
    if not sessions:
        raise ValueError("Storage holds no sessions")
    sid = session_id or sessions[0]
    return json.dumps({"session": sid,
                       "updates": storage.get_updates(sid)}, indent=2)


def _svg_polyline(xs: List[float], ys: List[float], width=640, height=240,
                  pad=36) -> str:
    if not xs:
        return "<svg></svg>"
    x0, x1 = min(xs), max(xs) or 1
    y0, y1 = min(ys), max(ys)
    if y1 == y0:
        y1 = y0 + 1
    sx = lambda x: pad + (x - x0) / max(x1 - x0, 1e-12) * (width - 2 * pad)
    sy = lambda y: height - pad - (y - y0) / (y1 - y0) * (height - 2 * pad)
    pts = " ".join(f"{sx(x):.1f},{sy(y):.1f}" for x, y in zip(xs, ys))
    return (
        f'<svg viewBox="0 0 {width} {height}" width="{width}" '
        f'height="{height}" xmlns="http://www.w3.org/2000/svg">'
        f'<rect width="{width}" height="{height}" fill="#fafafa"/>'
        f'<text x="{pad}" y="16" font-size="11">score (min '
        f'{y0:.4g}, max {y1:.4g})</text>'
        f'<polyline fill="none" stroke="#2266cc" stroke-width="1.5" '
        f'points="{pts}"/></svg>')


def _svg_histogram(hist: Dict[str, Any], width=300, height=90,
                   pad=4) -> str:
    """Bar chart for one param histogram record (the reference histogram
    UI module's per-layer view)."""
    counts = hist.get("counts") or []
    if not counts:
        return "<svg></svg>"
    peak = max(counts) or 1
    n = len(counts)
    bw = (width - 2 * pad) / n
    bars = "".join(
        f'<rect x="{pad + i * bw:.1f}" '
        f'y="{height - pad - c / peak * (height - 2 * pad):.1f}" '
        f'width="{max(bw - 1, 1):.1f}" '
        f'height="{c / peak * (height - 2 * pad):.1f}" fill="#44aa66"/>'
        for i, c in enumerate(counts))
    return (f'<svg viewBox="0 0 {width} {height}" width="{width}" '
            f'height="{height}" xmlns="http://www.w3.org/2000/svg">'
            f'<rect width="{width}" height="{height}" fill="#fafafa"/>'
            f'{bars}'
            f'<text x="{pad}" y="{height - 2}" font-size="9">'
            f'{hist.get("min", 0):.3g}</text>'
            f'<text x="{width - 40}" y="{height - 2}" font-size="9">'
            f'{hist.get("max", 0):.3g}</text></svg>')


def render_html(storage: StatsStorage, session_id: str = None,
                refresh_seconds: float = None) -> str:
    """Render the training report document (the train UI module's
    overview + histogram + update views). With `refresh_seconds` the
    page self-reloads — that is the live UIServer's watch mode."""
    sessions = storage.list_session_ids()
    if not sessions:
        raise ValueError("Storage holds no sessions")
    sid = session_id or sessions[0]
    updates = [u for u in storage.get_updates(sid) if "epoch_end" not in u]
    iters = [u["iteration"] for u in updates if u.get("score") is not None]
    scores = [u["score"] for u in updates if u.get("score") is not None]
    times = [u.get("iteration_ms") for u in updates
             if u.get("iteration_ms") is not None]
    last = updates[-1] if updates else {}

    rows = []
    if times:
        import statistics
        rows.append(("mean iteration (ms)",
                     f"{statistics.fmean(times):.2f}"))
    if scores:
        rows.append(("final score", f"{scores[-1]:.6g}"))
        rows.append(("best score", f"{min(scores):.6g}"))
    rows.append(("iterations", str(iters[-1] if iters else 0)))
    if "host_max_rss_mb" in last:
        rows.append(("host max RSS (MB)",
                     f"{last['host_max_rss_mb']:.1f}"))
    mm = last.get("param_mean_magnitudes") or {}
    table = "".join(f"<tr><td>{html.escape(k)}</td><td>{v}</td></tr>"
                    for k, v in rows)
    mm_table = "".join(
        f"<tr><td>{html.escape(k)}</td><td>{v:.6g}</td></tr>"
        for k, v in sorted(mm.items()))
    # per-layer histogram panels (last update that carried them)
    hists = {}
    for u in reversed(updates):
        if u.get("param_histograms"):
            hists = u["param_histograms"]
            break
    hist_panels = "".join(
        f'<div class="h"><div>{html.escape(name)}</div>'
        f'{_svg_histogram(h)}</div>'
        for name, h in sorted(hists.items()))
    hist_section = (f'<h2>Parameter histograms</h2>'
                    f'<div class="hwrap">{hist_panels}</div>'
                    if hist_panels else "")
    # update-magnitude trajectories (learning-rate health view)
    upd_series: Dict[str, list] = {}
    for u in updates:
        for k, v in (u.get("update_mean_magnitudes") or {}).items():
            upd_series.setdefault(k, []).append((u["iteration"], v))
    upd_section = ""
    if upd_series:
        charts = "".join(
            f'<div class="h"><div>{html.escape(k)}</div>'
            + _svg_polyline([float(i) for i, _ in pts],
                            [float(v) for _, v in pts], width=300,
                            height=90, pad=10)
            + "</div>"
            for k, pts in sorted(upd_series.items()))
        upd_section = (f'<h2>Update mean magnitudes</h2>'
                       f'<div class="hwrap">{charts}</div>')
    meta_refresh = (f'<meta http-equiv="refresh" '
                    f'content="{refresh_seconds:g}">'
                    if refresh_seconds else "")
    live_note = " (live)" if refresh_seconds else ""
    # hoisted out of the f-string: a backslash inside an f-string
    # expression is a SyntaxError before Python 3.12
    stats_json = export_json(storage, sid).replace("<", "\\u003c")
    return f"""<!doctype html>
<html><head><meta charset="utf-8">{meta_refresh}
<title>Training report — {html.escape(sid)}</title>
<style>body{{font:13px sans-serif;margin:2em}}td{{padding:2px 10px;
border-bottom:1px solid #eee}}h2{{margin-top:1.4em}}
.hwrap{{display:flex;flex-wrap:wrap;gap:12px}}
.h div{{font-size:11px;color:#555}}</style></head>
<body>
<h1>Training report{live_note}</h1>
<p>session <code>{html.escape(sid)}</code>, {len(updates)} updates</p>
<h2>Score</h2>
{_svg_polyline([float(i) for i in iters], [float(s) for s in scores])}
<h2>Summary</h2><table>{table}</table>
<h2>Parameter mean magnitudes (last iteration)</h2>
<table>{mm_table}</table>
{hist_section}
{upd_section}
<script type="application/json" id="stats-data">
{stats_json}
</script>
</body></html>"""


def render_html_report(storage: StatsStorage, path: str,
                       session_id: str = None) -> str:
    """Write a browsable report; returns the path (reference: the train
    module's overview page)."""
    with open(path, "w") as f:
        f.write(render_html(storage, session_id))
    return path
