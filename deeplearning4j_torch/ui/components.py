"""ui-components: declarative, JSON-serializable report components.

Reference parity: deeplearning4j-ui-components — an object model of
texts/tables/charts serialized to JSON and rendered by a small JS
runtime (deeplearning4j-ui-parent/deeplearning4j-ui-components/src/main/
java/org/deeplearning4j/ui/api/Component.java and components/chart/
ChartLine, ChartScatter, ChartHistogram, ChartHorizontalBar,
components/table/ComponentTable, components/text/ComponentText,
components/component/ComponentDiv). Users compose components, ship them
as JSON, and any surface renders them.

Port of `deeplearning4j_tpu/ui/components.py`, line for line: components
are serde-registered dataclasses (the port's `utils/serde.py`, which
registers the same names), so `to_json`/`from_json` IS the wire format and
either package reads the other's JSON; rendering is server-side SVG/HTML
(`render_component`, standalone, no JS runtime)."""
from __future__ import annotations

import html as _html
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

from ..utils import serde

__all__ = [
    "Component", "ComponentText", "ComponentTable", "ComponentDiv",
    "ChartLine", "ChartScatter", "ChartHistogram", "ChartHorizontalBar",
    "render_component", "component_to_json", "component_from_json",
]


@dataclass
class Component:
    """Base marker (reference ui/api/Component.java)."""


@serde.register
@dataclass
class ComponentText(Component):
    """reference components/text/ComponentText.java"""
    text: str = ""
    font_size: int = 12
    color: str = "#000000"

    def html(self) -> str:
        return (f'<p style="font-size:{int(self.font_size)}px;'
                f'color:{_html.escape(self.color)}">'
                f'{_html.escape(self.text)}</p>')


@serde.register
@dataclass
class ComponentTable(Component):
    """reference components/table/ComponentTable.java"""
    header: Sequence[str] = ()
    content: Sequence[Sequence[str]] = ()
    border: int = 1

    def html(self) -> str:
        head = "".join(f"<th>{_html.escape(str(h))}</th>"
                       for h in self.header)
        rows = "".join(
            "<tr>" + "".join(f"<td>{_html.escape(str(c))}</td>"
                             for c in row) + "</tr>"
            for row in self.content)
        return (f'<table border="{int(self.border)}" '
                f'style="border-collapse:collapse">'
                f"<tr>{head}</tr>{rows}</table>")


@serde.register
@dataclass
class ComponentDiv(Component):
    """Container (reference components/component/ComponentDiv.java)."""
    components: List[Component] = field(default_factory=list)
    style: str = ""

    def html(self) -> str:
        inner = "".join(c.html() for c in self.components)
        return f'<div style="{_html.escape(self.style)}">{inner}</div>'


def _axes_box(w, h, pad):
    return (f'<line x1="{pad}" y1="{h - pad}" x2="{w - pad}" '
            f'y2="{h - pad}" stroke="#333"/>'
            f'<line x1="{pad}" y1="{pad}" x2="{pad}" y2="{h - pad}" '
            f'stroke="#333"/>')


_SERIES_COLORS = ("#3366cc", "#dc3912", "#ff9900", "#109618", "#990099",
                  "#0099c6")


@dataclass
class _Chart(Component):
    title: str = ""
    width: int = 480
    height: int = 300

    def _frame(self, body: str) -> str:
        t = (f'<text x="{self.width // 2}" y="14" text-anchor="middle" '
             f'font-size="13">{_html.escape(self.title)}</text>')
        return (f'<svg xmlns="http://www.w3.org/2000/svg" '
                f'viewBox="0 0 {self.width} {self.height}" '
                f'width="{self.width}" height="{self.height}">'
                f'<rect width="{self.width}" height="{self.height}" '
                f'fill="#ffffff"/>{t}{body}</svg>')


def _scale(vals, lo, hi, a, b):
    span = (hi - lo) if hi > lo else 1.0
    return [a + (v - lo) / span * (b - a) for v in vals]


@serde.register
@dataclass
class ChartLine(_Chart):
    """reference components/chart/ChartLine.java: named (x, y) series."""
    series_names: Sequence[str] = ()
    x: Sequence[Sequence[float]] = ()
    y: Sequence[Sequence[float]] = ()

    def html(self) -> str:
        pad = 28
        allx = [v for s in self.x for v in s] or [0.0]
        ally = [v for s in self.y for v in s] or [0.0]
        body = [_axes_box(self.width, self.height, pad)]
        for i, (xs, ys) in enumerate(zip(self.x, self.y)):
            px = _scale(xs, min(allx), max(allx), pad, self.width - pad)
            py = _scale(ys, min(ally), max(ally), self.height - pad, pad)
            pts = " ".join(f"{a:.1f},{b:.1f}" for a, b in zip(px, py))
            color = _SERIES_COLORS[i % len(_SERIES_COLORS)]
            body.append(f'<polyline points="{pts}" fill="none" '
                        f'stroke="{color}" stroke-width="1.5"/>')
            if i < len(self.series_names):
                body.append(
                    f'<text x="{self.width - pad}" y="{pad + 14 * i}" '
                    f'text-anchor="end" font-size="11" fill="{color}">'
                    f'{_html.escape(str(self.series_names[i]))}</text>')
        return self._frame("".join(body))


@serde.register
@dataclass
class ChartScatter(_Chart):
    """reference components/chart/ChartScatter.java"""
    series_names: Sequence[str] = ()
    x: Sequence[Sequence[float]] = ()
    y: Sequence[Sequence[float]] = ()

    def html(self) -> str:
        pad = 28
        allx = [v for s in self.x for v in s] or [0.0]
        ally = [v for s in self.y for v in s] or [0.0]
        body = [_axes_box(self.width, self.height, pad)]
        for i, (xs, ys) in enumerate(zip(self.x, self.y)):
            px = _scale(xs, min(allx), max(allx), pad, self.width - pad)
            py = _scale(ys, min(ally), max(ally), self.height - pad, pad)
            color = _SERIES_COLORS[i % len(_SERIES_COLORS)]
            body.extend(f'<circle cx="{a:.1f}" cy="{b:.1f}" r="2.5" '
                        f'fill="{color}"/>' for a, b in zip(px, py))
        return self._frame("".join(body))


@serde.register
@dataclass
class ChartHistogram(_Chart):
    """reference components/chart/ChartHistogram.java: explicit bin
    edges (lower/upper) + counts."""
    lower: Sequence[float] = ()
    upper: Sequence[float] = ()
    y: Sequence[float] = ()

    @staticmethod
    def from_values(values, bins: int = 20, **kw) -> "ChartHistogram":
        counts, edges = np.histogram(np.asarray(values, np.float64),
                                     bins=bins)
        return ChartHistogram(lower=edges[:-1].tolist(),
                              upper=edges[1:].tolist(),
                              y=counts.astype(float).tolist(), **kw)

    def html(self) -> str:
        pad = 28
        if not self.y:
            return self._frame(_axes_box(self.width, self.height, pad))
        lo, hi = min(self.lower), max(self.upper)
        ymax = max(self.y) or 1.0
        body = [_axes_box(self.width, self.height, pad)]
        for l, u, c in zip(self.lower, self.upper, self.y):
            x0 = _scale([l], lo, hi, pad, self.width - pad)[0]
            x1 = _scale([u], lo, hi, pad, self.width - pad)[0]
            hh = (self.height - 2 * pad) * (c / ymax)
            body.append(
                f'<rect x="{x0:.1f}" y="{self.height - pad - hh:.1f}" '
                f'width="{max(x1 - x0 - 1, 1):.1f}" height="{hh:.1f}" '
                f'fill="#3366cc"/>')
        return self._frame("".join(body))


@serde.register
@dataclass
class ChartHorizontalBar(_Chart):
    """reference components/chart/ChartHorizontalBar.java"""
    labels: Sequence[str] = ()
    values: Sequence[float] = ()

    def html(self) -> str:
        pad = 28
        n = max(len(self.values), 1)
        vmax = max([abs(v) for v in self.values] or [1.0]) or 1.0
        bh = (self.height - 2 * pad) / n
        body = [_axes_box(self.width, self.height, pad)]
        for i, v in enumerate(self.values):
            w = (self.width - 2 * pad - 80) * abs(v) / vmax
            y = pad + i * bh
            body.append(
                f'<rect x="{pad + 80}" y="{y + 2:.1f}" width="{w:.1f}" '
                f'height="{max(bh - 4, 2):.1f}" fill="#109618"/>')
            if i < len(self.labels):
                body.append(
                    f'<text x="{pad + 74}" y="{y + bh / 2 + 4:.1f}" '
                    f'text-anchor="end" font-size="11">'
                    f'{_html.escape(str(self.labels[i]))}</text>')
        return self._frame("".join(body))


def component_to_json(component: Component) -> str:
    """Serialize any component tree (the reference's Component JSON
    contract — `@class`-tagged, round-trippable)."""
    return serde.to_json(component)


def component_from_json(js: str) -> Component:
    return serde.from_json(js)


def render_component(component: Component) -> str:
    """Standalone HTML document for a component tree."""
    return (f"<!doctype html><html><head><meta charset='utf-8'>"
            f"<title>report</title></head><body>{component.html()}"
            f"</body></html>")
