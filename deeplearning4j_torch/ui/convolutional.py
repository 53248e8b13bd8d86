"""Convolutional-activations UI module: what is the CNN looking at?

Reference parity: deeplearning4j-ui's ConvolutionalIterationListener
(deeplearning4j-ui-parent/deeplearning4j-ui/src/main/java/org/
deeplearning4j/ui/weights/ConvolutionalIterationListener.java:38) renders
every conv layer's activation maps as a tiled grayscale grid each N
iterations and streams it to the play UI's `convolutional` module
(ui/play/PlayUIServer.java:15-22).

Port of `deeplearning4j_tpu/ui/convolutional.py`: the listener runs its
OWN probe forward (`feed_forward` / `feed_forward_named`, which return host
arrays, NHWC) on a fixed [1, H, W, C] probe at the reporting frequency:
deterministic, one extra forward per N iterations, and independent of batch
contents. Grids are encoded as real PNGs with a stdlib-only encoder (zlib +
struct) and pushed to the live UIServer, which serves them inline on
/activations."""
from __future__ import annotations

import struct
import zlib
from typing import List, Optional, Tuple

import numpy as np

from ..optimize.listeners import IterationListener


def png_gray(img: np.ndarray) -> bytes:
    """Encode a [h, w] uint8 array as an 8-bit grayscale PNG."""
    img = np.asarray(img, np.uint8)
    h, w = img.shape
    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data +
                struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) +
            chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def activation_grid(act: np.ndarray, border: int = 1,
                    max_channels: int = 64) -> np.ndarray:
    """[H, W, C] feature maps -> one tiled uint8 [rows*H', cols*W'] grid
    (per-channel min-max normalized, the reference's grayscale scaling)."""
    act = np.asarray(act, np.float32)
    if act.ndim != 3:
        raise ValueError(f"need [H, W, C] activations, got {act.shape}")
    h, w, c = act.shape
    c = min(c, max_channels)
    cols = int(np.ceil(np.sqrt(c)))
    rows = int(np.ceil(c / cols))
    gh, gw = h + border, w + border
    grid = np.zeros((rows * gh + border, cols * gw + border), np.uint8)
    for i in range(c):
        m = act[:, :, i]
        lo, hi = float(m.min()), float(m.max())
        span = (hi - lo) if hi > lo else 1.0
        tile = ((m - lo) / span * 255.0).astype(np.uint8)
        r, col = divmod(i, cols)
        grid[border + r * gh:border + r * gh + h,
             border + col * gw:border + col * gw + w] = tile
    return grid


class ConvolutionalIterationListener(IterationListener):
    """Render per-conv-layer activation grids into the live UI every
    `frequency` iterations (reference
    ConvolutionalIterationListener.java:38 role).

    `probe`: one input example ([1, H, W, C] — or [H, W, C], auto-
    batched) forwarded through the net at each report. `ui`: a UIServer
    (defaults to the running singleton at first report)."""

    def __init__(self, probe, frequency: int = 10, ui=None,
                 max_channels: int = 64):
        probe = np.asarray(probe, np.float32)
        if probe.ndim == 3:
            probe = probe[None]
        if probe.ndim != 4:
            raise ValueError(f"probe must be [1, H, W, C], got {probe.shape}")
        self.probe = probe[:1]
        self.frequency = max(1, int(frequency))
        self.max_channels = int(max_channels)
        self._ui = ui

    def _grids(self, model) -> List[Tuple[str, bytes]]:
        out = []
        if hasattr(model, "feed_forward_named"):  # ComputationGraph
            if len(model.conf.network_inputs) != 1:
                raise ValueError(
                    "ConvolutionalIterationListener supports single-input "
                    "graphs (one probe); got inputs "
                    f"{model.conf.network_inputs}")
            acts = model.feed_forward_named(self.probe)
            skip = set(model.conf.network_inputs)
            named = [(n, acts[n]) for n in model.conf.topo_order
                     if n in acts and n not in skip]
        else:  # MultiLayerNetwork: [input] + per-layer activations
            ff = model.feed_forward(self.probe)
            layers = getattr(model, "layers", [])
            named = [(f"layer{i} "
                      f"({type(layers[i]).__name__ if i < len(layers) else '?'})",
                      act) for i, act in enumerate(ff[1:])]
        for name, act in named:
            a = np.asarray(act)
            if a.ndim != 4:
                continue  # not a spatial activation
            out.append((str(name), png_gray(
                activation_grid(a[0], max_channels=self.max_channels))))
        return out

    def iteration_done(self, model, iteration):
        if iteration % self.frequency != 0:
            return
        if self._ui is None:
            from .server import UIServer
            self._ui = UIServer.get_instance()
        self._ui.attach_activations(self._grids(model), iteration)
