"""MultiLayerNetwork: sequential-stack network, inference half.

Port of `deeplearning4j_tpu/nn/multilayer.py` (reference
nn/multilayer/MultiLayerNetwork.java): `init`, `output`, `predict`,
`feed_forward`, `warmup` and `_feature_struct`. Training (`fit`, `score`,
the updaters' math) comes with the training slice.

Where the JAX package jits one pure forward, the port runs the layers
eagerly under ``torch.inference_mode``. Parameters are a tuple of per-layer
dicts of tensors on the network's device (``params_tree``), in the port's
layout (utils/params.py converts from and to the JAX package's).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..utils import params as param_utils
from ..utils.device import DeviceLike, resolve_device
from .conf.builders import MultiLayerConfiguration
from .conf.inputs import (ConvolutionalFlatType, ConvolutionalType,
                          FeedForwardType, RecurrentType)

Tensor = torch.Tensor


class MultiLayerNetwork:
    def __init__(self, conf: MultiLayerConfiguration):
        self.conf = conf
        self.layers = list(conf.layers)
        if not self.layers:
            raise ValueError("Configuration has no layers")
        self.params_tree: Optional[Tuple[dict, ...]] = None
        self.device: Optional[torch.device] = None
        self._dtype = torch.float32
        self._initialized = False

    # ------------------------------------------------------------------ init
    def init(self, seed: Optional[int] = None, dtype=torch.float32,
             device: DeviceLike = None) -> "MultiLayerNetwork":
        """Draw the parameters from a generator seeded with `seed` (default:
        the configuration's) and place them on `device` (default: CUDA,
        raising when there is none)."""
        self.device = resolve_device(device)
        self._dtype = dtype
        gen = torch.Generator().manual_seed(
            self.conf.seed if seed is None else int(seed))
        self.params_tree = tuple(
            {name: param_utils.place(t, self.device)
             for name, t in layer.init_params(gen, dtype).items()}
            for layer in self.layers)
        self._initialized = True
        return self

    def _check_init(self):
        if not self._initialized:
            raise RuntimeError("Call net.init() before using the network")

    # --------------------------------------------------------------- forward
    def _forward(self, params, x: Tensor, train: bool = False,
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[Tensor, List[Tensor]]:
        """Run all layers; returns (final activation, every activation)."""
        a = x
        activations = []
        for i, layer in enumerate(self.layers):
            p = self.conf.preprocessor(i)
            if p is not None:
                a = p(a)
            a = layer.forward(params[i], a, train=train, generator=generator)
            activations.append(a)
        return a, activations

    def _as_input(self, x) -> Tensor:
        return torch.as_tensor(x, dtype=self._dtype, device=self.device)

    def _feature_struct(self, batch_size: int,
                        time_steps: Optional[int] = None) -> Tensor:
        """A meta tensor with the shape and dtype of a feature batch,
        inferred from conf.input_type (or the first layer's n_in when no
        input type was declared)."""
        b = int(batch_size)
        it = getattr(self.conf, "input_type", None)
        if isinstance(it, ConvolutionalType):
            shape = (b, it.height, it.width, it.channels)
        elif isinstance(it, ConvolutionalFlatType):
            shape = (b, it.flat_size)
        elif isinstance(it, RecurrentType):
            t = time_steps or it.timeseries_length
            if not t:
                raise ValueError(
                    "a recurrent net needs time_steps= (or a RecurrentType "
                    "with timeseries_length)")
            shape = (b, int(t), it.size)
        elif isinstance(it, FeedForwardType):
            shape = (b, it.size)
        else:
            n_in = getattr(self.layers[0], "n_in", None)
            if not n_in:
                raise ValueError(
                    "cannot infer the input shape: declare an input type on "
                    "the configuration")
            if self.layers[0].input_kind() == "rnn":
                if not time_steps:
                    raise ValueError("a recurrent net needs time_steps=")
                shape = (b, int(time_steps), int(n_in))
            else:
                shape = (b, int(n_in))
        return torch.empty(shape, dtype=self._dtype, device="meta")

    def warmup(self, batch_size: int = 1, *,
               time_steps: Optional[int] = None) -> "MultiLayerNetwork":
        """Serving cold-start eliminator: push one zero batch of
        `batch_size` through `output()` so the first real request at that
        size finds cuDNN's algorithms chosen and the kernels built."""
        self._check_init()
        x_s = self._feature_struct(batch_size, time_steps)
        self.output(torch.zeros(x_s.shape, dtype=x_s.dtype, device=self.device))
        return self

    # ------------------------------------------------------------- inference
    def output(self, x) -> np.ndarray:
        """Forward pass, inference mode (reference output())."""
        self._check_init()
        with torch.inference_mode():
            out, _ = self._forward(self.params_tree, self._as_input(x))
            return out.cpu().numpy()

    def feed_forward(self, x) -> List[np.ndarray]:
        """All layer activations incl. input (reference feedForward())."""
        self._check_init()
        with torch.inference_mode():
            xa = self._as_input(x)
            _, acts = self._forward(self.params_tree, xa)
            return [a.cpu().numpy() for a in [xa] + acts]

    def predict(self, x) -> np.ndarray:
        """Argmax class predictions (reference predict())."""
        return np.argmax(self.output(x), axis=-1)

    def num_params(self) -> int:
        self._check_init()
        return param_utils.num_params(self.params_tree)
