"""Recurrent-shaped layers. Only `RnnOutputLayer` is ported so far.

Port of `RnnOutputLayer` in `deeplearning4j_tpu/nn/layers/recurrent.py`
(reference nn/conf/layers/RnnOutputLayer): a time-distributed dense layer plus
loss over [batch, time, features]. The broadcasting matmul distributes over
time, and the labels mask [batch, time] zeroes padded steps in the score. The
LSTMs are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass

from ...utils import serde
from ..conf.inputs import RecurrentType
from .core import BaseOutputLayer


@serde.register
@dataclass
class RnnOutputLayer(BaseOutputLayer):
    """Time-distributed dense + loss head over [batch, time, features]."""

    def input_kind(self):
        return "rnn"

    def set_input_type(self, input_type):
        if isinstance(input_type, RecurrentType):
            if self.n_in == 0:
                self.n_in = input_type.size
            return RecurrentType(size=self.n_out,
                                 timeseries_length=input_type.timeseries_length)
        raise ValueError(f"RnnOutputLayer needs RNN input, got {input_type}")
