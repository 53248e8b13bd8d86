"""Input types and input preprocessors.

Port of `deeplearning4j_tpu/nn/conf/inputs.py`. The layouts are the JAX
package's, not the reference's: convolutional data is NHWC
([batch, height, width, channels]) and recurrent data [batch, time,
features]. In particular CnnToFeedForwardPreProcessor flattens in NHWC
order, so dense weights carried over from the JAX package line up.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ...utils import serde

Tensor = torch.Tensor


@serde.register
@dataclass
class InputType:
    """Base input type."""

    @staticmethod
    def feed_forward(size: int) -> "FeedForwardType":
        return FeedForwardType(size=int(size))

    @staticmethod
    def recurrent(size: int, timeseries_length: int | None = None) -> "RecurrentType":
        return RecurrentType(size=int(size), timeseries_length=timeseries_length)

    @staticmethod
    def convolutional(height: int, width: int, channels: int) -> "ConvolutionalType":
        return ConvolutionalType(height=int(height), width=int(width),
                                 channels=int(channels))

    @staticmethod
    def convolutional_flat(height: int, width: int, channels: int) -> "ConvolutionalFlatType":
        return ConvolutionalFlatType(height=int(height), width=int(width),
                                     channels=int(channels))


@serde.register
@dataclass
class FeedForwardType(InputType):
    size: int = 0


@serde.register
@dataclass
class RecurrentType(InputType):
    size: int = 0
    timeseries_length: int | None = None


@serde.register
@dataclass
class ConvolutionalType(InputType):
    height: int = 0
    width: int = 0
    channels: int = 0


@serde.register
@dataclass
class ConvolutionalFlatType(InputType):
    """Flattened image rows (e.g. raw MNIST 784-vectors)."""

    height: int = 0
    width: int = 0
    channels: int = 0

    @property
    def flat_size(self) -> int:
        return self.height * self.width * self.channels


# ---------------------------------------------------------------------------
# Preprocessors
# ---------------------------------------------------------------------------


@serde.register
@dataclass
class InputPreProcessor:
    """Pure shape adapter auto-inserted between incompatible layer types."""

    def __call__(self, x: Tensor) -> Tensor:
        raise NotImplementedError

    def output_type(self, input_type: InputType) -> InputType:
        raise NotImplementedError


@serde.register
@dataclass
class CnnToFeedForwardPreProcessor(InputPreProcessor):
    height: int = 0
    width: int = 0
    channels: int = 0

    def __call__(self, x):
        # NHWC row-major flatten, whatever the tensor's memory format
        return x.reshape(x.shape[0], -1)

    def output_type(self, input_type):
        if isinstance(input_type, ConvolutionalType):
            return FeedForwardType(
                size=input_type.height * input_type.width * input_type.channels)
        raise ValueError(f"Expected convolutional input, got {input_type}")


@serde.register
@dataclass
class FeedForwardToCnnPreProcessor(InputPreProcessor):
    height: int = 0
    width: int = 0
    channels: int = 0

    def __call__(self, x):
        return x.reshape(x.shape[0], self.height, self.width, self.channels)

    def output_type(self, input_type):
        return ConvolutionalType(self.height, self.width, self.channels)


@serde.register
@dataclass
class RnnToFeedForwardPreProcessor(InputPreProcessor):
    """[batch, time, size] -> [batch*time, size] (time-distributed dense)."""

    def __call__(self, x):
        return x.reshape(-1, x.shape[-1])

    def output_type(self, input_type):
        if isinstance(input_type, RecurrentType):
            return FeedForwardType(size=input_type.size)
        raise ValueError(f"Expected recurrent input, got {input_type}")


@serde.register
@dataclass
class FeedForwardToRnnPreProcessor(InputPreProcessor):
    """[batch*time, size] -> [batch, time, size]."""

    timeseries_length: int = 0

    def __call__(self, x):
        if self.timeseries_length <= 0:
            raise ValueError("FeedForwardToRnnPreProcessor needs timeseries_length")
        return x.reshape(-1, self.timeseries_length, x.shape[-1])

    def output_type(self, input_type):
        if isinstance(input_type, FeedForwardType):
            return RecurrentType(size=input_type.size,
                                 timeseries_length=self.timeseries_length or None)
        raise ValueError(f"Expected feed-forward input, got {input_type}")


@serde.register
@dataclass
class CnnToRnnPreProcessor(InputPreProcessor):
    """[batch, h, w, c] -> [batch, time=1, h*w*c]."""

    def __call__(self, x):
        return x.reshape(x.shape[0], 1, -1)

    def output_type(self, input_type):
        if isinstance(input_type, ConvolutionalType):
            return RecurrentType(
                size=input_type.height * input_type.width * input_type.channels)
        raise ValueError(f"Expected convolutional input, got {input_type}")


@serde.register
@dataclass
class RnnToCnnPreProcessor(InputPreProcessor):
    """[batch, time, h*w*c] -> [batch*time, h, w, c]."""

    height: int = 0
    width: int = 0
    channels: int = 0

    def __call__(self, x):
        expect = self.height * self.width * self.channels
        if x.shape[-1] != expect:
            # without this, any divisible total silently mixes timesteps
            raise ValueError(f"RnnToCnn: feature size {x.shape[-1]} != "
                             f"h*w*c {expect}")
        return x.reshape(-1, self.height, self.width, self.channels)

    def output_type(self, input_type):
        if isinstance(input_type, RecurrentType):
            expect = self.height * self.width * self.channels
            if input_type.size != expect:
                raise ValueError(
                    f"RnnToCnn: rnn size {input_type.size} != h*w*c "
                    f"{expect}")
            return ConvolutionalType(height=self.height, width=self.width,
                                     channels=self.channels)
        raise ValueError(f"Expected recurrent input, got {input_type}")


@serde.register
@dataclass
class UnitVarianceProcessor(InputPreProcessor):
    """Scale activations to unit variance per feature column over the
    batch (population std, as jnp.std)."""

    eps: float = 1e-8

    def __call__(self, x):
        std = x.std(dim=0, keepdim=True, correction=0)
        # constant columns (incl. batch size 1) pass through unscaled
        return x / torch.where(std > self.eps, std, torch.ones_like(std))

    def output_type(self, input_type):
        return input_type


@serde.register
@dataclass
class ComposableInputPreProcessor(InputPreProcessor):
    processors: list = None

    def __call__(self, x):
        for p in self.processors or []:
            x = p(x)
        return x

    def output_type(self, input_type):
        for p in self.processors or []:
            input_type = p.output_type(input_type)
        return input_type
