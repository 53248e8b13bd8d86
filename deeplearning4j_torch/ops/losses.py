"""Loss functions.

Port of `deeplearning4j_tpu/ops/losses.py` (reference nd4j ILossFunction
implementations used by DL4J output layers): the same registered names, the
same per-element formulas and the same reductions, as torch functions. Each
loss is ``score_array(labels, preout, activation, mask) -> per-example
score``; the backward comes from autograd. The softmax+MCXENT/NLL and
sigmoid+XENT pairs take the numerically stable fused path (log-softmax,
logits-BCE) instead of activating and then taking logs.

Shapes: preout/labels are [batch, features], [batch, time, features] or
[batch, h, w, c]. The score array reduces all non-batch axes; masks broadcast
against labels from [batch], [batch, time] or the full shape.
"""
from __future__ import annotations

from typing import Callable, Optional, Union

import torch
import torch.nn.functional as F

from .activations import resolve as resolve_activation

Tensor = torch.Tensor


def _reduce_nonbatch(x: Tensor) -> Tensor:
    return torch.sum(x.reshape(x.shape[0], -1), dim=-1)


def _apply_mask(per_elem: Tensor, mask: Optional[Tensor]) -> Tensor:
    if mask is None:
        return per_elem
    while mask.ndim < per_elem.ndim:
        mask = mask[..., None]
    return per_elem * mask


_EPS = 1e-10


def _mse(labels, out):
    return (out - labels) ** 2


def _l1(labels, out):
    return torch.abs(out - labels)


def _xent_fused(labels, preout):
    return -(labels * F.logsigmoid(preout)
             + (1.0 - labels) * F.logsigmoid(-preout))


def _xent_on_probs(labels, p):
    p = torch.clamp(p, _EPS, 1.0 - _EPS)
    return -(labels * torch.log(p) + (1.0 - labels) * torch.log1p(-p))


def _mcxent_fused(labels, preout):
    return -labels * F.log_softmax(preout, dim=-1)


def _mcxent_on_probs(labels, p):
    return -labels * torch.log(torch.clamp(p, min=_EPS))


def _hinge(labels, out):
    # labels in {-1, +1}
    return torch.clamp(1.0 - labels * out, min=0.0)


def _squared_hinge(labels, out):
    return torch.clamp(1.0 - labels * out, min=0.0) ** 2


def _kld(labels, p):
    lab = torch.clamp(labels, min=_EPS)
    p = torch.clamp(p, min=_EPS)
    return labels * (torch.log(lab) - torch.log(p))


def _mape(labels, out):
    return 100.0 * torch.abs((out - labels)
                             / torch.clamp(torch.abs(labels), min=_EPS))


def _msle(labels, out):
    return (torch.log1p(torch.clamp(out, min=-1 + _EPS))
            - torch.log1p(torch.clamp(labels, min=-1 + _EPS))) ** 2


def _poisson(labels, out):
    return out - labels * torch.log(torch.clamp(out, min=_EPS))


class Loss:
    """A named loss; callable as score_array(labels, preout, activation, mask)."""

    def __init__(self, name: str, elementwise: Optional[Callable],
                 fused: dict | None = None, cosine: bool = False):
        self.name = name
        self._elementwise = elementwise
        self._fused = fused or {}
        self._cosine = cosine

    def score_array(self, labels: Tensor, preout: Tensor,
                    activation: Union[str, Callable, None] = "identity",
                    mask: Optional[Tensor] = None) -> Tensor:
        act_name = activation.lower() if isinstance(activation, str) else None
        if self._cosine:
            out = resolve_activation(activation)(preout)
            ln = torch.linalg.vector_norm(labels.reshape(labels.shape[0], -1), dim=-1)
            on = torch.linalg.vector_norm(out.reshape(out.shape[0], -1), dim=-1)
            dots = _reduce_nonbatch(_apply_mask(labels * out, mask))
            return -dots / torch.clamp(ln * on, min=_EPS)
        if act_name in self._fused:
            per_elem = self._fused[act_name](labels, preout)
        else:
            per_elem = self._elementwise(labels,
                                         resolve_activation(activation)(preout))
        return _reduce_nonbatch(_apply_mask(per_elem, mask))

    def score(self, labels, preout, activation="identity", mask=None) -> Tensor:
        """Mean-over-minibatch score, the quantity MultiLayerNetwork.score()
        reports; with a time-series mask, the sum over present steps."""
        sa = self.score_array(labels, preout, activation, mask)
        if mask is not None and mask.ndim >= 2:
            return torch.sum(sa) / torch.clamp(torch.sum(mask), min=1.0)
        return torch.mean(sa)


LOSSES: dict[str, Loss] = {}


def _reg(name: str, loss: Loss):
    LOSSES[name] = loss
    return loss


_reg("mse", Loss("mse", _mse))
_reg("squared_loss", Loss("squared_loss", _mse))
_reg("l2", Loss("l2", _mse))
_reg("l1", Loss("l1", _l1))
_reg("mae", Loss("mae", _l1))
_reg("xent", Loss("xent", _xent_on_probs, fused={"sigmoid": _xent_fused}))
_reg("mcxent", Loss("mcxent", _mcxent_on_probs, fused={"softmax": _mcxent_fused}))
_reg("negativeloglikelihood",
     Loss("negativeloglikelihood", _mcxent_on_probs, fused={"softmax": _mcxent_fused}))
_reg("hinge", Loss("hinge", _hinge))
_reg("squared_hinge", Loss("squared_hinge", _squared_hinge))
_reg("kl_divergence", Loss("kl_divergence", _kld))
_reg("mean_absolute_percentage_error", Loss("mape", _mape))
_reg("mape", LOSSES["mean_absolute_percentage_error"])
_reg("mean_squared_logarithmic_error", Loss("msle", _msle))
_reg("msle", LOSSES["mean_squared_logarithmic_error"])
_reg("poisson", Loss("poisson", _poisson))
_reg("cosine_proximity", Loss("cosine_proximity", None, cosine=True))

LossLike = Union[str, Loss]


def resolve(loss: LossLike) -> Loss:
    if isinstance(loss, Loss):
        return loss
    key = loss.lower()
    if key not in LOSSES:
        raise ValueError(f"Unknown loss {loss!r}. Known: {sorted(LOSSES)}")
    return LOSSES[key]


def register_loss(name: str, loss: Loss) -> None:
    """Custom-loss extension point (reference: custom ILossFunction)."""
    LOSSES[name.lower()] = loss
