"""CenterLossOutputLayer: a softmax (or other) head plus the center loss.

Port of `CenterLossOutputLayer` in `deeplearning4j_tpu/nn/layers/pretrain.py`
(reference nn/conf/layers/CenterLossOutputLayer and
nn/params/CenterLossParamInitializer): one trainable center per class
(``cW``, [n_out, n_in], zeros at init, never regularized), and the score

    base + lambda/2 mean_b ||x_b - c_{y_b}||^2.

As in the JAX package, the centers train by autograd of a center term split
with stop-gradients (``.detach()`` here): the features feel lambda, the
centers feel alpha, and the reported score stays the one above. The rest of
the JAX module (AutoEncoder, VariationalAutoencoder, RBM) waits for the
pretrain layers' slice.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ...utils import serde
from .core import BaseOutputLayer

CENTERS = "cW"


@serde.register
@dataclass
class CenterLossOutputLayer(BaseOutputLayer):
    """Output layer with a center-loss term (reference
    CenterLossOutputLayer): L = L_base + lambda/2 mean ||x - c_y||^2."""

    alpha: float = 0.05     # the centers' learning coefficient
    lambda_: float = 2e-4   # the center term's weight on the features

    def init_params(self, gen, dtype=torch.float32):
        p = super().init_params(gen, dtype)
        p[CENTERS] = torch.zeros((self.n_out, self.n_in), dtype=dtype)
        return p

    def param_reg(self, pname):
        if pname == CENTERS:
            return (0.0, 0.0)
        return super().param_reg(pname)

    def _centers(self, params, labels):
        return params[CENTERS][torch.argmax(labels, dim=-1)]

    def compute_score(self, params, x, labels, mask=None):
        base = super().compute_score(params, x, labels, mask)
        c_y = self._centers(params, labels)
        feat_term = 0.5 * self.lambda_ * torch.mean(
            torch.sum((x - c_y.detach()) ** 2, dim=-1))
        cent_term = 0.5 * self.alpha * torch.mean(
            torch.sum((x.detach() - c_y) ** 2, dim=-1))
        # the alpha term adds its gradient to the centers, not its value
        return base + feat_term + cent_term - cent_term.detach()

    def compute_score_array(self, params, x, labels, mask=None):
        base = super().compute_score_array(params, x, labels, mask)
        c_y = self._centers(params, labels)
        return base + 0.5 * self.lambda_ * torch.sum((x - c_y) ** 2, dim=-1)
