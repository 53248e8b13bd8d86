"""The pretraining layers: AutoEncoder, VariationalAutoencoder, RBM, and
CenterLossOutputLayer.

Port of `deeplearning4j_tpu/nn/layers/pretrain.py`:

* AutoEncoder (reference nn/layers/feedforward/autoencoder/AutoEncoder.java):
  a denoising autoencoder with a tied decoder ``h W^T + vb``, input
  corruption, and an ``mse`` or ``xent`` reconstruction loss.
* VariationalAutoencoder (reference nn/layers/variational/
  VariationalAutoencoder.java): encoder MLP -> q(z|x) mean and log variance
  -> sampled z -> decoder MLP -> reconstruction distribution; `pretrain`
  minimizes the negative ELBO; the supervised forward returns the q(z|x)
  mean.
* RBM (reference nn/layers/feedforward/rbm/RBM.java): Bernoulli-Bernoulli,
  trained by CD-k from its own statistics, not by autograd.
* CenterLossOutputLayer (reference nn/conf/layers/CenterLossOutputLayer and
  nn/params/CenterLossParamInitializer): one trainable center per class
  (``cW``, [n_out, n_in], zeros at init, never regularized) and the score
  base + lambda/2 mean_b ||x_b - c_{y_b}||^2. As in the JAX package, the
  centers train by autograd of a center term split with stop-gradients
  (``.detach()`` here): the features feel lambda, the centers feel alpha,
  and the reported score stays the one above.

Random draws. The JAX package draws the pretrain noise from ``jax.random``;
the port draws it from an explicit ``torch.Generator`` on the input's device.
Each objective therefore has a pure form that takes the drawn noise as
tensors, which the generator form draws and passes on:

    AutoEncoder.pretrain_loss_given(params, x, keep)     keep mask or None
    VariationalAutoencoder.pretrain_loss_given(params, x, eps)
                                                         one eps per sample
    RBM.pretrain_grads_given(params, x, uniforms)        one uniform array
                                                         per Bernoulli draw

A Bernoulli unit is on where its uniform lies below its probability, as
``jax.random.bernoulli`` decides, so the same uniforms give the same chain in
both packages.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from ...ops import activations as act_ops
from ...utils import serde
from ..conf.inputs import FeedForwardType
from .core import BIAS, WEIGHT, BaseOutputLayer, Layer, dropout

Tensor = torch.Tensor

VISIBLE_BIAS = "vb"
CENTERS = "cW"


def _fallback_generator(x: Tensor) -> torch.Generator:
    """The draw the JAX package makes from PRNGKey(0) when no key is given:
    a generator seeded 0 on `x`'s device."""
    return torch.Generator(device=x.device).manual_seed(0)


class _Feedforward:
    """Shape inference shared by the pretrain layers: n_in from a
    feed-forward input, n_out out."""

    def set_input_type(self, input_type):
        if isinstance(input_type, FeedForwardType) and self.n_in == 0:
            self.n_in = input_type.size
        return FeedForwardType(size=self.n_out)

    def has_params(self):
        return True

    def is_pretrainable(self):
        return True


def _visible_layer_params(layer, gen, dtype):
    """W [n_in, n_out], the hidden bias b and the visible bias vb, zeros."""
    w = layer._winit(gen, (layer.n_in, layer.n_out), layer.n_in, layer.n_out,
                     dtype)
    return {WEIGHT: w,
            BIAS: torch.zeros((layer.n_out,), dtype=dtype),
            VISIBLE_BIAS: torch.zeros((layer.n_in,), dtype=dtype)}


def _weight_or_bias_reg(layer, pname):
    if pname == WEIGHT:
        return (layer.l1 or 0.0, layer.l2 or 0.0)
    return (layer.l1_bias or 0.0, layer.l2_bias or 0.0)   # b, vb


# ---------------------------------------------------------------------------
@serde.register
@dataclass
class AutoEncoder(_Feedforward, Layer):
    """Denoising autoencoder (reference AutoEncoder.java): encode
    h = act(xW + b), decode x' = act(h W^T + vb), the input corrupted while
    pretraining; the supervised forward is the encoder alone."""

    n_in: int = 0
    n_out: int = 0
    corruption_level: float = 0.3
    reconstruction_loss: str = "mse"  # "mse" | "xent" (for data in [0, 1])

    def init_params(self, gen, dtype=torch.float32):
        return _visible_layer_params(self, gen, dtype)

    def param_reg(self, pname):
        return _weight_or_bias_reg(self, pname)

    def encode(self, params, x):
        return self._act()(x @ params[WEIGHT] + params[BIAS])

    def decode(self, params, h):
        return self._act()(h @ params[WEIGHT].T + params[VISIBLE_BIAS])

    def forward(self, params, x, *, train=False, generator=None, mask=None):
        x = dropout(x, self.dropout_rate, train, generator)
        return self.encode(params, x)

    def pretrain_loss_given(self, params, x, keep: Optional[Tensor]) -> Tensor:
        """The reconstruction loss of `x` corrupted by the keep mask (None:
        uncorrupted)."""
        corrupted = x if keep is None else torch.where(keep, x, torch.zeros_like(x))
        recon = self.decode(params, self.encode(params, corrupted))
        if self.reconstruction_loss == "xent":
            eps = 1e-7
            r = torch.clamp(recon, eps, 1 - eps)
            return -torch.mean(torch.sum(x * torch.log(r)
                                         + (1 - x) * torch.log(1 - r), dim=-1))
        return torch.mean(torch.sum((recon - x) ** 2, dim=-1))

    def pretrain_loss(self, params, x, generator=None):
        """Corruption keeps each input with probability 1 - level; without a
        generator, as without a key in the JAX package, nothing is
        corrupted."""
        keep = None
        if self.corruption_level > 0 and generator is not None:
            keep = torch.rand(x.shape, generator=generator, device=x.device,
                              dtype=x.dtype) < 1.0 - self.corruption_level
        return self.pretrain_loss_given(params, x, keep)


# ---------------------------------------------------------------------------
# VAE reconstruction distributions (reference conf/layers/variational/
# {Gaussian,Bernoulli,Exponential,Composite}ReconstructionDistribution.java),
# the JAX package's four kinds:
#   "gaussian"         unit variance, D pre-out units, no constants
#   "gaussian_learned" [mean | log variance], 2 D pre-out units, full NLL
#   "bernoulli"        sigmoid logits, D pre-out units
#   "exponential"      gamma = log(lambda), D pre-out units
# A composite is a list of (kind, size) slices over the feature axis.
# ---------------------------------------------------------------------------

def _dist_pre_size(kind: str, d: int) -> int:
    return 2 * d if kind == "gaussian_learned" else d


def _dist_nll(kind: str, pre: Tensor, x: Tensor) -> Tensor:
    """Per-example negative log probability summed over the slice's
    features; `pre` [B, pre size], `x` [B, d]."""
    if kind == "bernoulli":
        return torch.sum(torch.maximum(pre, torch.zeros_like(pre)) - pre * x
                         + torch.log1p(torch.exp(-torch.abs(pre))), dim=-1)
    if kind == "gaussian":
        return 0.5 * torch.sum((pre - x) ** 2, dim=-1)
    if kind == "gaussian_learned":
        d = x.shape[-1]
        mean, log_var = pre[..., :d], pre[..., d:]
        return 0.5 * torch.sum(math.log(2 * math.pi) + log_var
                               + (x - mean) ** 2 / torch.exp(log_var), dim=-1)
    if kind == "exponential":
        # p(x) = lambda exp(-lambda x), lambda = exp(gamma)
        return torch.sum(torch.exp(pre) * x - pre, dim=-1)
    raise ValueError(f"unknown reconstruction distribution {kind!r}")


def _dist_mean(kind: str, pre: Tensor, d: int) -> Tensor:
    """E[x | pre], for generate and the reconstruction error."""
    if kind == "bernoulli":
        return torch.sigmoid(pre)
    if kind == "gaussian":
        return pre
    if kind == "gaussian_learned":
        return pre[..., :d]
    if kind == "exponential":
        return torch.exp(-pre)   # 1 / lambda
    raise ValueError(f"unknown reconstruction distribution {kind!r}")


@serde.register
@dataclass
class VariationalAutoencoder(_Feedforward, Layer):
    """VAE (reference VariationalAutoencoder.java). `n_out` is the latent
    size; the supervised forward returns the q(z|x) mean."""

    n_in: int = 0
    n_out: int = 0   # the latent size
    encoder_layer_sizes: Sequence[int] = (64,)
    decoder_layer_sizes: Sequence[int] = (64,)
    # a kind ("gaussian" | "gaussian_learned" | "bernoulli" | "exponential")
    # or a composite list of [kind, size] slices summing to n_in
    reconstruction_distribution: object = "gaussian"
    pzx_activation: str = "identity"
    num_samples: int = 1

    def _dist_slices(self) -> List[Tuple[str, int, int, int, int]]:
        """[(kind, x_lo, x_hi, pre_lo, pre_hi)] over the feature axis."""
        spec = self.reconstruction_distribution
        if isinstance(spec, str):
            spec = [(spec, self.n_in)]
        out = []
        x_lo = pre_lo = 0
        for kind, d in (tuple(s) for s in spec):
            d = int(d)
            ps = _dist_pre_size(kind, d)
            out.append((kind, x_lo, x_lo + d, pre_lo, pre_lo + ps))
            x_lo += d
            pre_lo += ps
        if x_lo != self.n_in:
            raise ValueError(
                f"composite reconstruction slices cover {x_lo} features; "
                f"layer has n_in={self.n_in}")
        return out

    def _pre_out_size(self) -> int:
        return self._dist_slices()[-1][4]

    def init_params(self, gen, dtype=torch.float32):
        """Keys e{i}W, e{i}b, mW, mb, vW, vb_ (the log variance's bias; not
        the AE/RBM vb), d{i}W, d{i}b, pW, pb; weights from `gen` in that
        order, biases zero."""
        sizes_e = [self.n_in] + list(self.encoder_layer_sizes)
        sizes_d = [self.n_out] + list(self.decoder_layer_sizes)
        w = lambda a, b: self._winit(gen, (a, b), a, b, dtype)
        zeros = lambda n: torch.zeros((n,), dtype=dtype)
        p = {}
        for i in range(len(sizes_e) - 1):
            p[f"e{i}W"] = w(sizes_e[i], sizes_e[i + 1])
            p[f"e{i}b"] = zeros(sizes_e[i + 1])
        h_e = sizes_e[-1]
        p["mW"], p["mb"] = w(h_e, self.n_out), zeros(self.n_out)
        p["vW"], p["vb_"] = w(h_e, self.n_out), zeros(self.n_out)
        for i in range(len(sizes_d) - 1):
            p[f"d{i}W"] = w(sizes_d[i], sizes_d[i + 1])
            p[f"d{i}b"] = zeros(sizes_d[i + 1])
        pre = self._pre_out_size()
        p["pW"], p["pb"] = w(sizes_d[-1], pre), zeros(pre)
        return p

    def param_reg(self, pname):
        if pname.endswith("W"):   # every weight matrix: e*, m, v, d*, p
            return (self.l1 or 0.0, self.l2 or 0.0)
        return (self.l1_bias or 0.0, self.l2_bias or 0.0)

    def _mlp(self, params, h, prefix, depth):
        act = self._act()
        for i in range(depth):
            h = act(h @ params[f"{prefix}{i}W"] + params[f"{prefix}{i}b"])
        return h

    def _decoder(self, params, z):
        """The reconstruction distribution's pre-out."""
        h = self._mlp(params, z, "d", len(self.decoder_layer_sizes))
        return h @ params["pW"] + params["pb"]

    def posterior(self, params, x) -> Tuple[Tensor, Tensor]:
        """q(z|x): (mean, log variance)."""
        h = self._mlp(params, x, "e", len(self.encoder_layer_sizes))
        mean = act_ops.resolve(self.pzx_activation)(h @ params["mW"] + params["mb"])
        return mean, h @ params["vW"] + params["vb_"]

    def forward(self, params, x, *, train=False, generator=None, mask=None):
        x = dropout(x, self.dropout_rate, train, generator)
        return self.posterior(params, x)[0]

    def generate(self, params, z) -> Tensor:
        """Decode latent samples (reference generateAtMeanGivenZ)."""
        pre = self._decoder(params, z)
        return torch.cat([_dist_mean(kind, pre[..., p0:p1], x1 - x0)
                          for kind, x0, x1, p0, p1 in self._dist_slices()],
                         dim=-1)

    def _recon_nll(self, pre, x):
        total = 0.0
        for kind, x0, x1, p0, p1 in self._dist_slices():
            total = total + _dist_nll(kind, pre[..., p0:p1], x[..., x0:x1])
        return total

    def pretrain_loss_given(self, params, x, eps: Sequence[Tensor]) -> Tensor:
        """The negative ELBO with one reparameterized draw z = mean +
        exp(log_var / 2) eps per entry of `eps` (each [B, n_out])."""
        if len(eps) != self.num_samples:
            raise ValueError(f"{len(eps)} eps draws for num_samples="
                             f"{self.num_samples}")
        mean, log_var = self.posterior(params, x)
        kl = 0.5 * torch.sum(torch.exp(log_var) + mean ** 2 - 1.0 - log_var,
                             dim=-1)
        recon_nll = 0.0
        for e in eps:
            z = mean + torch.exp(0.5 * log_var) * e
            recon_nll = recon_nll + self._recon_nll(self._decoder(params, z), x)
        recon_nll = recon_nll / self.num_samples
        return torch.mean(recon_nll + kl)

    def pretrain_loss(self, params, x, generator=None):
        """The negative ELBO, eps drawn from `generator` (default: one seeded
        0 on x's device)."""
        gen = generator or _fallback_generator(x)
        shape = (x.shape[0], self.n_out)
        eps = [torch.randn(shape, generator=gen, device=x.device, dtype=x.dtype)
               for _ in range(self.num_samples)]
        return self.pretrain_loss_given(params, x, eps)

    def reconstruction_error(self, params, x) -> Tensor:
        """The reconstruction error at z = mean (reference
        reconstructionError())."""
        mean, _ = self.posterior(params, x)
        recon = self.generate(params, mean)
        return torch.mean(torch.sum((recon - x) ** 2, dim=-1))


# ---------------------------------------------------------------------------
@serde.register
@dataclass
class RBM(_Feedforward, Layer):
    """Bernoulli-Bernoulli restricted Boltzmann machine trained by CD-k
    (reference RBM.java, HiddenUnit/VisibleUnit BINARY)."""

    n_in: int = 0
    n_out: int = 0
    cd_k: int = 1

    def init_params(self, gen, dtype=torch.float32):
        return _visible_layer_params(self, gen, dtype)

    def param_reg(self, pname):
        return _weight_or_bias_reg(self, pname)

    def prop_up(self, params, v):
        return torch.sigmoid(v @ params[WEIGHT] + params[BIAS])

    def prop_down(self, params, h):
        return torch.sigmoid(h @ params[WEIGHT].T + params[VISIBLE_BIAS])

    def forward(self, params, x, *, train=False, generator=None, mask=None):
        x = dropout(x, self.dropout_rate, train, generator)
        return self.prop_up(params, x)

    def noise_shapes(self, batch: int) -> List[Tuple[int, int]]:
        """The shapes of the 2 cd_k uniform arrays a CD-k step draws, in
        order: h0, then v and h of each Gibbs step (no h after the last)."""
        out = [(batch, self.n_out)]
        for k in range(self.cd_k):
            out.append((batch, self.n_in))
            if k < self.cd_k - 1:
                out.append((batch, self.n_out))
        return out

    def pretrain_grads_given(self, params, x, uniforms: Sequence[Tensor]):
        """CD-k from the given uniforms (`noise_shapes`): the positive phase
        from the data, the negative phase from the Gibbs chain. Returns
        (reconstruction MSE, grads) with the JAX package's sign, grads being
        what the updater descends: -(x^T h0 - vk^T hk) / B for W."""
        B = x.shape[0]
        u = iter(uniforms)
        h0p = self.prop_up(params, x)
        hs = (next(u) < h0p).to(x.dtype)
        vkp = hkp = None
        for k in range(self.cd_k):
            vkp = self.prop_down(params, hs)
            vs = (next(u) < vkp).to(x.dtype)
            hkp = self.prop_up(params, vs)
            if k < self.cd_k - 1:
                hs = (next(u) < hkp).to(x.dtype)
        grads = {
            WEIGHT: -(x.T @ h0p - vkp.T @ hkp) / B,
            BIAS: -torch.mean(h0p - hkp, dim=0),
            VISIBLE_BIAS: -torch.mean(x - vkp, dim=0),
        }
        loss = torch.mean(torch.sum((x - vkp) ** 2, dim=-1))
        return loss, grads

    def pretrain_grads(self, params, x, generator=None):
        """CD-k with its uniforms drawn from `generator` (default: one seeded
        0 on x's device). CD is not the gradient of a scalar, so autograd
        does not apply."""
        gen = generator or _fallback_generator(x)
        uniforms = [torch.rand(s, generator=gen, device=x.device, dtype=x.dtype)
                    for s in self.noise_shapes(x.shape[0])]
        with torch.no_grad():
            return self.pretrain_grads_given(params, x, uniforms)


# ---------------------------------------------------------------------------
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
