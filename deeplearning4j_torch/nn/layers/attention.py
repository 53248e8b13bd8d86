"""Self-attention layer for recurrent-shaped ([batch, time, features]) data.

Port of `deeplearning4j_tpu/nn/layers/attention.py`: the same registered
name, fields and parameters (Wq, Wk, Wv [n_in, n_out], Wo [n_out, n_out] and
their biases), routed through `ops/attention.py:single_device_attention`. The
port has no sequence-parallel context, so the JAX package's ring branch has
no counterpart here.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ...ops.attention import pick_block_size, single_device_attention
from ...quantize.quantize import matmul_any
from ...utils import serde
from .core import Layer, dropout

W_Q, W_K, W_V, W_O = "Wq", "Wk", "Wv", "Wo"
B_Q, B_K, B_V, B_O = "bq", "bk", "bv", "bo"


@serde.register
@dataclass
class SelfAttentionLayer(Layer):
    """Multi-head self-attention over [batch, time, features]; output
    [batch, time, n_out]. `causal=True` masks future positions; the features
    mask hides padded timesteps as attention keys and zeroes them in the
    output.

    `block_size`: 0 = the dispatch rule's blockwise choice, -1 = always
    dense, > 0 = blockwise at that block whenever it divides t.
    `attention_impl`: "auto" follows `select_attention_impl`; "pallas" (the
    flash route), "blockwise" or "dense" force a path.
    `packed_segments`: the features mask carries segment ids (0 = padding,
    1..k = the sequences packed into a row); attention masks padding keys
    and every cross-segment pair."""

    n_in: int = 0
    n_out: int = 0
    n_heads: int = 4
    causal: bool = False
    block_size: int = 0
    attention_impl: str = "auto"
    packed_segments: bool = False

    def input_kind(self):
        return "rnn"

    def set_input_type(self, input_type):
        from ..conf.inputs import RecurrentType
        if not isinstance(input_type, RecurrentType):
            raise ValueError(
                f"SelfAttentionLayer needs RNN input, got {input_type}")
        if self.n_in == 0:
            self.n_in = input_type.size
        if self.n_out == 0:
            self.n_out = self.n_in
        if self.n_out % self.n_heads:
            raise ValueError(f"n_out={self.n_out} must divide into "
                             f"{self.n_heads} heads")
        return RecurrentType(size=self.n_out,
                             timeseries_length=input_type.timeseries_length)

    def has_params(self):
        return True

    def supports_streaming(self):
        # one step at a time, each step would attend to itself alone
        return False

    def param_reg(self, pname):
        if pname in (W_Q, W_K, W_V, W_O):
            return (self.l1 or 0.0, self.l2 or 0.0)
        if pname in (B_Q, B_K, B_V, B_O):
            return (self.l1_bias or 0.0, self.l2_bias or 0.0)
        return (0.0, 0.0)

    def init_params(self, gen, dtype=torch.float32):
        e, m = self.n_in, self.n_out
        p = {name: self._winit(gen, (i, o), i, o, dtype)
             for name, (i, o) in ((W_Q, (e, m)), (W_K, (e, m)), (W_V, (e, m)),
                                  (W_O, (m, m)))}
        for name in (B_Q, B_K, B_V, B_O):
            p[name] = torch.zeros((m,), dtype=dtype)
        return p

    def _pick_block(self, t: int) -> int:
        """Block size for single-device blockwise attention; 0 = dense."""
        return pick_block_size(t, self.block_size)

    def forward(self, params, x, *, train=False, generator=None, mask=None):
        x = dropout(x, self.dropout_rate, train, generator)
        b, t, _ = x.shape
        h = self.n_heads
        d = self.n_out // h
        q = matmul_any(x, params[W_Q], params[B_Q]).reshape(b, t, h, d)
        k = matmul_any(x, params[W_K], params[B_K]).reshape(b, t, h, d)
        v = matmul_any(x, params[W_V], params[B_V]).reshape(b, t, h, d)
        seg = None
        if self.packed_segments and mask is not None:
            seg = mask.to(torch.int32)
        out = single_device_attention(
            q, k, v, causal=self.causal, key_mask=mask, segment_ids=seg,
            impl=self.attention_impl, block_size=self.block_size)
        out = matmul_any(out.reshape(b, t, self.n_out), params[W_O], params[B_O])
        out = self._act()(out)
        if mask is not None:
            # padded steps output exactly 0, after the activation; packed ids
            # (1..k) are binarized first
            zm = (mask > 0) if seg is not None else mask
            out = out * zm[..., None].to(out.dtype)
        return out
