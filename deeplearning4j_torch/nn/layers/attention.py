"""Self-attention layer for recurrent-shaped ([batch, time, features]) data.

Port of `deeplearning4j_tpu/nn/layers/attention.py`: the same registered
name, fields and parameters (Wq, Wk, Wv [n_in, n_out], Wo [n_out, n_out] and
their biases), routed through `ops/attention.py:single_device_attention`, or,
under an active `sequence_parallel` context whose seq axis divides the time
axis, through ring attention: inside a sequence-parallel step each shard
runs its ring (`ring_attention_shard`, heads cut over the model axis where
they divide it), on whole tensors `ring_self_attention` runs the mesh's.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass

import torch

from ...ops.attention import (active_sequence_parallel, pick_block_size,
                              ring_attention_shard, ring_self_attention,
                              single_device_attention)
from ...quantize.quantize import matmul_any
from ...utils import serde
from .. import shards
from .core import Layer, dropout

log = logging.getLogger(__name__)

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

    def _ring(self, q, k, v, mask, seg):
        """The ring's output under an active sequence_parallel context, or
        None where attention runs on one device (no context, or a time axis
        the seq axis does not divide: warned once)."""
        sp = active_sequence_parallel()
        if sp is None:
            return None
        if seg is not None:
            raise ValueError(
                "packed_segments is a single-device mode; it does not compose "
                "with sequence_parallel (the ring has no segment operand)")
        mesh, seq_axis, batch_axis, head_axis = sp
        n_seq = mesh.axis_size(seq_axis)
        ctx = shards.current()
        in_step = ctx is not None and ctx.grid is not None
        t = q.shape[1] * (n_seq if in_step and ctx.t_len else 1)
        if (in_step and not ctx.t_len) or t % n_seq:
            if not getattr(SelfAttentionLayer, "_warned_time_fallback", False):
                log.warning(
                    "sequence length %d does not divide the %d-way '%s' mesh "
                    "axis; attention runs unsharded (dense or blockwise — "
                    "sequence parallelism inactive for this window)", t,
                    n_seq, seq_axis)
                SelfAttentionLayer._warned_time_fallback = True
            return None
        h = self.n_heads
        if head_axis is not None and h % mesh.axis_size(head_axis):
            if not getattr(SelfAttentionLayer, "_warned_head_fallback", False):
                log.warning(
                    "n_heads=%d does not divide the %d-way '%s' mesh axis; "
                    "attention heads replicate (tensor parallelism inactive "
                    "for the ring)", h, mesh.axis_size(head_axis), head_axis)
                SelfAttentionLayer._warned_head_fallback = True
            head_axis = None
        block = self._pick_block(t // n_seq)
        if not in_step:
            return ring_self_attention(q, k, v, mesh, axis=seq_axis,
                                       causal=self.causal, key_mask=mask,
                                       batch_axis=batch_axis,
                                       head_axis=head_axis, block_size=block)
        grid = ctx.grid
        ring = lambda q, k, v: ring_attention_shard(
            q, k, v, grid.coords[ctx.index][2], grid.dims[2], shards.ring_hop,
            causal=self.causal, key_mask=mask, block_size=block,
            count=ctx.index == 0 and (ctx.processes is None or grid.rank == 0))
        if head_axis is None or not grid.heads:
            return ring(q, k, v)
        hs = h // grid.dims[1]
        m = grid.coords[ctx.index][1]
        part = lambda x: x[:, :, m * hs:(m + 1) * hs]
        return shards.gather_heads(ring(part(q), part(k), part(v)))

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
        out = self._ring(q, k, v, mask, seg)
        if out is None:
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
