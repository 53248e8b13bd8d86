"""Recurrent layers: LSTM, GravesLSTM (peepholes), GravesBidirectionalLSTM,
and RnnOutputLayer.

Port of `deeplearning4j_tpu/nn/layers/recurrent.py` (reference
nn/layers/recurrent/LSTMHelpers.java, nn/conf/layers/{LSTM,GravesLSTM,
GravesBidirectionalLSTM,RnnOutputLayer}). The same math:

  * gate order [i, f, o, g] in the packed [*, 4H] matrices; the "i" block is
    the candidate and takes the LAYER activation, f, o and g the gate
    activation; c' = f c + g i and h' = o act(c');
  * Graves peepholes: f and g peep at c_{t-1}, o at the new c_t;
  * the forget-gate bias starts at `forget_gate_bias_init` (b[H:2H]), and
    W, RW and the peepholes draw with fan_in H and fan_out n_in + H;
  * a features mask [batch, time] zeroes h AND c at masked steps;
  * the bidirectional output is the SUM of the forward pass and the
    reversed pass, each aligned to the input positions.

The time-independent x W + b of every step is one [B*T, n_in] @ [n_in, 4H]
product (`_input_proj`); the loop over time computes only h RW, both through
`quantize.matmul_any` (float32 epilogue for bfloat16 weights). The loop is a
Python loop of plain torch ops, differentiated by autograd: the JAX package
runs no kernel of its own here (a `lax.scan` in plain XLA), and
``torch.nn.LSTM`` / cuDNN's RNN would compute another gate order without
peepholes.

Streaming state: the networks keep the carry {"h", "c"}
(RECURRENT_CARRY_KEYS) outside `state_tree` and merge it in only for truncated
BPTT windows and `rnn_time_step`; a layer handed a state with "h" starts from
it and returns the new carry, otherwise it starts from zeros and hands the
state back as it came. The carry keeps one type through the loop,
``promote_types(x, W)``, as a `lax.scan` carry must.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ...ops import activations as act_ops
from ...quantize.quantize import matmul_any
from ...utils import serde
from ..conf.inputs import InputType, RecurrentType
from .core import BIAS, WEIGHT, BaseOutputLayer, Layer, dropout

Tensor = torch.Tensor

# The streaming carry's state keys (h = hidden, c = cell): every site that
# merges the carry into a state or splits it out uses this set.
RECURRENT_CARRY_KEYS = ("h", "c")

RECURRENT_WEIGHT = "RW"
PEEP_F = "wF"
PEEP_O = "wO"
PEEP_G = "wG"


def _scan_rnn(cell, zx: Tensor, h0: Tensor, c0: Tensor, mask=None,
              reverse: bool = False):
    """Run `cell(zx_t, h, c) -> (h', c')` over the time axis of the
    pre-projected [B, T, 4H] inputs, forwards or (`reverse`) backwards,
    outputs aligned to the input positions either way. A mask [B, T]
    zeroes h and c at masked steps. Returns (ys [B, T, H], h_T, c_T)."""
    h, c = h0, c0
    m = None if mask is None else mask.to(h0.dtype)
    T = zx.shape[1]
    ys = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        h, c = cell(zx[:, t], h, c)
        h, c = h.to(h0.dtype), c.to(c0.dtype)
        if m is not None:
            mt = m[:, t, None]
            h, c = h * mt, c * mt
        ys[t] = h
    return torch.stack(ys, dim=1), h, c


@serde.register
@dataclass
class LSTM(Layer):
    """LSTM without peepholes (reference nn/conf/layers/LSTM)."""

    n_in: int = 0
    n_out: int = 0
    forget_gate_bias_init: float = 1.0
    gate_activation: str = "sigmoid"

    def input_kind(self):
        return "rnn"

    def is_recurrent(self):
        return True

    def has_params(self):
        return True

    def set_input_type(self, input_type: InputType):
        if not isinstance(input_type, RecurrentType):
            raise ValueError(f"{type(self).__name__} needs RNN input, got "
                             f"{input_type}")
        if self.n_in == 0:
            self.n_in = input_type.size
        return RecurrentType(size=self.n_out,
                             timeseries_length=input_type.timeseries_length)

    # -- params ------------------------------------------------------------
    def _has_peepholes(self) -> bool:
        return False

    def init_params(self, gen, dtype=torch.float32):
        H, n_in = self.n_out, self.n_in
        # reference LSTMParamInitializer: fanIn = nL, fanOut = nLast + nL
        fan_in, fan_out = H, n_in + H
        params = {WEIGHT: self._winit(gen, (n_in, 4 * H), fan_in, fan_out, dtype),
                  RECURRENT_WEIGHT: self._winit(gen, (H, 4 * H), fan_in, fan_out,
                                                dtype)}
        b = torch.zeros((4 * H,), dtype=dtype)
        b[H:2 * H] = self.forget_gate_bias_init
        params[BIAS] = b
        if self._has_peepholes():
            for name in (PEEP_F, PEEP_O, PEEP_G):
                params[name] = self._winit(gen, (H,), fan_in, fan_out, dtype)
        return params

    def param_reg(self, pname):
        if pname in (WEIGHT, RECURRENT_WEIGHT):
            return (self.l1 or 0.0, self.l2 or 0.0)
        if pname == BIAS:
            return (self.l1_bias or 0.0, self.l2_bias or 0.0)
        return (0.0, 0.0)

    # -- math --------------------------------------------------------------
    def _input_proj(self, params, x, prefix=""):
        """x W + b of every step, [B, T, 4H], in one product."""
        return matmul_any(x, params[prefix + WEIGHT], params[prefix + BIAS])

    def _cell(self, params, prefix=""):
        H = self.n_out
        act = self._act()
        gate = act_ops.resolve(self.gate_activation)
        RW = params[prefix + RECURRENT_WEIGHT]
        peep = self._has_peepholes()
        if peep:
            wF, wO, wG = (params[prefix + PEEP_F], params[prefix + PEEP_O],
                          params[prefix + PEEP_G])

        def cell(zxt, h, c):
            z = zxt + matmul_any(h, RW)   # [B, 4H], order [i, f, o, g]
            zi, zf, zo, zg = z[:, :H], z[:, H:2 * H], z[:, 2 * H:3 * H], z[:, 3 * H:]
            i = act(zi)   # the candidate takes the layer activation
            if peep:
                zf = zf + c * wF
                zg = zg + c * wG
            c2 = gate(zf) * c + gate(zg) * i
            if peep:
                zo = zo + c2 * wO   # the output gate peeps at the new cell
            return gate(zo) * act(c2), c2

        return cell

    def _zeros(self, batch, dtype, device):
        return torch.zeros((batch, self.n_out), dtype=dtype, device=device)

    def seed_recurrent_state(self, batch: int, dtype, device) -> dict:
        """A zero carry for `batch` rows."""
        return {"h": self._zeros(batch, dtype, device),
                "c": self._zeros(batch, dtype, device)}

    def forward(self, params, x, *, train=False, generator=None, mask=None):
        return self.forward_with_state(params, {}, x, train=train,
                                       generator=generator, mask=mask)[0]

    def forward_with_state(self, params, state, x, *, train=False,
                           generator=None, mask=None):
        """[B, T, F] -> [B, T, H], or one step [B, F] -> [B, H]. From the
        carry in `state` when it holds one (and then the new carry out),
        else from zeros (and `state` back as it came)."""
        x = dropout(x, self.dropout_rate, train, generator)
        single_step = x.ndim == 2
        if single_step:
            x = x[:, None, :]
        carry_dt = torch.promote_types(x.dtype, params[WEIGHT].dtype)
        stateful = bool(state) and "h" in state
        if stateful:
            h0, c0 = state["h"].to(carry_dt), state["c"].to(carry_dt)
        else:
            h0 = c0 = self._zeros(x.shape[0], carry_dt, x.device)
        ys, hT, cT = _scan_rnn(self._cell(params), self._input_proj(params, x),
                               h0, c0, mask)
        if single_step:
            ys = ys[:, 0]
        return ys, ({"h": hT, "c": cT} if stateful else state)


@serde.register
@dataclass
class GravesLSTM(LSTM):
    """LSTM with peephole connections (reference nn/conf/layers/GravesLSTM)."""

    def _has_peepholes(self) -> bool:
        return True


@serde.register
@dataclass
class GravesBidirectionalLSTM(GravesLSTM):
    """Bidirectional Graves LSTM: the SUM of a forward pass ("F"-prefixed
    parameters) and a reversed pass ("B"-prefixed). It needs the whole
    sequence, so it has no streaming carry."""

    def init_params(self, gen, dtype=torch.float32):
        fwd = GravesLSTM.init_params(self, gen, dtype)
        bwd = GravesLSTM.init_params(self, gen, dtype)
        out = {"F" + k: v for k, v in fwd.items()}
        out.update({"B" + k: v for k, v in bwd.items()})
        return out

    def param_reg(self, pname):
        return LSTM.param_reg(self, pname[1:])

    def supports_streaming(self) -> bool:
        return False

    def seed_recurrent_state(self, batch, dtype, device) -> dict:
        return {}

    def forward_with_state(self, params, state, x, *, train=False,
                           generator=None, mask=None):
        x = dropout(x, self.dropout_rate, train, generator)
        carry_dt = torch.promote_types(x.dtype, params["F" + WEIGHT].dtype)
        h0 = self._zeros(x.shape[0], carry_dt, x.device)
        fwd, _, _ = _scan_rnn(self._cell(params, "F"),
                              self._input_proj(params, x, "F"), h0, h0, mask)
        bwd, _, _ = _scan_rnn(self._cell(params, "B"),
                              self._input_proj(params, x, "B"), h0, h0, mask,
                              reverse=True)
        return fwd + bwd, state


@serde.register
@dataclass
class RnnOutputLayer(BaseOutputLayer):
    """Time-distributed dense + loss head over [batch, time, features]
    (reference nn/conf/layers/RnnOutputLayer): the broadcasting matmul
    distributes over time, and the labels mask [batch, time] zeroes padded
    steps in the score."""

    def input_kind(self):
        return "rnn"

    def set_input_type(self, input_type):
        if isinstance(input_type, RecurrentType):
            if self.n_in == 0:
                self.n_in = input_type.size
            return RecurrentType(size=self.n_out,
                                 timeseries_length=input_type.timeseries_length)
        raise ValueError(f"RnnOutputLayer needs RNN input, got {input_type}")
