"""The port's ops/attention.py against the JAX package's.

`dense_attention` and `blockwise_attention` (values and gradients through
autograd against `jax.vjp`), `select_attention_impl` making the JAX
package's choice over a table of (t, head_dim, requested, block_size) (the
JAX side with `interpret=True`, the way its rule runs where the kernel probe
passes), the per-call selection counter, and `single_device_attention` for
each impl. Inputs come from a numpy seed: b = 2, t = 32, 2 heads, head_dim
8, blocks of 8.

Tolerance in float32: rtol 1e-5 / atol 1e-6 for outputs; rtol 1e-5 / atol
1e-5 for gradients (sums of up to 32 products of O(1) terms in another
order).
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_torch.ops import attention as port_att
from deeplearning4j_tpu.ops import attention as ref_att
from test_torch_word2vec import one_torch_thread  # noqa: F401

B, T, H, D = 2, 32, 2, 8
FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-5, atol=1e-5)


def _inputs(seed, t=T):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((B, t, H, D)).astype(np.float32)
                  for _ in range(4))
    km = (rng.random((B, t)) > 0.3).astype(np.float32)
    km[:, :3] = 0.0  # causal rows 0-2 see no key
    seg = np.stack([np.repeat([1, 2, 0], [12, 12, t - 24]),
                    np.repeat([1, 2, 3], [8, 8, t - 16])]).astype(np.int32)
    return q, k, v, g, km, seg


def _port(fn, q, k, v, g, **kw):
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    kw = {n: torch.from_numpy(a) if isinstance(a, np.ndarray) else a
          for n, a in kw.items()}
    out = fn(*ts, **kw)
    out.backward(torch.from_numpy(g))
    return [out.detach().numpy()] + [t.grad.numpy() for t in ts]


def _ref(fn, q, k, v, g, **kw):
    kw = {n: jnp.asarray(a) if isinstance(a, np.ndarray) else a
          for n, a in kw.items()}
    out, vjp = jax.vjp(lambda a, b, c: fn(a, b, c, **kw),
                       *(jnp.asarray(x) for x in (q, k, v)))
    return [np.asarray(out)] + [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _assert_same(got, want):
    np.testing.assert_allclose(got[0], want[0], **FWD)
    for i, (a, b) in enumerate(zip(got[1:], want[1:])):
        np.testing.assert_allclose(a, b, err_msg=f"grad {i}", **GRAD)


MASKS = {
    "plain": lambda km, seg: {},
    "causal": lambda km, seg: {"causal": True},
    "causal_key_mask": lambda km, seg: {"causal": True, "key_mask": km},
    "segments": lambda km, seg: {"causal": True, "segment_ids": seg,
                                 "key_mask": (seg > 0).astype(np.float32)},
}


@pytest.mark.parametrize("case", list(MASKS))
def test_dense_matches_reference(case):
    q, k, v, g, km, seg = _inputs(seed=len(case))
    kw = MASKS[case](km, seg)
    _assert_same(_port(port_att.dense_attention, q, k, v, g, **kw),
                 _ref(ref_att.dense_attention, q, k, v, g, **kw))


def test_dense_kv_segment_ids_matches_reference():
    q, k, v, g, _, seg = _inputs(seed=11)
    kw = {"segment_ids": seg, "kv_segment_ids": seg[::-1].copy()}
    _assert_same(_port(port_att.dense_attention, q, k, v, g, **kw),
                 _ref(ref_att.dense_attention, q, k, v, g, **kw))
    with pytest.raises(ValueError, match="requires segment_ids"):
        port_att.dense_attention(*(torch.from_numpy(q),) * 3,
                                 kv_segment_ids=torch.from_numpy(seg))


@pytest.mark.parametrize("case,blocks", [(c, (8, 8)) for c in MASKS]
                         + [("causal_key_mask", (16, 8))])
def test_blockwise_matches_reference(case, blocks):
    q, k, v, g, km, seg = _inputs(seed=3 + len(case))
    kw = {**MASKS[case](km, seg), "q_block": blocks[0], "kv_block": blocks[1]}
    got = _port(port_att.blockwise_attention, q, k, v, g, **kw)
    _assert_same(got, _ref(ref_att.blockwise_attention, q, k, v, g, **kw))
    # and the same function as dense
    kw.pop("q_block"), kw.pop("kv_block")
    _assert_same(got, _port(port_att.dense_attention, q, k, v, g, **kw))


def test_blockwise_rejects_indivisible_blocks():
    q = torch.zeros(1, 32, 1, 8)
    with pytest.raises(ValueError, match="must divide"):
        port_att.blockwise_attention(q, q, q, q_block=12, kv_block=8)


SELECT_TABLE = [
    (t, hd, req, bs, tk)
    for t in (1, 64, 1024, 2047, 2048, 3000, 4096, 8192)
    for hd in (8, 64, 128)
    for req in (None, "auto", "pallas", "blockwise", "dense")
    for bs in (0, -1, 256, 384)
    for tk in (None,)
] + [(2048, 64, None, 0, 1024), (4096, 128, "pallas", 0, 2048),
     (4096, 128, "blockwise", 0, 4096)]


def test_select_makes_the_reference_choice():
    mismatches = []
    for t, hd, req, bs, tk in SELECT_TABLE:
        want = ref_att.select_attention_impl(t, hd, requested=req, block_size=bs,
                                             interpret=True, t_k=tk)
        got = port_att.select_attention_impl(t, hd, requested=req,
                                             block_size=bs, t_k=tk)
        if got != want:
            mismatches.append(((t, hd, req, bs, tk), got, want))
    assert not mismatches
    with pytest.raises(ValueError, match="not in"):
        port_att.select_attention_impl(64, 8, requested="flash")


def test_head_dim_beyond_the_kernels_warns_once_and_follows_the_rule(
        monkeypatch, caplog):
    """The gate is the JAX package's and the port's kernels take every
    head_dim it passes: head_dim 256 takes the flash route as the JAX
    package's does (a difference until the sliced arms). Only where the gate
    refuses (2689 at 128-row blocks) does a requested "pallas" warn, once,
    and follow the rule, the JAX package's own fallback semantics."""
    monkeypatch.setattr(port_att, "_warned_pallas", False)
    for t, hd in ((4096, 256), (64, 256), (128, 2688)):
        want = ref_att.select_attention_impl(t, hd, requested="pallas", interpret=True)
        assert want == "pallas"
        assert port_att.select_attention_impl(t, hd, requested="pallas") == want
    with caplog.at_level(logging.WARNING, logger=port_att.__name__):
        for t in (128, 256):
            want = ref_att.select_attention_impl(t, 2689, requested="pallas",
                                                 interpret=True)
            assert port_att.select_attention_impl(t, 2689, requested="pallas") \
                == want == "dense"
    assert sum("requested" in r.message for r in caplog.records
               if r.name == port_att.__name__) == 1


# the widest head of the d <= 128 kernels, one past it, the wide char
# model's, the gate's upper end at 128-row blocks and one past it
WIDE_HEAD_DIMS = (128, 129, 256, 2688, 2689)


@pytest.mark.parametrize("t", [64, 2048, 4096])
@pytest.mark.parametrize("req", [None, "auto", "pallas", "blockwise", "dense"])
def test_head_dim_beyond_the_kernels_raises_on_cuda(monkeypatch, t, req):
    """Route parity at heads wider than 128: every choice is the JAX
    package's with `interpret=True` (its gate; the sliced arms take whatever
    it passes), none raises NotImplementedError, and each call counts once.
    The choice takes no device: before the sliced arms, a CUDA device raised
    wherever the flash route was wanted above head_dim 128."""
    monkeypatch.setattr(port_att, "_warned_pallas", True)
    counts = {impl: 0 for impl in port_att.ATTENTION_IMPLS}
    monkeypatch.setattr(port_att, "attention_kernel_selected_total", counts)
    for hd in WIDE_HEAD_DIMS:
        want = ref_att.select_attention_impl(t, hd, requested=req, interpret=True)
        assert port_att.select_attention_impl(t, hd, requested=req) == want, hd
    assert sum(counts.values()) == len(WIDE_HEAD_DIMS)
    # t 4096 takes the flash route at every head_dim the gate passes
    if t == 4096 and req in (None, "auto", "pallas"):
        assert port_att.select_attention_impl(t, 2688, requested=req) == "pallas"


def test_counter_counts_every_call(monkeypatch):
    counts = {impl: 0 for impl in port_att.ATTENTION_IMPLS}
    monkeypatch.setattr(port_att, "attention_kernel_selected_total", counts)
    for t in (64, 64, 4096, 4096, 4096):
        port_att.select_attention_impl(t, 64)
    port_att.select_attention_impl(4096, 64, block_size=512)
    assert counts == {"pallas": 3, "blockwise": 1, "dense": 2}


@pytest.mark.parametrize("impl", ["pallas", "blockwise", "dense"])
def test_single_device_attention_each_impl(impl, monkeypatch):
    q, k, v, g, km, seg = _inputs(seed=17)
    counts = {i: 0 for i in port_att.ATTENTION_IMPLS}
    monkeypatch.setattr(port_att, "attention_kernel_selected_total", counts)
    kw = {"causal": True, "key_mask": km, "segment_ids": seg, "impl": impl,
          "block_size": 8}
    got = _port(port_att.single_device_attention, q, k, v, g, **kw)
    want = _ref(lambda *a, **k_: ref_att.single_device_attention(
        *a, interpret=True, **k_), q, k, v, g, **kw)
    _assert_same(got, want)
    assert counts[impl] == 1 and sum(counts.values()) == 1
