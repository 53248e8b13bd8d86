"""The decode plane of the torch port (serving/decode.py) against the JAX
package's.

The decoder is the JAX decode tests' engine model (vocab 64, 2 layers, 2
heads of 8, ff 32, max_context 64, KV blocks of 8, pack_bucket 32) with the
JAX package's `TransformerDecoder(seed=0)` weights carried across by
`utils/params.transformer_decoder_from_numpy` (the port's own draw from the
same seed is bitwise the same, which is checked too).

- Prefill logits and K/V of a packed row, and one step's logits and new
  K/V against a view, at rtol 1e-5 (atol 1e-6): float32 products and a
  softmax over at most 32 keys, summed in another order.
- `naive_generate` gives the JAX package's tokens; the smallest top-1/top-2
  logit margin met along the way is asserted above 1e-3, a hundred times
  the logit tolerance, so that equal tokens say the logits agree.
- `pack_groups` gives the JAX adapter's groups.
- The engine with 4 concurrent prompts returns `naive_generate`'s tokens
  (the port's and the JAX package's) and drains the KV cache; a
  `serve.decode_step` fault (`fail:3,4`) kills exactly one of two riders
  with DecodeStepError while the other gets every token.
- `RecurrentAdapter` through the engine against a direct `rnn_time_step`
  stream of the port and the JAX package's engine (rtol 1e-5, atol 1e-6).
- The metric families and the typed admission errors (the CUDA default is
  in tests/test_torch_isolation.py).

Every client thread is joined with a timeout that fails the test.
"""
import threading

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import deeplearning4j_torch as port
import deeplearning4j_tpu as ref
from deeplearning4j_torch.optimize.metrics import registry
from deeplearning4j_torch.parallel.inference import (DecodeStepError,
                                                     KVCacheExhaustedError,
                                                     QueueFullError,
                                                     ServerClosedError)
from deeplearning4j_torch.serving import decode as td
from deeplearning4j_torch.utils import faults
from deeplearning4j_torch.utils import params as port_params
from deeplearning4j_tpu.serving import decode as jd

VOCAB, LAYERS, HEADS, HEAD_DIM, FF, CTX, BLOCK, PACK = 64, 2, 2, 8, 32, 64, 8, 32
LOGITS = dict(rtol=1e-5, atol=1e-6)
MIN_MARGIN = 1e-3
JOIN_S = 60.0


@pytest.fixture(scope="module")
def models():
    jm = jd.TransformerDecoder(vocab=VOCAB, layers=LAYERS, heads=HEADS,
                               head_dim=HEAD_DIM, ff=FF, max_context=CTX, seed=0)
    tree = jax.tree_util.tree_map(np.asarray, jm.params_tree)
    pm = port_params.transformer_decoder_from_numpy(tree, heads=HEADS,
                                                    max_context=CTX, device="cpu")
    return jm, pm


def _engine(pm, max_decode_batch=4, kv_max_blocks=64):
    cache = td.PagedKVCache(layers=LAYERS, heads=HEADS, head_dim=HEAD_DIM,
                            block_tokens=BLOCK, max_blocks=kv_max_blocks,
                            device="cpu")
    adapter = td.TransformerAdapter(pm, cache, pack_bucket=PACK)
    eng = td.DecodeEngine(adapter, max_decode_batch=max_decode_batch,
                          device="cpu")
    eng.warmup()
    return eng, cache


def _run_clients(fns):
    """Run each fn on its own thread; every thread must end within JOIN_S."""
    out = [None] * len(fns)

    def run(i):
        try:
            out[i] = fns[i]()
        except BaseException as e:  # noqa: BLE001 (handed to the test)
            out[i] = e

    ts = [threading.Thread(target=run, args=(i,), daemon=True)
          for i in range(len(fns))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(JOIN_S)
        assert not t.is_alive(), "a client thread hung"
    return out


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, n).tolist() for n in lengths]


def test_same_seed_draws_the_same_weights(models):
    jm, pm = models
    mine = td.TransformerDecoder(vocab=VOCAB, layers=LAYERS, heads=HEADS,
                                 head_dim=HEAD_DIM, ff=FF, max_context=CTX,
                                 seed=0, device="cpu")
    want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray,
                                                            jm.params_tree))
    got = port_params.tree_leaves(mine.params_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    for g, w in zip(port_params.tree_leaves(pm.params_tree), want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_prefill_and_step_match(models):
    jm, pm = models
    rng = np.random.default_rng(0)
    row, seg, pos = (np.zeros((1, PACK), np.int32) for _ in range(3))
    for s, (lo, hi) in enumerate(((0, 5), (5, 12), (12, 29)), start=1):
        row[0, lo:hi] = rng.integers(0, VOCAB, hi - lo)
        seg[0, lo:hi] = s
        pos[0, lo:hi] = np.arange(hi - lo)
    want = [np.asarray(a) for a in jm.prefill(row, seg, pos)]
    got = [a.numpy() for a in pm.prefill(row, seg, pos)]
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **LOGITS)
    # a step of 3 rows against a 16-token view holding 4, 9 and 15 tokens
    b, kv = 3, 16
    view_k = rng.standard_normal((b, kv, LAYERS, HEADS, HEAD_DIM)).astype(np.float32)
    view_v = rng.standard_normal((b, kv, LAYERS, HEADS, HEAD_DIM)).astype(np.float32)
    lens = np.array([4, 9, 15], np.int32)
    tok = rng.integers(0, VOCAB, b).astype(np.int32)
    want = [np.asarray(a) for a in jm.step(tok, lens, view_k, view_v, lens)]
    # the port writes the new K/V into its view in place: hand it copies
    got = [a.numpy() for a in pm.step(tok, lens, torch.from_numpy(view_k.copy()),
                                      torch.from_numpy(view_v.copy()), lens)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **LOGITS)


def test_step_writes_the_new_token_into_its_view(models):
    _, pm = models
    rng = np.random.default_rng(1)
    view = torch.from_numpy(rng.standard_normal((2, 8, LAYERS, HEADS, HEAD_DIM))
                            .astype(np.float32))
    lens = torch.tensor([3, 6], dtype=torch.int32)
    _, k_new, _ = pm.step(torch.tensor([1, 2]), lens, view, view.clone(), lens)
    torch.testing.assert_close(view[[0, 1], [3, 6]], k_new, rtol=0, atol=0)


def _margins(model, prompt, n, pad_to):
    """The smallest top-1/top-2 logit gap over `n` greedy tokens."""
    toks, worst = list(prompt), np.inf
    for _ in range(n):
        t = len(toks)
        row, seg, pos = (np.zeros((1, pad_to), np.int32) for _ in range(3))
        row[0, :t], seg[0, :t], pos[0, :t] = toks, 1, np.arange(t)
        logits = model.prefill(row, seg, pos)[0][0, t - 1].numpy()
        top = np.sort(logits)[-2:]
        worst = min(worst, top[1] - top[0])
        toks.append(int(logits.argmax()))
    return worst


def test_naive_generate_matches_jax(models):
    jm, pm = models
    for p in _prompts(2, (3, 9, 17, 5)):
        want = jd.naive_generate(jm, p, 12, pad_to=PACK)
        assert td.naive_generate(pm, p, 12, pad_to=PACK) == want
        assert _margins(pm, p, 12, PACK) > MIN_MARGIN


def test_pack_groups_match_jax(models):
    jm, pm = models
    cache_j = jd.PagedKVCache(layers=LAYERS, heads=HEADS, head_dim=HEAD_DIM,
                              block_tokens=BLOCK, max_blocks=8)
    cache_p = td.PagedKVCache(layers=LAYERS, heads=HEADS, head_dim=HEAD_DIM,
                              block_tokens=BLOCK, max_blocks=8, device="cpu")
    ja = jd.TransformerAdapter(jm, cache_j, pack_bucket=16)
    pa = td.TransformerAdapter(pm, cache_p, pack_bucket=16)
    items = [(i, np.zeros(n, np.int32)) for i, n in enumerate([10, 7, 5, 16, 1, 3, 9])]
    norm = lambda gs: [[rid for rid, _ in g] for g in gs]
    assert norm(pa.pack_groups(items)) == norm(ja.pack_groups(items))
    for bad in ([], [[1, 2]], [5, 99], [-1, 2], list(range(17))):
        with pytest.raises(ValueError):
            pa.validate_prompt(bad)


def test_engine_matches_naive_and_drains(models):
    jm, pm = models
    eng, cache = _engine(pm)
    prompts = _prompts(2, (3, 9, 17, 5))
    try:
        got = _run_clients([lambda p=p: eng.generate(p, max_new_tokens=12)
                            for p in prompts])
    finally:
        eng.shutdown()
    for p, g in zip(prompts, got):
        assert g == td.naive_generate(pm, p, 12, pad_to=PACK)
        assert g == jd.naive_generate(jm, p, 12, pad_to=PACK)
    assert cache.blocks_in_use() == 0
    assert eng.total_forwards > 0 and eng.warmed_buckets == [1, 2, 4]


def test_chaos_step_isolation(models):
    """fail:3,4 = the batch attempt and the first solo retry: exactly one
    rider dies typed, its batchmate gets every token, the blocks drain and
    the engine serves afterwards."""
    _, pm = models
    eng, cache = _engine(pm)
    prompts = _prompts(3, (5, 7))
    try:
        with faults.injected("serve.decode_step", "fail:3,4"):
            out = _run_clients([lambda p=p: eng.generate(p, max_new_tokens=12)
                                for p in prompts])
        died = [o for o in out if isinstance(o, DecodeStepError)]
        lived = [o for o in out if isinstance(o, list)]
        assert len(died) == 1 and len(lived) == 1, out
        assert isinstance(died[0].__cause__, faults.FaultInjected)
        assert len(lived[0]) == 12
        assert cache.blocks_in_use() == 0
        assert eng.generate(prompts[0], max_new_tokens=4) == \
            td.naive_generate(pm, prompts[0], 4, pad_to=PACK)
    finally:
        eng.shutdown()


def test_kv_exhaustion_fails_typed_when_nothing_generates(models):
    _, pm = models
    eng, cache = _engine(pm, kv_max_blocks=2)
    try:
        with pytest.raises(KVCacheExhaustedError):
            eng.generate(list(range(20)), max_new_tokens=2)
        assert cache.blocks_in_use() == 0
        # within the cache, a request still runs
        assert len(eng.generate([1, 2, 3], max_new_tokens=3)) == 3
    finally:
        eng.shutdown()


def test_admission_errors_and_shutdown(models):
    _, pm = models
    eng, _ = _engine(pm)
    with pytest.raises(ValueError, match="max_context"):
        eng.generate(list(range(30)), max_new_tokens=40)
    with pytest.raises(ValueError):
        eng.generate([], max_new_tokens=2)
    with pytest.raises(NotImplementedError):
        eng.output(np.zeros((1, 4)))
    eng.shutdown()
    with pytest.raises(ServerClosedError):
        eng.generate([1, 2], max_new_tokens=2)
    assert issubclass(KVCacheExhaustedError, QueueFullError)


def _stream_nets(pkg, n_in=4, seed=3, **init):
    conf = (pkg.NeuralNetConfiguration.builder().seed(seed).updater(pkg.Sgd(0.1))
            .list()
            .layer(pkg.LSTM(n_out=6, activation="tanh"))
            .layer(pkg.RnnOutputLayer(n_out=n_in, activation="identity", loss="mse"))
            .set_input_type(pkg.InputType.recurrent(n_in)).build())
    return pkg.MultiLayerNetwork(conf).init(**init)


def test_recurrent_adapter_matches_direct_stream_and_jax():
    jnet = _stream_nets(ref)
    tree = jax.tree_util.tree_map(np.asarray, jnet.params_tree)

    def port_net():
        net = _stream_nets(port, device="cpu")
        net.params_tree = port_params.params_from_numpy(tree, "cpu")
        return net

    rng = np.random.default_rng(4)
    prompts = [rng.standard_normal((t, 4)).astype(np.float32) for t in (3, 5, 2)]
    eng = td.DecodeEngine(td.RecurrentAdapter(port_net(), feature_dim=4),
                          max_decode_batch=4, device="cpu")
    jeng = jd.DecodeEngine(jd.RecurrentAdapter(jnet, feature_dim=4),
                           max_decode_batch=4)
    try:
        eng.warmup()
        got = _run_clients([lambda p=p: eng.generate(p, max_new_tokens=5)
                            for p in prompts])
        want_jax = _run_clients([lambda p=p: jeng.generate(p, max_new_tokens=5)
                                 for p in prompts])
    finally:
        eng.shutdown()
        jeng.shutdown()
    for p, g, wj in zip(prompts, got, want_jax):
        assert g.shape == (5, 4)
        ref_net = port_net()
        for t in range(p.shape[0]):
            last = ref_net.rnn_time_step(p[t][None, :])[0]
        direct = []
        for _ in range(5):
            direct.append(last)
            last = ref_net.rnn_time_step(last[None, :])[0]
        np.testing.assert_allclose(g, np.asarray(direct), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(g, np.asarray(wj), rtol=1e-5, atol=1e-6)


def test_recurrent_adapter_refuses_a_layer_that_cannot_stream():
    conf = (port.NeuralNetConfiguration.builder().seed(1).list()
            .layer(port.SelfAttentionLayer(n_out=8, n_heads=2))
            .layer(port.RnnOutputLayer(n_out=4, activation="identity", loss="mse"))
            .set_input_type(port.InputType.recurrent(4)).build())
    net = port.MultiLayerNetwork(conf).init(device="cpu")
    with pytest.raises(ValueError, match="cannot stream"):
        td.RecurrentAdapter(net, feature_dim=4)


def test_metric_families(models):
    _, pm = models
    td.register_metrics()
    reg = registry()
    names = ("serving_decode_tokens_total", "serving_decode_steps_total",
             "serving_decode_prefills_total", "serving_inter_token_ms",
             "serving_kv_blocks_in_use", "serving_kv_utilization")
    text = reg.prometheus_text()
    for n in names:
        assert f"# TYPE {n}" in text
    tokens = reg.counter("serving_decode_tokens_total")
    before = tokens.value(model="metrics_test")
    cache = td.PagedKVCache(layers=LAYERS, heads=HEADS, head_dim=HEAD_DIM,
                            block_tokens=BLOCK, max_blocks=16, device="cpu")
    eng = td.DecodeEngine(td.TransformerAdapter(pm, cache, pack_bucket=PACK),
                          name="metrics_test", device="cpu")
    try:
        assert len(eng.generate([1, 2, 3], max_new_tokens=6)) == 6
    finally:
        eng.shutdown()
    assert tokens.value(model="metrics_test") - before == 6
    assert reg.counter("serving_decode_prefills_total").value(model="metrics_test") >= 1
    assert reg.counter("serving_decode_steps_total").value(model="metrics_test") >= 5
    snap = reg.snapshot()
    assert snap['serving_kv_blocks_in_use{model="metrics_test"}'] == 0
    assert snap['serving_inter_token_ms_count{model="metrics_test"}'] == 5
