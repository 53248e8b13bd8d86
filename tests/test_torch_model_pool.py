"""The torch port's model pool (serving/model_pool.py) against the JAX
package's, on the CPU with a 4-16-3 MLP (the JAX package's gateway test
net) carried across:

- A swap from a checkpoint ZIP written by the JAX package's
  CheckpointManager serves that checkpoint: the port's answers equal the
  JAX pool's after its own swap of the same file (rtol 1e-5, atol 1e-7),
  and the swap reports the same file, iteration and precision.
- `swap(quantize="int8")` of that file answers within 1e-6 of the JAX
  pool's int8 answers (both sum the int8 products exactly and run the same
  float epilogue; the JAX side pinned to its XLA int8 arm).
- The canary and the gate give the same outcome labels in both packages
  (serving_swaps_total{outcome}): a NaN checkpoint and an over-budget drift
  are `canary_rejected`, an architecture mismatch and a torn checkpoint
  `failed`, a good one `ok`, the same file again `noop`.
- A rejected swap restores the very tensors that were serving; a live swap
  under traffic drops no request and every answer is within rtol 1e-6 of
  the old or the new parameters' answer (a coalesced batch may sum in
  another order than a direct forward: not bitwise), the new one's once the
  swap has returned.
- Fused groups: a member swap changes only its columns, a NaN member column
  trips only its breaker, eject and the ineligible fallback are counted.
- Decode entries generate `naive_generate`'s tokens; reconfigure and
  describe expose the JAX package's keys and refuse what it refuses.
"""
import os
import threading
import time

import jax
import numpy as np
import pytest
import torch

import deeplearning4j_torch as port
from deeplearning4j_torch.optimize.metrics import registry as port_registry
from deeplearning4j_torch.optimize.resilience import CheckpointManager as PortManager
from deeplearning4j_torch.serving import ModelPool as PortPool
from deeplearning4j_torch.serving import SwapError as PortSwapError
from deeplearning4j_torch.serving import decode as port_decode
from deeplearning4j_torch.utils import params as port_params
from deeplearning4j_tpu.ops import pallas_kernels
from deeplearning4j_tpu.optimize.metrics import registry as ref_registry
from deeplearning4j_tpu.optimize.resilience import CheckpointManager as RefManager
from deeplearning4j_tpu.serving import ModelPool as RefPool
from deeplearning4j_tpu.serving import SwapError as RefSwapError
from test_serving_gateway import make_net, mlp_conf, rand_x

RTOL, ATOL = 1e-5, 1e-7
INT8_ATOL = 1e-6
LIVE_RTOL = 1e-6


def port_mlp_conf(seed=42):
    return (port.NeuralNetConfiguration.builder().seed(seed)
            .updater(port.Adam(learning_rate=0.05))
            .weight_init(port.WeightInit.XAVIER)
            .list()
            .layer(port.DenseLayer(n_out=16, activation="tanh"))
            .layer(port.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(port.InputType.feed_forward(4))
            .build())


def port_twin(ref_net):
    """The port's MLP holding the JAX net's parameters, on the CPU."""
    net = port.MultiLayerNetwork(port_mlp_conf()).init(device="cpu")
    net.params_tree = port_params.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref_net.params_tree), device="cpu")
    return net


def counts(registry, name):
    fam = registry().counter("serving_swaps_total")
    return {o: fam.total(model=name, outcome=o)
            for o in ("ok", "noop", "failed", "canary_rejected")}


@pytest.fixture(scope="module")
def ref_start():
    return make_net()


@pytest.fixture(scope="module")
def trained_ckpt(tmp_path_factory):
    """A checkpoint directory written by the JAX package: the MLP after one
    fit batch."""
    d = str(tmp_path_factory.mktemp("ref_ckpt"))
    RefManager(d).save(make_net(seed=42, train_seed=1))
    return d


@pytest.fixture
def xla_arm(monkeypatch):
    monkeypatch.setitem(pallas_kernels._quant_impl, jax.default_backend(), "xla")


def _pools(ref_start, **kw):
    golden = rand_x(4, seed=3)
    ref_pool, port_pool = RefPool(), PortPool()
    ref_pool.add("m", make_net(), batch_limit=2, golden_batch=golden, **kw)
    port_pool.add("m", port_twin(ref_start), batch_limit=2, golden_batch=golden, **kw)
    return ref_pool, port_pool


def test_swap_from_reference_checkpoint_and_int8(ref_start, trained_ckpt, xla_arm):
    ref_pool, port_pool = _pools(ref_start)
    x = rand_x(3, seed=5)
    try:
        for pool in (ref_pool, port_pool):
            pool.warmup()
        got = port_pool.swap("m", manager=PortManager(trained_ckpt))
        want = ref_pool.swap("m", manager=RefManager(trained_ckpt))
        assert got == want and got["swapped"] and got["precision"] == "fp32"
        np.testing.assert_allclose(port_pool.get("m").engine.output(x),
                                   np.asarray(ref_pool.get("m").engine.output(x)),
                                   rtol=RTOL, atol=ATOL)
        got = port_pool.swap("m", manager=PortManager(trained_ckpt), quantize="int8")
        want = ref_pool.swap("m", manager=RefManager(trained_ckpt), quantize="int8")
        assert got == want and got["precision"] == "int8"
        assert port_pool.get("m").precision == "int8"
        np.testing.assert_allclose(port_pool.get("m").engine.output(x),
                                   np.asarray(ref_pool.get("m").engine.output(x)),
                                   rtol=0, atol=INT8_ATOL)
    finally:
        ref_pool.shutdown()
        port_pool.shutdown()


def _checkpoint(case, tmp_path):
    """(directory, add() keywords) for one canary/gate case, written by the
    JAX package."""
    d = str(tmp_path / case)
    mgr = RefManager(d)
    kw = {}
    if case == "nan":
        net = make_net(seed=42, train_seed=2)
        tree = jax.tree_util.tree_map(np.array, net.params_tree)
        tree[-1]["b"][0] = np.nan
        net.params_tree = jax.tree_util.tree_map(jax.numpy.asarray, tree)
        mgr.save(net)
    elif case == "drift":
        mgr.save(make_net(seed=42, train_seed=2))
        kw["canary_max_drift"] = 1e-9
    elif case == "mismatch":
        conf = mlp_conf(1)
        conf.layers[0].n_out = 9
        from deeplearning4j_tpu import MultiLayerNetwork
        mgr.save(MultiLayerNetwork(conf).init())
    elif case == "torn":
        rec = mgr.save(make_net(seed=7, train_seed=7))
        with open(os.path.join(mgr.directory, rec["file"]), "r+b") as f:
            f.write(b"\0\0\0\0")
    else:   # "ok", then "noop"
        mgr.save(make_net(seed=42, train_seed=2))
    return d, kw


@pytest.mark.parametrize("case,outcomes", [
    ("nan", ["canary_rejected"]), ("drift", ["canary_rejected"]),
    ("mismatch", ["failed"]), ("torn", ["failed"]), ("ok", ["ok", "noop"])])
def test_canary_and_gate_outcomes_match_reference(ref_start, tmp_path, case, outcomes):
    d, kw = _checkpoint(case, tmp_path)
    ref_pool, port_pool = _pools(ref_start, **kw)
    x = rand_x(2, seed=8)
    try:
        for pool, reg, mgr, err in ((ref_pool, ref_registry, RefManager(d), RefSwapError),
                                    (port_pool, port_registry, PortManager(d), PortSwapError)):
            before_out = np.asarray(pool.get("m").engine.output(x))
            before_tree = pool.get("m").model.params_tree
            seen = []
            for _ in outcomes:
                c0 = counts(reg, "m")
                try:
                    pool.swap("m", manager=mgr)
                except err:
                    pass
                c1 = counts(reg, "m")
                seen += [o for o in c1 if c1[o] != c0[o]]
            assert seen == outcomes, (pool, seen)
            if outcomes[0] != "ok":
                # refused: the very tensors that were serving, and their answers
                assert pool.get("m").model.params_tree is before_tree
                np.testing.assert_array_equal(
                    np.asarray(pool.get("m").engine.output(x)), before_out)
    finally:
        ref_pool.shutdown()
        port_pool.shutdown()


def test_live_swap_drops_nothing(ref_start, trained_ckpt):
    pool = PortPool()
    net = port_twin(ref_start)
    pool.add("m", net, checkpoints=PortManager(trained_ckpt), batch_limit=4)
    pool.warmup()
    xs = [rand_x(n, seed=20 + n) for n in (1, 2, 3)]
    old = [net.output(x) for x in xs]
    records, errors, swapped = [], [], [None]
    stop, started = threading.Event(), threading.Barrier(4, timeout=10)

    def client(c):
        try:
            started.wait()
            i = c
            while not stop.is_set():
                t = time.perf_counter()
                records.append((i % 3, t, pool.get("m").engine.output(xs[i % 3])))
                i += 1
        except BaseException as e:
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(3)]
    for t in threads:
        t.start()
    try:
        started.wait()
        time.sleep(0.02)
        assert pool.swap("m")["swapped"]
        swapped[0] = time.perf_counter()
        time.sleep(0.03)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
        pool.shutdown()
    assert not errors and not any(t.is_alive() for t in threads)
    new = [net.output(x) for x in xs]
    close = lambda a, b: np.allclose(a, b, rtol=LIVE_RTOL, atol=0)
    assert not any(close(o, n) for o, n in zip(old, new))
    after = 0
    for k, t, out in records:
        assert close(out, new[k]) or (t < swapped[0] and close(out, old[k]))
        after += t > swapped[0]
    assert after >= 1


# ------------------------------------------------------------ fused groups

def _graph_members():
    from test_torch_fused_serving import member_conf
    return {"a": port.ComputationGraph(member_conf(port, 1, 3)).init(device="cpu"),
            "b": port.ComputationGraph(member_conf(port, 2, 5)).init(device="cpu")}


def _x8(n, seed=31):
    return np.random.default_rng(seed).standard_normal((n, 8, 8, 3)).astype(np.float32)


def test_fused_group_swap_breakers_and_eject(tmp_path):
    from test_torch_fused_serving import member_conf
    members = _graph_members()
    d = str(tmp_path / "a")
    donor = port.ComputationGraph(member_conf(port, 1, 3)).init(device="cpu", seed=99)
    PortManager(d).save(donor)
    fam = port_registry().counter("serving_fused_fallback_total")
    ejected0, dissolved0 = fam.value(reason="ejected"), fam.value(reason="dissolved")
    pool = PortPool()
    group = pool.add_fused_group("g", members, checkpoints={"a": d}, batch_limit=2)
    try:
        x = _x8(2)
        ea, eb = pool.get("a"), pool.get("b")
        assert ea.group is group and eb.engine is ea.engine
        b_before = eb.engine.output(x, transform=eb.transform, tag="b")
        assert ea.engine.output(x, transform=ea.transform, tag="a").shape == (2, 3)
        assert pool.swap("a")["swapped"]
        np.testing.assert_allclose(ea.engine.output(x, transform=ea.transform, tag="a"),
                                   donor.output(x), rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(eb.engine.output(x, transform=eb.transform, tag="b"),
                                      b_before)
        # a NaN in b's columns fails b's request and trips only b's breaker
        saved = members["b"].params_tree["out"]["b"].clone()
        members["b"].params_tree["out"]["b"][0] = float("nan")
        group.fused_net.params_tree, group.fused_net.state_tree = \
            port.nn.graph.fusion.fused_trees_from_members(
                group.fusion_groups, group.named_members(),
                order=group.fused_net._layer_nodes)
        with pytest.raises(port.parallel.inference.NonFiniteOutputError):
            eb.engine.output(x, transform=eb.transform, tag="b")
        assert eb.breaker.state == "open" and ea.breaker.state == "closed"
        members["b"].params_tree["out"]["b"].copy_(saved)
        ejected = pool.eject_member("b")
        assert ejected.group is None and ea.group is None   # a group of one dissolves
        assert fam.value(reason="ejected") == ejected0 + 1
        assert fam.value(reason="dissolved") == dissolved0 + 1
        np.testing.assert_allclose(ejected.engine.output(x), members["b"].output(x),
                                   rtol=RTOL, atol=ATOL)
    finally:
        pool.shutdown()


def test_ineligible_group_falls_back_and_is_counted():
    fam = port_registry().counter("serving_fused_fallback_total")
    before = fam.value(reason="ineligible")
    pool = PortPool()
    try:
        out = pool.add_fused_group("g", [("m1", port.MultiLayerNetwork(
            port_mlp_conf()).init(device="cpu")), ("m2", port.MultiLayerNetwork(
                port_mlp_conf(7)).init(device="cpu"))])
        assert isinstance(out, list) and [e.name for e in out] == ["m1", "m2"]
        assert all(e.group is None and e.fused_fallback for e in out)
        assert fam.value(reason="ineligible") == before + 2
    finally:
        pool.shutdown()


# ------------------------------------------------------------ decode, config

def test_decode_entry_generates_naive_tokens():
    model = port_decode.TransformerDecoder(vocab=32, layers=2, heads=2, head_dim=8,
                                           ff=16, max_context=32, seed=3, device="cpu")
    pool = PortPool()
    entry = pool.add_decode("dec", model, max_decode_batch=2, pack_bucket=16,
                            kv_block_tokens=4, kv_max_blocks=32)
    try:
        pool.warmup("dec")
        prompt = [1, 5, 9, 2]
        assert entry.engine.generate(prompt, max_new_tokens=5) == \
            port_decode.naive_generate(model, prompt, 5, pad_to=16)
        assert entry.engine.device.type == "cpu"
    finally:
        pool.shutdown()


@pytest.mark.parametrize("kw", [dict(tier="gold"), dict(weight=0.0),
                                dict(batch_timeout_ms=-1.0),
                                dict(breaker_threshold=0),
                                dict(tier="batch", weight=2.0, batch_timeout_ms=1.0,
                                     breaker_threshold=3, breaker_reset_s=2.0)],
                         ids=["bad_tier", "bad_weight", "bad_linger", "bad_threshold",
                              "valid"])
def test_reconfigure_and_describe_match_reference(ref_start, kw):
    ref_pool, port_pool = _pools(ref_start)
    try:
        got = []
        for pool in (ref_pool, port_pool):
            try:
                out = pool.reconfigure("m", **kw)
                got.append(("ok", sorted(out["reconfigured"]), sorted(out)))
            except ValueError as e:
                got.append(("error", type(e).__name__))
        assert got[0] == got[1]
        assert sorted(ref_pool.get("m").describe()) == sorted(port_pool.get("m").describe())
        with pytest.raises(KeyError):
            port_pool.get("nope")
    finally:
        ref_pool.shutdown()
        port_pool.shutdown()
