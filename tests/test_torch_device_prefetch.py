"""The fit loop's device side on the card: pinned staging, device prefetch,
the fence and the device memory gauges. Marked `cuda`, skipped without a
GPU; this file imports no JAX, so the chip machine runs it:

    python -m pytest tests/test_torch_device_prefetch.py -m cuda -q --noconftest

- DevicePrefetchIterator over AlexNet-sized batches: every staged batch on
  the card is bitwise the host batch the moment the consumer gets it, over
  two epochs.
- PinnedStager: three pinned slots reused in turn, each only after its
  copy landed; bfloat16 casts on the stager's stream.
- `fit` with prefetch against `fit` without on a small CUDA network:
  bitwise the same parameters.
- The sampled fence drains the card's queue; `device_memory_stats` reads
  the caching allocator.
"""
import threading

import numpy as np
import pytest
import torch

from deeplearning4j_torch.data import iterators as it
from deeplearning4j_torch.data.dataset import DataSet
from deeplearning4j_torch.optimize import metrics as M
from deeplearning4j_torch.optimize import tracing as T


def _bounded(fn, timeout=60.0):
    """fn() on a helper thread, joined with a timeout; its result or its
    exception."""
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:  # re-raised on the test's thread
            out["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), f"did not finish within {timeout} s"
    if "error" in out:
        raise out["error"]
    return out["value"]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: staging copies to the card")


@pytest.mark.cuda
def test_pinned_device_prefetch_is_bitwise_the_host_batches_on_card():
    _cuda()
    rng = np.random.default_rng(8)
    batches = [DataSet(rng.standard_normal((64, 32, 32, 3)).astype(np.float32),
                       np.eye(10, dtype=np.float32)[rng.integers(0, 10, 64)])
               for _ in range(7)]
    a = it.DevicePrefetchIterator(it.ExistingDataSetIterator(batches), depth=2,
                                  cast_dtype=torch.float32)
    try:
        for _ in range(2):
            got = _bounded(lambda: list(a))
            assert len(got) == len(batches)
            for g, w in zip(got, batches):
                assert g.features.is_cuda and g.labels.is_cuda
                # the training thread may use them at once: the copy landed
                assert torch.equal(g.features.cpu(), torch.from_numpy(w.features))
                assert torch.equal(g.labels.cpu(), torch.from_numpy(w.labels))
                assert g._etl_h2d_ms > 0
    finally:
        _bounded(a.shutdown)


@pytest.mark.cuda
def test_pinned_stager_reuses_a_slot_only_after_its_copy_landed_on_card():
    _cuda()
    st = it.PinnedStager(slots=3)
    xs = [np.full((1024, 1024), i, np.float32) for i in range(7)]
    outs = [st.stage([x], [True], cast_dtype=torch.bfloat16)[0] for x in xs]
    pinned = [slot[0] for slot in st._slots]
    assert all(p.is_pinned() for p in pinned)
    assert len({p.data_ptr() for p in pinned}) == 3   # three slots, reused
    for i, o in enumerate(outs):
        assert o.is_cuda and o.dtype == torch.bfloat16
        assert torch.equal(o.float().cpu(), torch.full((1024, 1024), float(i)))
    assert all(ev.query() for ev in st._events)


@pytest.mark.cuda
def test_fit_with_prefetch_is_bitwise_fit_without_on_card():
    _cuda()
    import deeplearning4j_torch as port
    conf = (port.NeuralNetConfiguration.builder().seed(3).list()
            .layer(port.DenseLayer(n_out=64, activation="relu"))
            .layer(port.OutputLayer(n_out=10, activation="softmax", loss="mcxent"))
            .set_input_type(port.InputType.feed_forward(32)).build())
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1000, 32)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 1000)]
    nets = [port.MultiLayerNetwork(conf).init() for _ in range(2)]
    nets[0].fit(x, y, epochs=2, batch_size=64)
    nets[1].fit(x, y, epochs=2, batch_size=64, prefetch_to_device=False)
    for a, b in zip(nets[0].params_tree, nets[1].params_tree):
        for k in a:
            assert a[k].is_cuda and torch.equal(a[k], b[k])
    assert nets[0].last_etl_h2d_ms > 0 and nets[1].last_etl_h2d_ms == 0.0


@pytest.mark.cuda
def test_device_memory_stats_read_the_allocator_on_card():
    _cuda()
    x = torch.empty(1 << 20, device="cuda")
    stats = M.device_memory_stats()
    assert stats[0]["device"] == "cuda:0"
    assert stats[0]["bytes_in_use"] >= x.numel() * 4
    assert stats[0]["peak_bytes_in_use"] >= stats[0]["bytes_in_use"]


@pytest.mark.cuda
def test_fence_waits_for_the_card_queue():
    _cuda()
    a = torch.randn(4096, 4096, device="cuda")
    T.enable(fence_every=1)
    try:
        for _ in range(20):
            a = a @ a / 64
        loss = a.sum()
        wait = T.fence(0, loss)
        assert torch.cuda.current_stream().query()   # drained
    finally:
        T.disable()
        T.clear()
    assert wait is not None and wait > 0
