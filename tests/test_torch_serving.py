"""The torch port's ParallelInference on the CPU: answers are the network's
own rows, failures are typed, shutdown strands nobody."""
import threading
import time

import numpy as np
import pytest

import deeplearning4j_torch as port
from deeplearning4j_torch.parallel import inference as pinf
from deeplearning4j_torch.utils import faults


@pytest.fixture(scope="module")
def net():
    """An AlexNet-shaped net a few channels wide (conv, LRN, pool, dense)."""
    conf = (port.NeuralNetConfiguration.builder()
            .seed(5)
            .activation("relu")
            .list()
            .layer(port.ConvolutionLayer(kernel_size=(3, 3), stride=(2, 2),
                                         n_out=8))
            .layer(port.LocalResponseNormalization(alpha=1e-2))
            .layer(port.SubsamplingLayer(
                kernel_size=(3, 3), stride=(2, 2),
                pooling_type=port.PoolingType.MAX,
                convolution_mode=port.ConvolutionMode.SAME))
            .layer(port.DenseLayer(n_out=16))
            .layer(port.OutputLayer(n_out=4, activation="softmax"))
            .set_input_type(port.InputType.convolutional(15, 15, 3))
            .build())
    return port.MultiLayerNetwork(conf).init(device="cpu")


def _requests(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((int(rng.integers(1, 4)), 15, 15, 3)
                                ).astype(np.float32) for _ in range(n)]


def _run_clients(pi, per_client, n_clients=4):
    got, errors = {}, []

    def client(c):
        try:
            for j, x in enumerate(per_client[c]):
                got[(c, j)] = pi.output(x)
        except BaseException as e:  # surfaced by the assert below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert not errors, errors
    return got


@pytest.mark.parametrize("mode", [pinf.InferenceMode.BATCHED,
                                  pinf.InferenceMode.SEQUENTIAL])
def test_answers_are_the_rows_of_direct_output(net, mode):
    per_client = [_requests(6, seed=c) for c in range(4)]
    pi = (pinf.ParallelInference.builder(net).inference_mode(mode)
          .batch_limit(8).build())
    with pi:
        pi.warmup()
        assert pi.warmed_buckets == [1, 2, 4, 8]
        got = _run_clients(pi, per_client)
    for (c, j), out in got.items():
        want = net.output(per_client[c][j])
        # a coalesced batch runs the same float32 ops on more rows; torch's
        # CPU conv may order a row's sums differently at another batch size
        np.testing.assert_allclose(out, want, rtol=1e-6, atol=1e-7)
        assert out.shape == (per_client[c][j].shape[0], 4)
    assert pi.total_forwards >= 1
    if mode == pinf.InferenceMode.BATCHED:
        assert sum(pi.executed_batch_sizes) == sum(
            x.shape[0] for xs in per_client for x in xs)


def test_shutdown_fails_pending_requests_typed(net):
    pi = pinf.ParallelInference(net, batch_limit=4)
    results = {}

    def call(name):
        try:
            results[name] = pi.output(np.zeros((1, 15, 15, 3), np.float32))
        except BaseException as e:
            results[name] = e

    with faults.injected("serve.forward", "delay:1@400"):
        first = threading.Thread(target=call, args=("first",))
        first.start()
        deadline = time.monotonic() + 10
        while faults.call_count("serve.forward") < 1:  # forward in progress
            assert time.monotonic() < deadline
            time.sleep(0.005)
        queued = [threading.Thread(target=call, args=(f"q{i}",))
                  for i in range(3)]
        for t in queued:
            t.start()
        while pi._queue.qsize() < 3:
            assert time.monotonic() < deadline
            time.sleep(0.005)
        pi.shutdown(join_timeout=0.05)
        for t in [first] + queued:
            t.join(timeout=10)
            assert not t.is_alive()
    assert isinstance(results["first"], np.ndarray)
    for i in range(3):
        assert isinstance(results[f"q{i}"], pinf.ServerClosedError)
    with pytest.raises(pinf.ServerClosedError):
        pi.output(np.zeros((1, 15, 15, 3), np.float32))


def test_failed_forward_is_typed_and_the_server_survives(net):
    x = np.zeros((2, 15, 15, 3), np.float32)
    for mode in pinf.InferenceMode:
        with pinf.ParallelInference(net, inference_mode=mode) as pi:
            with faults.injected("serve.forward", "fail:1"):
                with pytest.raises(pinf.BatchExecutionError) as ei:
                    pi.output(x)
                assert isinstance(ei.value.__cause__, faults.FaultInjected)
                np.testing.assert_array_equal(pi.output(x), net.output(x))
            assert pi.total_batch_failures == 1


def test_expired_deadline_is_shed(net):
    x = np.zeros((1, 15, 15, 3), np.float32)
    for mode in pinf.InferenceMode:
        with pinf.ParallelInference(net, inference_mode=mode) as pi:
            with pytest.raises(pinf.DeadlineExceededError):
                pi.output(x, deadline=time.monotonic() - 1.0)
            assert pi.total_shed == 1


@pytest.mark.parametrize("spec,fails", [
    ("fail:2", [False, True, False]),
    ("fail:1,3", [True, False, True]),
    ("delay:2@1", [False, False, False]),
])
def test_fault_plan_covers_listed_calls(spec, fails):
    with faults.injected("test.point", spec):
        seen = []
        for _ in fails:
            try:
                faults.fire("test.point")
                seen.append(False)
            except faults.FaultInjected:
                seen.append(True)
        assert seen == fails
        assert faults.call_count("test.point") == len(fails)
    faults.fire("test.point")  # disarmed on exit
    assert faults.call_count("test.point") == 0


@pytest.mark.parametrize("spec", ["boom:1", "fail:0/3", "fail:0", "fail:2-x",
                                  "delay:1", "delay:1@-5"])
def test_fault_plan_rejects_unsupported_specs(spec):
    with pytest.raises(ValueError):
        faults.inject("test.point", spec)
