"""chip_smoke.py's serving-plane phase (`phase_gateway`), run on the CPU at a
small size: an AlexNet-shaped net a few channels wide at 15x15x3 (two convs
each followed by LRN, two hidden dense layers and the output, so K1 runs
twice and K6 three times a forward, as in zoo AlexNet) and two zoo
GoogLeNets at 32x32x3 with 10 classes, 2 HTTP clients x 2 requests, a trainer of 2 steps at batch 4, the
decoder at vocab 64, 2 layers, 2 heads of 8, 2 clients x 2 prompts x 8
tokens, with counting stand-ins for the kernels (the plain versions, each
call counting one launch as the kernels' wrappers do): K1 for the LRN
forward, K6 for the int8 product, K7 for the decode attention.

- The phase passes: every hold of the chip run (answers over HTTP against
  in process and direct, the members against each alone, the live swap, the
  int8 swap's counts, the NaN checkpoint's rollback, the breaker, /generate
  against naive_generate, the observability routes).
- It fails when the fused group fell back to independent entries.
- It fails when a launch count is wrong (a K1 stand-in counting two
  launches a call).
"""

import numpy as np
import pytest
import torch

import chip_smoke
import deeplearning4j_torch as port
from deeplearning4j_torch.models import zoo as port_zoo
from deeplearning4j_torch.nn.graph import fusion as port_fusion
from deeplearning4j_torch.ops import flash_attention as port_fa
from deeplearning4j_torch.ops import lrn as port_lrn
from deeplearning4j_torch.ops import quant_matmul as port_qmm

class _NarrowAlexNet(port_zoo.AlexNet):
    """AlexNet's layer sequence a few channels wide (SGD at 0.1, so two
    steps move its answers visibly)."""

    def conf(self):
        h, w, c = self.input_shape
        return (port.NeuralNetConfiguration.builder()
                .seed(self.seed).activation("relu").updater(port.Sgd(0.1))
                .list()
                .layer(port.ConvolutionLayer(kernel_size=(3, 3), n_out=8))
                .layer(port.LocalResponseNormalization())
                .layer(port.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
                .layer(port.ConvolutionLayer(kernel_size=(3, 3), n_out=8))
                .layer(port.LocalResponseNormalization())
                .layer(port.DenseLayer(n_out=16))
                .layer(port.DenseLayer(n_out=16))
                .layer(port.OutputLayer(n_out=self.num_labels, activation="softmax",
                                        loss="mcxent"))
                .set_input_type(port.InputType.convolutional(h, w, c))
                .build())


SMALL = dict(alexnet=((15, 15, 3), 10), googlenet=((32, 32, 3), 10), clients=2,
             per_client=2, max_rows=2, face_clients=1, face_per_client=2,
             train_batch=4, train_steps=2, swap_clients=2, swap_inputs=2,
             int8_per_client=1, probe_rows=2, batch_limit=4,
             decode=dict(vocab=64, layers=2, heads=2, head_dim=8, ff=32,
                         max_context=64, max_decode_batch=4, block_tokens=8,
                         kv_max_blocks=64, pack_bucket=32, clients=2,
                         prompts_per_client=2, max_new_tokens=8, prompt_lo=4,
                         prompt_hi=9))


@pytest.fixture
def small_phase(monkeypatch):
    """No CUDA sync, a short breaker cooldown and tuner window, and counting
    stand-ins for K1, K6 and K7; `per_call` launches counted per K1 call."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(port_zoo, "AlexNet", _NarrowAlexNet)
    monkeypatch.setattr(chip_smoke, "GATEWAY_BREAKER",
                        dict(breaker_threshold=2, breaker_reset_s=0.2))
    monkeypatch.setattr(chip_smoke, "GATEWAY_TUNER_S", 0.3)
    # no profiler here: the profiled call runs once, unprofiled
    monkeypatch.setattr(chip_smoke, "profile_call",
                        lambda torch, label, fn, info: [fn(), {}][1])
    lrn_plain, k7_plain = port_lrn.lrn_reference, port_fa.decode_attention_reference
    qmm_plain = port_qmm.quant_matmul

    def counting(per_call=1):
        def k1(x, *h):
            port_lrn.launches += per_call
            return lrn_plain(x, *h)

        def k6(x_q, w_q):
            port_qmm.launches += 1
            return qmm_plain(x_q, w_q)

        def k7(q, k, v, cache_len):
            port_fa.decode_launches += 1
            return k7_plain(q, k, v, cache_len)

        monkeypatch.setattr(port_lrn, "lrn_fwd", k1)
        monkeypatch.setattr(port_qmm, "quant_matmul", k6)
        monkeypatch.setattr(port_fa, "decode_attention_reference", k7)

    return counting


def test_gateway_phase_passes(small_phase):
    small_phase()
    result = chip_smoke.phase_gateway(torch, "cpu", device="cpu", size=SMALL)
    assert result["launches"]["lrn_fwd"] == \
        2 * result["alexnet_forwards"] + 4 * result["fused_forwards"]
    assert result["launches"]["int8_matmul"] == 3 * result["int8"]["forwards"] > 0
    assert result["launches"]["decode_attention"] == 2 * result["decode"]["steps"] > 0
    assert result["swap"]["answers"]["after_swap"] >= 2
    assert result["swap"]["pause_ms"] is not None
    assert result["nan_checkpoint"]["outcome"] == "canary_rejected"
    assert result["observability"]["exemplars"] > 0
    assert result["observability"]["ledger_rows"] > 0
    assert np.isfinite(result["http"]["p99_ms"])


def test_gateway_phase_fails_when_the_group_fell_back(small_phase, monkeypatch):
    small_phase()

    def ineligible(named):
        raise port_fusion.FusionIneligibleError("members diverge")

    monkeypatch.setattr(port_fusion, "build_fused_serving_net", ineligible)
    with pytest.raises(RuntimeError, match="fell back"):
        chip_smoke.phase_gateway(torch, "cpu", device="cpu", size=SMALL)


def test_gateway_phase_fails_on_a_wrong_launch_count(small_phase):
    small_phase(per_call=2)
    with pytest.raises(RuntimeError, match="gateway storm: launches"):
        chip_smoke.phase_gateway(torch, "cpu", device="cpu", size=SMALL)
