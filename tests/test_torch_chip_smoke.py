"""chip_smoke.py's gradient comparison, run on the CPU at a small size.

`compare_pinned_grads` compares two runs' per-parameter gradients with the
second run's ReLU and max-pool decisions pinned to the first's
(`pinned_kinks`), and fails when more than MAX_PINNED_SHARE of those
decisions would have flipped. These cases hold it to what it must tell
apart, on zoo AlexNet at 60x60x3: the same function passes with no flip;
parameters moved by 1e-3 (batch 2) or 1e-4 (batch 8), or one example of 8
moved by 1e-3, flip more than that share and fail; a backward off by 1e-3,
which flips no kink, fails on the gradients. `pinned_kinks` records every
ReLU layer and max pool, and refuses an activation whose kink it cannot pin.

For the char model, whose only kinks are its ReLUs, the same comparison is
held, on the full-width network at t 16, to the same two outcomes, with
a fault planted in each of the attention backward's cotangents alone.
`check_sgd_step` must tell a fit step from one that moves the parameters
too little. And the attention kernels' work and bound (`attention_pairs`,
`attention_bound_ms`).

For quantized serving, on the int8 AlexNet at 60x60x3: `checked_int8` must
fail a product off by one in a single sum, the launch rule
(`expected_quant_launches`: 3 int8 products and 2 LRNs a forward) must catch
a dense layer left in float32, `check_layers_against_cpu` must catch an
int8 preout that strays from the float32 one and a bfloat16 product more than
one ulp off, and `check_served_batches` must catch an answer that is not its
batch's rows.

For the LRN backward, `checked_lrn_bwd` (every K2 call of the training phase
against the plain version) must fail a stand-in that drops the transposed
window's edge channel, whose error is far above the share of the cross term
that `phase_lrn_bwd` allows; in bfloat16 too, where the check is one
bfloat16 ulp of the float32 plain version rounded once (`bf16_ulp_check`)
and the stand-in runs at alpha 1e-2, the edge cases' alpha.

The bfloat16 AlexNet phase (`phase_bf16_alexnet`) runs here end to end at
60x60x3, batch 4 and 2 steps, with stand-ins for K1 and K2 that count a
launch each as the kernels' wrappers do: it passes, and fails when one LRN
forward or backward goes around the counted wrapper.

The recurrent and face-model phases run here too, cut in size:
`phase_text_generation` (8 units, the zoo's 64 steps and tBPTT 50) passes
and fails when a committed carry keeps its autograd history;
`check_streaming` fails when the carry is lost between steps;
`phase_rnn_checkpoint` restores `mln_rnn.zip` on the CPU; `phase_face_model`
runs FaceNetNN4Small2 at 96x96; `check_nodes_one_by_one` fails on one
conv node's parameters moved by 1e-3; `bn_cancellation` measures how far a
channel's mean lies from the running mean that pivots BN's variance.

The fit-loop phases run here cut in size, with counting stand-ins for the
kernels: `phase_fit_loop_alexnet` (AlexNet at 60x60, 3 steps at batch 4)
passes, and fails when an LRN goes around K1's counted wrapper, when the
prefetch stages features one ulp off (prefetch no longer bitwise the
pageable run), or when a group drops a batch; `phase_fit_loop_char` (16
wide, bucket 32) passes, and fails when the resume restores nothing or the
sentinel's `skip_step` keeps the flagged update.
"""
import copy

import numpy as np
import pytest
import torch

import chip_smoke
from deeplearning4j_torch.data.dataset import DataSet
from deeplearning4j_torch.models import zoo as port_zoo
from deeplearning4j_torch.nn.layers.core import DenseLayer
from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_torch.ops import lrn as port_lrn
from deeplearning4j_torch.ops import quant_matmul as port_qmm
from deeplearning4j_torch.quantize import quantize as port_quant
from deeplearning4j_torch.utils import params as port_params


@pytest.fixture(autouse=True)
def torch_threads():
    """The phases cut to run here are many small ops: on a loaded machine
    (the suite's parallel workers) torch's intra-op threads wait on each
    other far longer than the ops take, so each test runs them on one
    thread (test_torch_word2vec.py's `one_torch_thread`). AlexNet's fit
    loop too: on an 8-core CPU its four cases took 76 s alone on 8 threads
    (232 s of CPU) and 84 s on one, but among the suite's workers its first
    case took 200 to 365 s on 8 threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    net = port_zoo.AlexNet(input_shape=(60, 60, 3), num_labels=10).init(device="cpu")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((8, 60, 60, 3), dtype=np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 8)]
    return net, x, y


def _run(model, bwd_scale=1.0):
    def grads(ds, record, flips):
        with chip_smoke.pinned_kinks(torch, model, record, flips):
            if bwd_scale == 1.0:
                return model.compute_gradient_and_score(ds)
            ref = port_lrn.lrn_bwd_reference
            with chip_smoke.patched(port_lrn, "lrn_bwd_reference",
                                    lambda *a: ref(*a) * bwd_scale):
                return model.compute_gradient_and_score(ds)
    return grads


def _run_with_one_row_moved(model, row):
    """`_run(model)` with the example `row` moved by 1e-3 wherever it is in
    the batch: its kinks flip, and no other row's."""
    noise = 1e-3 * np.random.default_rng(1).standard_normal(row.shape, dtype=np.float32)

    def grads(ds, record, flips):
        f = ds.features.copy()
        f[(f == row).all(axis=(1, 2, 3))] += noise * np.abs(row)
        return _run(model)(DataSet(f, ds.labels), record, flips)
    return grads


def _moved(net, scale):
    gen = torch.Generator().manual_seed(0)
    other = MultiLayerNetwork(net.conf).init(device="cpu")
    other.params_tree = tuple(
        {k: v * (1 + scale * torch.randn(v.shape, generator=gen)) for k, v in lp.items()}
        for lp in net.params_tree)
    return other


@pytest.mark.parametrize("case", ["same", "moved_params", "backward_off",
                                  "one_row_moved", "moved_params_batch_8"])
def test_compare_grads_tells_kink_flips_from_faults(setup, case):
    net, x, y = setup
    two, eight = DataSet(x[:2], y[:2]), DataSet(x, y)
    compare = lambda want, ds: chip_smoke.compare_pinned_grads(
        case, torch, port_params, _run(net), want, ds)
    if case == "same":
        out = compare(_run(net), two)
        assert out["worst_rel"] == 0.0 and out["kink_flips_pinned"] == 0
        assert out["kink_entries"] > 0
        return
    with pytest.raises(RuntimeError, match="kink decisions pinned" if case == "backward_off"
                       else "kink decisions flipped"):
        if case == "moved_params":       # 14 of 63,104 decisions flip
            compare(_run(_moved(net, 1e-3)), two)
        elif case == "moved_params_batch_8":   # 9 of 252,416
            compare(_run(_moved(net, 1e-4)), eight)
        elif case == "one_row_moved":    # 5 of 252,416, all in that row
            compare(_run_with_one_row_moved(net, x[3]), eight)
        else:
            compare(_run(net, bwd_scale=1.001), two)


def test_recorded_kinks_cover_every_layer_and_pool(setup, monkeypatch):
    net, x, y = setup
    record = []
    with chip_smoke.pinned_kinks(torch, net, record):
        net.compute_gradient_and_score(DataSet(x[:2], y[:2]))
    pools = [t for t in record if t.dtype == torch.int64]
    assert len(record) - len(pools) == 7   # the ReLUs of 5 convs and 2 dense layers
    assert len(pools) == 3   # AlexNet's three max pools
    assert all((t >= 0).all() for t in pools)
    monkeypatch.setattr(net.layers[0], "activation", "leakyrelu")
    with pytest.raises(ValueError, match="leakyrelu"):
        with chip_smoke.pinned_kinks(torch, net, []):
            pass


def test_attention_pairs_and_bound():
    """The work chip_smoke counts for the attention kernels: allowed pairs
    from the masks, and the bound from the pairs."""
    qp = torch.arange(8, dtype=torch.int32)
    assert chip_smoke.attention_pairs(torch, qp, qp, False, 2, 3) == 2 * 3 * 64
    assert chip_smoke.attention_pairs(torch, qp, qp, True, 2, 3) == 2 * 3 * 36
    km = torch.ones(2, 8)
    km[1] = 0.0
    assert chip_smoke.attention_pairs(torch, qp, qp, True, 2, 3, km=km) == 3 * 36
    seg = torch.tensor([[1, 1, 1, 2, 2, 2, 2, 0]] * 2, dtype=torch.int32)
    # causal pairs within segments: 6 + 10 + 1 (the padding id 0 matches itself)
    assert chip_smoke.attention_pairs(torch, qp, qp, True, 2, 1, qs=seg,
                                      ks=seg) == 2 * 17
    # the char model's forward: 4 x 4 x 8192 x 8193 / 2 pairs of 4 x 128 flops
    pairs = 4 * 4 * 8192 * 8193 // 2
    ms, by = chip_smoke.attention_bound_ms("flash_fwd", pairs, 128, "float32",
                                           nbytes=4 * 4 * 8192 * 512 * 4)
    assert by == "operations"
    # float32 attention is bound at the tensor cores' float32-accurate rate:
    # three TF32 products (495 TFLOP/s) for each float32 one
    assert ms == pytest.approx(4 * 128 * pairs / (495e12 / 3) * 1e3)
    assert ms == pytest.approx(1.6661, rel=1e-4)
    ms16, _ = chip_smoke.attention_bound_ms("flash_bwd_dq", pairs, 128,
                                            "bfloat16", nbytes=0)
    assert ms16 == pytest.approx(6 * 128 * pairs / 989e12 * 1e3)
    # a tiny call is bound by its bytes
    assert chip_smoke.attention_bound_ms("flash_fwd", 1, 8, "float32",
                                         nbytes=1 << 20)[1] == "bytes"


@pytest.fixture(scope="module")
def char_setup():
    conf = chip_smoke.char_conf(impl="pallas")
    net = MultiLayerNetwork(conf).init(device="cpu")
    return net, chip_smoke.char_data(2, 16, seed=1)


def _char_run(model, bwd_scales=(1.0, 1.0, 1.0)):
    """compute_gradient_and_score with the attention backward's (dq, dk, dv)
    scaled by `bwd_scales`."""
    from deeplearning4j_torch.ops import flash_attention as port_fa

    def grads(ds, record, flips):
        with chip_smoke.pinned_kinks(torch, model, record, flips):
            if bwd_scales == (1.0, 1.0, 1.0):
                return model.compute_gradient_and_score(ds)
            ref = port_fa.flash_bwd_reference
            with chip_smoke.patched(port_fa, "flash_bwd", lambda *a: tuple(
                    g * s for g, s in zip(ref(*a), bwd_scales))):
                return model.compute_gradient_and_score(ds)
    return grads


BACKWARD_OFF = {"backward_off": (1.001, 1.001, 1.001), "dq_off": (1.001, 1.0, 1.0),
                "dk_off": (1.0, 1.001, 1.0), "dv_off": (1.0, 1.0, 1.001)}


@pytest.mark.parametrize("case", ["same"] + list(BACKWARD_OFF))
def test_compare_pinned_grads_on_the_char_model(char_setup, case):
    """Pinned ReLUs: the same function passes with every decision recorded
    and none flipped; an attention backward off by 1e-3, in all three
    cotangents or in any one of them alone, fails."""
    net, ds = char_setup
    if case == "same":
        out = chip_smoke.compare_pinned_grads(case, torch, port_params,
                                              _char_run(net), _char_run(net), ds)
        assert out["worst_rel"] == 0.0 and out["kink_flips_pinned"] == 0
        # both attention layers' ReLUs: 2 x batch 2 x t 16 x width 512
        assert out["kink_entries"] == 2 * 2 * 16 * 512
        # only the key biases, whose exact gradient is 0, are left out
        assert set(out["left_out_share_of_layer"]) == {"0.bk", "1.bk"}
    else:
        with pytest.raises(RuntimeError, match="pinned"):
            chip_smoke.compare_pinned_grads(
                case, torch, port_params, _char_run(net),
                _char_run(net, bwd_scales=BACKWARD_OFF[case]), ds)


@pytest.mark.parametrize("case", ["float32", "no_update", "half_update"])
def test_check_sgd_step(char_setup, case):
    """One fit step must move every parameter by lr x its gradient: a real
    step passes, a fit that applies no update or half of it fails."""
    conf, ds = char_setup[0].conf, char_setup[1]
    net = MultiLayerNetwork(conf).init(device="cpu")
    if case == "float32":
        out = chip_smoke.check_sgd_step(torch, net, ds, chip_smoke.CHAR_LR,
                                        need_visible=True)
        assert set(out) == {f"{i}.{k}" for i, lp in enumerate(net.params_tree)
                            for k in lp}
        assert max(r["moved_share"] for r in out.values()) > 0.5
        return
    fit = net.fit
    scale = 0.0 if case == "no_update" else 0.5

    def partial_fit(data, **kw):
        before = net.params_tree
        fit(data, **kw)
        net.params_tree = tuple({k: b + (a - b) * scale for (k, a), b in
                                 zip(la.items(), lb.values())}
                                for la, lb in zip(net.params_tree, before))
        return net

    with chip_smoke.patched(net, "fit", partial_fit), \
            pytest.raises(RuntimeError, match="from p - lr g"):
        chip_smoke.check_sgd_step(torch, net, ds, chip_smoke.CHAR_LR,
                                  need_visible=True)


def test_pinned_relus_take_the_recorded_branch(char_setup):
    """A second run pinned to the first's decisions takes the first's ReLU
    branch even where its own input says otherwise, and counts those flips."""
    net, ds = char_setup
    masks, flips = [], []
    with chip_smoke.pinned_kinks(torch, net, masks):
        net.compute_gradient_and_score(ds)
    flipped = [~m for m in masks]
    with chip_smoke.pinned_kinks(torch, net, flipped, flips):
        net.compute_gradient_and_score(ds)
    # the first layer's input is the same, so every decision flipped; the
    # second layer's input changed with the first layer's output
    assert flips[0] == int(masks[0].numel()) and 0 < flips[1]
    assert len(flips) == len(masks) == 2


def _dropped_edge_lrn_bwd(x, g, k, alpha, beta, n):
    """A K2 stand-in whose transposed window stops one channel short of its
    top edge: right in every term but the cross-channel one."""
    up = n // 2
    down = n - 1 - up
    d = k + alpha * port_lrn.window_sum(x * x, up, down)
    p = d.pow(-beta)
    u = port_lrn.window_sum(g * x * p / d, down, up - 1)
    return g * p - 2.0 * alpha * beta * x * u


@pytest.mark.parametrize("case", ["plain", "edge_channel_dropped"])
def test_checked_lrn_bwd_catches_a_dropped_edge_channel(monkeypatch, case):
    """checked_lrn_bwd, which holds every K2 call of the training phase to
    the plain backward, at AlexNet's LRN constants: a backward that drops the
    transposed window's edge channel fails it, and its error is far above the
    share of the cross term that phase_lrn_bwd allows."""
    rng = np.random.default_rng(11)
    x, g = (torch.from_numpy(rng.standard_normal((2, 5, 5, 64), dtype=np.float32))
            for _ in range(2))
    hyper = (chip_smoke.LRN_K, chip_smoke.LRN_ALPHA, chip_smoke.LRN_BETA,
             chip_smoke.LRN_N)
    if case != "plain":
        monkeypatch.setattr(port_lrn, "lrn_bwd", _dropped_edge_lrn_bwd)
        err = (_dropped_edge_lrn_bwd(x, g, *hyper)
               - port_lrn.lrn_bwd_reference(x, g, *hyper)).abs().max().item()
        cross = chip_smoke.lrn_cross_term(x, g, *hyper).abs().max().item()
        assert err > 10 * chip_smoke.CROSS_SHARE * cross
    stats = {"calls": 0, "max_abs_err": 0.0, "max_abs_dx": 0.0,
             "max_cross_term": 0.0, "cotangent_contiguous": []}
    xr = x.clone().requires_grad_()
    with chip_smoke.checked_lrn_bwd(torch, stats):
        y = port_lrn.lrn(xr, *hyper)
        if case == "plain":
            y.backward(g)
        else:
            with pytest.raises(AssertionError):
                y.backward(g)
    if case == "plain":
        assert stats["calls"] == 1 and stats["max_abs_err"] == 0.0
        assert stats["cotangent_contiguous"] == [True]
        assert 0 < stats["max_cross_term"] < stats["max_abs_dx"]


@pytest.mark.parametrize("case", ["plain", "edge_channel_dropped"])
def test_checked_lrn_bwd_catches_a_dropped_edge_channel_in_bfloat16(monkeypatch, case):
    """The same for a bfloat16 backward, held within one bfloat16 ulp of the
    float32 plain version rounded once: at alpha 1e-2 (the edge cases of
    phase_lrn_bwd) the dropped channel moves dx by many ulps."""
    rng = np.random.default_rng(12)
    x, g = (torch.from_numpy(rng.standard_normal((2, 5, 5, 64), dtype=np.float32)
                             * s).to(torch.bfloat16) for s in (3.0, 1.0))
    hyper = (chip_smoke.LRN_K, 1e-2, chip_smoke.LRN_BETA, chip_smoke.LRN_N)
    plain = port_lrn.lrn_bwd_reference

    def rounded_once(x, g, *h):  # what K2 computes: float32, rounded once
        return plain(x.float(), g.float(), *h).to(torch.bfloat16)

    def dropped(x, g, *h):
        return _dropped_edge_lrn_bwd(x.float(), g.float(), *h).to(torch.bfloat16)

    monkeypatch.setattr(port_lrn, "lrn_bwd", rounded_once if case == "plain" else dropped)
    if case != "plain":
        err = (dropped(x, g, *hyper).float() - rounded_once(x, g, *hyper).float()).abs()
        assert err.max().item() > 8 * chip_smoke.BF16_ULP * rounded_once(
            x, g, *hyper).float().abs().max().item()
    stats = {"calls": 0, "max_abs_err": 0.0, "max_abs_dx": 0.0,
             "max_cross_term": 0.0, "cotangent_contiguous": []}
    xr = x.clone().requires_grad_()
    with chip_smoke.checked_lrn_bwd(torch, stats):
        y = port_lrn.lrn(xr, *hyper)
        if case == "plain":
            y.backward(g)
        else:
            with pytest.raises(RuntimeError, match="beyond one ulp"):
                y.backward(g)
    if case == "plain":
        assert stats["calls"] == 1 and stats["max_abs_err"] == 0.0
        assert stats["limit_share"] == 0.0 and stats["max_cross_term"] > 0


@pytest.mark.parametrize("ulps,ok", [(0, True), (1, True), (2, False)])
def test_bf16_ulp_check(ulps, ok):
    """One bfloat16 ulp from the rounded yardstick passes, two fail: the
    values are moved by whole steps of their bfloat16 bits."""
    want32 = torch.tensor([0.3, -1.7, 2.0, 1000.0, 3e-3])
    want = want32.to(torch.bfloat16)
    got = (want.view(torch.int16) + ulps).view(torch.bfloat16)
    if ok:
        err, share = chip_smoke.bf16_ulp_check(torch, "t", got, want32, 0.0)
        # one ulp is just under its limit (ulp + LRN_RTOL |want|)
        assert (share == 0.0) if ulps == 0 else (0.99 < share <= 1.0)
    else:
        with pytest.raises(RuntimeError, match="beyond one ulp"):
            chip_smoke.bf16_ulp_check(torch, "t", got, want32, 0.0)


def test_lrn_bounds_take_the_element_size():
    """AlexNet's two LRN calls at batch 128: 4 bytes an element forward and
    6 backward in bfloat16, 8 and 12 in float32."""
    numel = [128 * 55 * 55 * 64, 128 * 14 * 14 * 192]
    fwd16 = sum(chip_smoke.lrn_bound_ms(m, 5, elem=2)[0] for m in numel)
    bwd16 = sum(chip_smoke.lrn_bwd_bound_ms(m, 5, elem=2)[0] for m in numel)
    assert fwd16 == pytest.approx(0.0353, abs=1e-4)
    assert bwd16 == pytest.approx(0.0530, abs=1e-4)
    assert sum(chip_smoke.lrn_bound_ms(m, 5)[0] for m in numel) == pytest.approx(2 * fwd16)
    assert chip_smoke.lrn_bwd_bound_ms(numel[0], 5, elem=2)[1] == "bytes"


class _SmallAlexNet(port_zoo.AlexNet):
    """Zoo AlexNet at 60x60x3 that initializes on the CPU when no device is
    named (the real one goes to CUDA)."""

    def __init__(self):
        super().__init__(input_shape=(60, 60, 3))

    def init(self, seed=None, dtype=torch.float32, device="cpu"):
        return super().init(seed=seed, dtype=dtype, device=device)


@pytest.fixture
def small_bf16_phase(monkeypatch):
    """phase_bf16_alexnet cut to run here: 60x60x3, 2 clients x 2 requests,
    2 steps at batch 4, no profiler, no CUDA sync. K1 and K2 are stand-ins
    that count a launch per call, as the kernels' wrappers do, and compute
    what the kernels compute (float32, rounded once)."""
    monkeypatch.setattr(port_zoo, "AlexNet", _SmallAlexNet)
    monkeypatch.setattr(chip_smoke, "TRAIN_BATCH", 4)
    monkeypatch.setattr(chip_smoke, "TRAIN_STEPS", 2)
    monkeypatch.setattr(chip_smoke, "serving_requests", lambda rng: [
        [rng.standard_normal((int(rng.integers(1, 3)), 60, 60, 3)).astype(np.float32)
         for _ in range(2)] for _ in range(2)])
    monkeypatch.setattr(chip_smoke, "profile_call", lambda torch, label, fn, info: {})
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    fwd, bwd = port_lrn.lrn_reference, port_lrn.lrn_bwd_reference

    def k1(x, *h):
        port_lrn.launches += 1
        return fwd(x.float(), *h).to(x.dtype)

    def k2(x, g, *h):
        port_lrn.bwd_launches += 1
        return bwd(x.float(), g.float(), *h).to(x.dtype)

    monkeypatch.setattr(port_lrn, "lrn_fwd", k1)
    monkeypatch.setattr(port_lrn, "lrn_bwd", k2)
    return fwd, bwd


@pytest.mark.parametrize("case", ["counted", "forward_uncounted", "backward_uncounted"])
def test_bf16_alexnet_phase_counts_its_launches(small_bf16_phase, monkeypatch, case):
    from deeplearning4j_torch.nn.layers.convolution import LocalResponseNormalization
    fwd, bwd = small_bf16_phase
    if case == "forward_uncounted":   # the second LRN layer goes around K1
        layer_fwd = LocalResponseNormalization.forward

        def forward(self, params, x, **kw):
            if x.shape[-1] == 192:
                return fwd(x.contiguous(), self.k, self.alpha, self.beta, self.n)
            return layer_fwd(self, params, x, **kw)

        monkeypatch.setattr(LocalResponseNormalization, "forward", forward)
    elif case == "backward_uncounted":   # a backward that skips the count
        k2 = port_lrn.lrn_bwd
        monkeypatch.setattr(port_lrn, "lrn_bwd", lambda x, g, *h: (
            bwd(x.float(), g.float(), *h).to(x.dtype) if x.shape[-1] == 64
            else k2(x, g, *h)))
    if case == "counted":
        out = chip_smoke.phase_bf16_alexnet(torch, "cpu")
        s, t = out["serving"], out["training"]
        assert s["launches"] == {"lrn_fwd": 2 * s["forwards"], "lrn_bwd": 0}
        assert t["launches"] == {"lrn_fwd": 4, "lrn_bwd": 4}
        assert s["lrn_in_forward"]["calls"] == 2 * out["batches_rechecked"]
        assert t["lrn_bwd_in_step"]["calls"] == 4
        assert len(out["layers_vs_cpu"]) == 13   # every layer of AlexNet
        assert all(r["max_abs_card_vs_cpu"] == 0.0 for r in out["layers_vs_cpu"])
        assert t["score_card"] == t["score_cpu"]
    else:
        with pytest.raises(RuntimeError, match="launches"):
            chip_smoke.phase_bf16_alexnet(torch, "cpu")


# ------------------------------------------------------------ quantized serving
def _quantized(net, mode, float_layers=()):
    """A shallow copy of `net` serving its tree quantized to `mode`, with the
    layers in `float_layers` left as they were."""
    qnet = copy.copy(net)
    tree = port_quant.quantize_tree(net.params_tree, mode)
    qnet.params_tree = tuple(net.params_tree[i] if i in float_layers else lp
                             for i, lp in enumerate(tree))
    return qnet


@pytest.mark.parametrize("case", ["same", "output_layer_off_by_one"])
def test_checked_int8_holds_every_product_bitwise(setup, monkeypatch, case):
    net, x, _ = setup
    qnet = _quantized(net, "int8")
    if case != "same":
        plain = port_qmm.quant_matmul

        def stand_in(x_q, w_q):  # one sum of the output layer's product off by one
            out = plain(x_q, w_q)
            if w_q.shape[0] == 10:
                out[0, 3] += 1
            return out

        monkeypatch.setattr(port_qmm, "quant_matmul", stand_in)
    stats = {"calls": 0, "shapes": set(), "max_abs_sum": 0}
    with chip_smoke.checked_int8(torch, stats):
        if case == "same":
            qnet.output(x[:2])
        else:
            with pytest.raises(RuntimeError, match="1 sums differ"):
                qnet.output(x[:2])
    if case == "same":
        assert stats["calls"] == 3 and len(stats["shapes"]) == 3
        assert stats["max_abs_sum"] > 0


@pytest.mark.parametrize("mode,float_layer,ok", [
    ("int8", None, True), ("bf16", None, True),
    ("int8", 0, False), ("int8", 1, False), ("int8", 2, False)],
    ids=["int8", "bf16", "fc6_missed", "fc7_missed", "output_missed"])
def test_launch_rule_catches_a_missed_layer(setup, monkeypatch, mode, float_layer, ok):
    net, x, _ = setup
    dense = [i for i, layer in enumerate(net.layers) if isinstance(layer, DenseLayer)]
    qnet = _quantized(net, mode, () if float_layer is None else (dense[float_layer],))
    counts = {"int8_matmul": 0, "lrn_fwd": 0}

    def counting(name, fn):
        def wrapped(*a):
            counts[name] += 1
            return fn(*a)
        return wrapped

    monkeypatch.setattr(port_qmm, "quant_matmul",
                        counting("int8_matmul", port_qmm.quant_matmul))
    monkeypatch.setattr(port_lrn, "lrn", counting("lrn_fwd", port_lrn.lrn))
    for rows in (1, 3):
        qnet.output(x[:rows])
    want = chip_smoke.expected_quant_launches(qnet, mode, 2)
    assert want == {"int8_matmul": 6 if mode == "int8" else 0, "lrn_fwd": 4}
    if ok:
        chip_smoke.check_launches(mode, counts, want)
    else:
        with pytest.raises(RuntimeError, match="launches"):
            chip_smoke.check_launches(mode, counts, want)


@pytest.mark.parametrize("mode,fault", [("int8", None), ("int8", "fp32_scaled"),
                                        ("bf16", None), ("bf16", "cpu_w_scaled")])
def test_check_layers_against_cpu(setup, mode, fault):
    """Card and CPU are both the CPU here, so the same tree passes; an int8
    preout that strays from the float32 one, or a bfloat16 product that
    differs by more than one ulp, fails."""
    net, x, _ = setup
    qnet, other = _quantized(net, mode), _quantized(net, mode)
    fp32 = net.params_tree
    if fault == "fp32_scaled":
        fp32 = tuple({k: v * 1.1 if k == "W" else v for k, v in lp.items()} for lp in fp32)
    elif fault == "cpu_w_scaled":
        other.params_tree = tuple(
            {k: v * 1.05 if k == "W" and v.ndim == 2 else v for k, v in lp.items()}
            for lp in other.params_tree)
    if fault is None:
        rows, out = chip_smoke.check_layers_against_cpu(torch, qnet, other, fp32, x[:2])
        np.testing.assert_array_equal(out, other.output(x[:2]))
        assert [r["layer"] for r in rows] == [0] + [
            i for i, layer in enumerate(net.layers) if isinstance(layer, DenseLayer)]
        assert all(r["max_abs_card_vs_cpu"] == 0.0 for r in rows)
        assert all(0 < r["max_abs_vs_fp32"] <= r.get("envelope", np.inf) for r in rows[1:])
    else:
        with pytest.raises(RuntimeError, match="envelope|bfloat16 ulp"):
            chip_smoke.check_layers_against_cpu(torch, qnet, other, fp32, x[:2])


@pytest.mark.parametrize("case", ["served", "rows_swapped", "not_served"])
def test_check_served_batches(setup, case):
    net, x, _ = setup
    reqs = [[x[:2], x[2:3]], [x[3:6]]]
    bx = np.concatenate([x[:2], x[3:6], x[2:3], x[2:3]])  # padded by its tail row
    batches = [(bx, net.output(bx))]
    answers = {(0, 0): batches[0][1][:2], (1, 0): batches[0][1][2:5],
               (0, 1): batches[0][1][5:6]}
    if case == "rows_swapped":
        answers[(0, 0)] = answers[(0, 0)][::-1]
    elif case == "not_served":
        reqs[0][1] = x[6:7]
    if case == "served":
        assert chip_smoke.check_served_batches(net, batches, reqs, answers) == 1
    else:
        with pytest.raises(RuntimeError, match="batch"):
            chip_smoke.check_served_batches(net, batches, reqs, answers)


def test_quant_noise_share():
    fp32 = np.full((2, 5), 0.2, np.float32)
    want = fp32 + np.float32(1e-3)  # quantization moved the answer by 1e-3
    got = want.copy()
    got[1, 3] += np.float32(5e-4)
    assert chip_smoke.quant_noise_share(got, want, fp32) == pytest.approx(0.5, rel=1e-3)
    assert chip_smoke.quant_noise_share(want, want, fp32) == 0.0


_PTXAS_SAMPLE = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN41_INTERNAL_8b3c_18_flash_attention_cu_6955af2c20flash_bwd_dkv_kernelI13__nv_bfloat16Li8EEEvNS_4AttnENS_3BwdEiPT_S5_' for 'sm_90a'
ptxas info    : Function properties for _ZN41_INTERNAL_8b3c_18_flash_attention_cu_6955af2c20flash_bwd_dkv_kernelI13__nv_bfloat16Li8EEEvNS_4AttnENS_3BwdEiPT_S5_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 186 registers, used 2 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116flash_fwd_kernelIfLi1EEEvNS_4AttnEiPT_Pf' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116flash_fwd_kernelIfLi1EEEvNS_4AttnEiPT_Pf
    24 bytes stack frame, 36 bytes spill stores, 28 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118int8_matmul_kernelILi32ELb1EEEvPKaS2_PKfS4_Pfiii' for 'sm_90a'
ptxas info    : Used 128 registers, used 1 barriers, 18432 bytes smem
ptxas info    : Compiling entry function '_Z14lrn_fwd_kernelPKfPfiiiffff' for 'sm_90a'
ptxas info    : Used 32 registers, used 0 barriers
"""


def test_ptxas_report_names_every_instantiation():
    """The build phase's record of each kernel: its name with its template
    arguments (float and bf16 told apart, integers, booleans) past nvcc's
    namespace prefix, its registers and its spill bytes."""
    report = chip_smoke.ptxas_report(_PTXAS_SAMPLE)
    assert [r["kernel"] for r in report] == [
        "flash_bwd_dkv_kernel<bf16, 8>", "flash_fwd_kernel<float, 1>",
        "int8_matmul_kernel<32, true>", "lrn_fwd_kernel"]
    assert report[0] == {"kernel": "flash_bwd_dkv_kernel<bf16, 8>", "stack": 0,
                         "spill_stores": 0, "spill_loads": 0, "registers": 186}
    assert (report[1]["spill_stores"], report[1]["spill_loads"],
            report[1]["registers"]) == (36, 28, 255)
    assert report[3] == {"kernel": "lrn_fwd_kernel", "registers": 32}
    assert report[2]["smem"] == 18432 and "smem" not in report[0]


# ------------------------------------------- checkpoints and GoogLeNet phases
class _SmallGoogLeNet(port_zoo.GoogLeNet):
    """Zoo GoogLeNet at 32x32x3 with 10 classes that initializes on the CPU
    when no device is named (the real one goes to CUDA)."""

    def __init__(self, num_labels=10, fuse_siblings=False, **kw):
        super().__init__(num_labels=10, input_shape=(32, 32, 3),
                         fuse_siblings=fuse_siblings)

    def init(self, seed=None, dtype=torch.float32, device="cpu"):
        return super().init(seed=seed, dtype=dtype, device=device)


@pytest.fixture
def small_googlenet_phases(monkeypatch, tmp_path):
    """The GoogLeNet phases cut to run here: 32x32x3, 2 clients x 2
    requests, 2 steps at batch 4 in both types, no profiler, no device
    timing, no CUDA sync; checkpoints under a temporary directory. K1 and
    K2 are counting stand-ins, as in `small_bf16_phase`."""
    monkeypatch.setattr(port_zoo, "GoogLeNet", _SmallGoogLeNet)
    for name, value in (("GOOGLENET_BATCH", 4), ("GOOGLENET_STEPS", 2),
                        ("GOOGLENET_BF16_BATCH", 4), ("GOOGLENET_BF16_STEPS", 2),
                        ("ROOT", str(tmp_path))):
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(chip_smoke, "serving_requests", lambda rng: [
        [rng.standard_normal((int(rng.integers(1, 3)), 32, 32, 3)).astype(np.float32)
         for _ in range(2)] for _ in range(2)])
    monkeypatch.setattr(chip_smoke, "profile_call", lambda torch, label, fn, info: {})
    monkeypatch.setattr(chip_smoke, "forward_ms", lambda torch, net, x: 0.0)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a: None)
    fwd, bwd = port_lrn.lrn_reference, port_lrn.lrn_bwd_reference

    def k1(x, *h):
        port_lrn.launches += 1
        return fwd(x.float(), *h).to(x.dtype)

    def k2(x, g, *h):
        port_lrn.bwd_launches += 1
        return bwd(x.float(), g.float(), *h).to(x.dtype)

    monkeypatch.setattr(port_lrn, "lrn_fwd", k1)
    monkeypatch.setattr(port_lrn, "lrn_bwd", k2)
    return fwd, bwd


def _uncounted(monkeypatch, case, fwd, bwd):
    """Route GoogLeNet's lrn2 (192 channels) around the counted K1 or K2."""
    from deeplearning4j_torch.nn.layers.convolution import LocalResponseNormalization
    if case == "forward_uncounted":
        layer_fwd = LocalResponseNormalization.forward

        def forward(self, params, x, **kw):
            if x.shape[-1] == 192:
                return fwd(x.contiguous(), self.k, self.alpha, self.beta, self.n)
            return layer_fwd(self, params, x, **kw)

        monkeypatch.setattr(LocalResponseNormalization, "forward", forward)
    elif case == "backward_uncounted":
        k2 = port_lrn.lrn_bwd
        monkeypatch.setattr(port_lrn, "lrn_bwd", lambda x, g, *h: (
            bwd(x.float(), g.float(), *h).to(x.dtype) if x.shape[-1] == 192
            else k2(x, g, *h)))


@pytest.mark.parametrize("case", ["counted", "forward_uncounted"])
def test_googlenet_serving_phase_counts_its_launches(small_googlenet_phases,
                                                     monkeypatch, case):
    _uncounted(monkeypatch, case, *small_googlenet_phases)
    if case != "counted":
        with pytest.raises(RuntimeError, match="launches"):
            chip_smoke.phase_googlenet_serving(torch, "cpu")
        return
    out = chip_smoke.phase_googlenet_serving(torch, "cpu")
    assert out["launches"] == {"lrn_fwd": 2 * out["forwards"], "lrn_bwd": 0}
    assert out["lrn_in_forward"]["calls"] == 2 * out["batches_rechecked"]
    assert out["fused_groups"] == 9
    assert out["fused_max_abs_vs_unfused"] <= 1e-6
    assert out["max_abs_card_vs_cpu_b2"] == 0.0   # both on the CPU here


@pytest.mark.parametrize("case", ["counted", "forward_uncounted", "backward_uncounted"])
def test_googlenet_training_phase_counts_its_launches(small_googlenet_phases,
                                                      monkeypatch, case):
    _uncounted(monkeypatch, case, *small_googlenet_phases)
    if case != "counted":
        with pytest.raises(RuntimeError, match="launches"):
            chip_smoke.phase_googlenet_training(torch, "cpu")
        return
    out = chip_smoke.phase_googlenet_training(torch, "cpu")
    assert out["launches"] == {"lrn_fwd": 4, "lrn_bwd": 4}
    assert out["lrn_bwd_in_step"]["calls"] == 4
    # both on the CPU here: the same decisions, the replayed max pools'
    # cotangents summed in another order
    assert out["grad_rel_vs_cpu"]["kink_flips_pinned"] == 0
    assert out["grad_rel_vs_cpu"]["worst_rel"] < 1e-5
    assert out["checkpoint"]["bitwise"] == {k: True for k in out["checkpoint"]["bitwise"]}
    bf16 = out["bf16"]
    assert bf16["launches"] == {"lrn_fwd": 4, "lrn_bwd": 4}
    assert bf16["lrn_in_forward"]["calls"] == bf16["lrn_bwd_in_step"]["calls"] == 4
    assert bf16["checkpoint"]["dtype"] == "bfloat16"


def test_checkpoint_round_trip_check_fails_on_a_changed_leaf(monkeypatch, tmp_path):
    from deeplearning4j_torch.utils import model_serializer as port_ser
    monkeypatch.setattr(chip_smoke, "ROOT", str(tmp_path))
    net = port_zoo.LeNet().init(device="cpu")
    x = np.zeros((2, 28, 28, 1), np.float32)
    assert chip_smoke.check_checkpoint_round_trip(net, x, "lenet")["bytes"] > 0
    restore = port_ser.restore_model

    def off_by_one_ulp(path, **kw):
        back = restore(path, **kw)
        w = back.params_tree[0]["W"]
        back.params_tree[0]["W"] = torch.nextafter(w, w + 1)
        return back

    monkeypatch.setattr(port_ser, "restore_model", off_by_one_ulp)
    with pytest.raises(RuntimeError, match="not bitwise"):
        chip_smoke.check_checkpoint_round_trip(net, x, "lenet")


def test_checkpoint_fixtures_phase_runs_on_the_cpu():
    out = chip_smoke.phase_checkpoint_fixtures(torch, "cpu", device="cpu")
    assert out["lenet_iteration"] == 48 and out["graph_merge_iteration"] == 6
    assert out["lenet_max_abs_card_vs_cpu"] == 0.0
    assert out["graph_merge_max_abs_vs_expected"] < 1e-6


def test_lrn_cases_hold_googlenets_two_calls():
    groups = {}
    for label, shape, n, alpha, scale, group in chip_smoke.LRN_CASES:
        groups.setdefault(group, []).append(shape)
    assert groups["googlenet"] == [(64, 56, 56, 64), (64, 56, 56, 192)]
    assert groups["alexnet"] == [(128, 55, 55, 64), (128, 14, 14, 192)]
    rows = [{"case": c[0], "group": c[5], "max_abs_err": 0.0, "bf16_max_abs_err": 0.0,
             "bf16_limit_share": 0.0,
             **({k: 1.0 for k in ("ms", "plain_ms", "bound_ms", "library_ms",
                                  "events_ms", "bf16_ms", "bf16_bound_ms",
                                  "bf16_library_ms")} if c[5] else {}),
             **({"bound_by": "bytes"} if c[5] else {})} for c in chip_smoke.LRN_CASES]
    entry = chip_smoke.kernel_entry("lrn_fwd", "x:1", rows)
    assert entry["ms"] == 2.0 and entry["googlenet"]["ms"] == 2.0
    assert entry["googlenet"]["cases"] == ["googlenet_lrn1_b64", "googlenet_lrn2_b64"]
    assert entry["googlenet"]["bound_by"] == "bytes"


@pytest.mark.parametrize("case", ["same", "lrn_backward_off"])
def test_pinned_kinks_on_googlenet(case):
    """`pinned_kinks` records every ReLU and max-pool decision of a GoogLeNet
    and replays them: the same function passes with none flipped (the
    replayed pools gather where the pools chose, so the gradients agree to
    rounding, 1.5e-6 here: overlapping windows sum their cotangents in
    another order);
    an LRN backward off by 1e-3 in the second run fails."""
    net = _SmallGoogLeNet().init()
    rng = np.random.default_rng(3)
    ds = DataSet(rng.standard_normal((2, 32, 32, 3)).astype(np.float32),
                 np.eye(10, dtype=np.float32)[[1, 2]])
    bwd = port_lrn.lrn_bwd

    def run(scale):
        def grads(ds, record, flips):
            with chip_smoke.pinned_kinks(torch, net, record, flips), \
                    chip_smoke.patched(port_lrn, "lrn_bwd",
                                       lambda *a: bwd(*a) * scale):
                return net.compute_gradient_and_score(ds)
        return grads

    if case == "same":
        out = chip_smoke.compare_pinned_grads(case, torch, port_params, run(1.0),
                                              run(1.0), ds)
        assert out["worst_rel"] < 1e-5 and out["kink_flips_pinned"] == 0
        relu_layers = [l for l in chip_smoke.net_layers(net)
                       if (l.activation or "").lower() == "relu"]
        pools = [l for l in chip_smoke.net_layers(net)
                 if isinstance(l, port_zoo.SubsamplingLayer)]
        assert out["kink_entries"] > 0 and len(relu_layers) > 50 and len(pools) == 13
    else:
        with pytest.raises(RuntimeError, match="pinned"):
            chip_smoke.compare_pinned_grads(case, torch, port_params, run(1.0),
                                            run(1.001), ds)


# ------------------------------------------------------- the ResNet50 phases

class _SmallResNet50(port_zoo.ResNet50):
    """ResNet50's stem, blocks and head at narrow widths, 32x32x3 and 10
    classes, from the zoo model's own `_conv_block` and `_identity_block`,
    initializing on the CPU when no device is named."""

    def __init__(self, num_labels=10, **kw):
        super().__init__(num_labels=10, input_shape=(32, 32, 3))

    def conf(self):
        import deeplearning4j_torch as port
        g = (port.NeuralNetConfiguration.builder().seed(self.seed)
             .activation("identity")
             .updater(port.RmsProp(learning_rate=0.1, rms_decay=0.96, epsilon=0.001))
             .weight_init(port.WeightInit.DISTRIBUTION)
             .dist(port.Distribution(kind="normal", mean=0.0, std=0.5))
             .l1(1e-7).l2(5e-5).graph_builder())
        g.add_inputs("input")
        g.set_input_types(port.InputType.convolutional(32, 32, 3))
        g.add_layer("stem-zero", port.ZeroPaddingLayer(padding=(3, 3)), "input")
        g.add_layer("stem-cnn1", port.ConvolutionLayer(
            kernel_size=(7, 7), stride=(2, 2), n_out=8), "stem-zero")
        a = self._bn_act(g, "stem1", "stem-cnn1")
        g.add_layer("stem-maxpool1", port.SubsamplingLayer(
            kernel_size=(3, 3), stride=(2, 2), pooling_type=port.PoolingType.MAX), a)
        x = self._conv_block(g, (3, 3), (8, 8, 16), "2", "a", "stem-maxpool1")
        x = self._identity_block(g, (3, 3), (8, 8, 16), "2", "b", x)
        x = self._conv_block(g, (3, 3), (12, 12, 24), "3", "a", x)
        g.add_layer("avgpool", port.GlobalPoolingLayer(
            pooling_type=port.PoolingType.AVG), x)
        g.add_layer("output", port.OutputLayer(
            n_out=self.num_labels, activation="softmax",
            loss="negativeloglikelihood"), "avgpool")
        g.set_outputs("output")
        return g.build()

    def init(self, seed=None, dtype=torch.float32, device="cpu"):
        return super().init(seed=seed, dtype=dtype, device=device)


@pytest.fixture
def small_resnet_phases(monkeypatch, tmp_path):
    """The ResNet50 phases cut to run here: `_SmallResNet50`, 2 clients x 2
    requests, 2 steps at batch 4 in both types, no profiler, no device
    timing, no CUDA sync; checkpoints under a temporary directory."""
    monkeypatch.setattr(port_zoo, "ResNet50", _SmallResNet50)
    for name, value in (("RESNET_BATCH", 4), ("RESNET_STEPS", 2),
                        ("RESNET_BF16_BATCH", 4), ("RESNET_BF16_STEPS", 2),
                        ("ROOT", str(tmp_path))):
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(chip_smoke, "serving_requests", lambda rng: [
        [rng.standard_normal((int(rng.integers(1, 3)), 32, 32, 3)).astype(np.float32)
         for _ in range(2)] for _ in range(2)])
    monkeypatch.setattr(chip_smoke, "profile_call", lambda torch, label, fn, info: {})
    monkeypatch.setattr(chip_smoke, "bn_pass_ms", lambda torch, net, x, train: {
        "bn_layers": 0, "ms": 0.0, "bytes_bound_ms": 0.0})
    monkeypatch.setattr(chip_smoke, "h2d_copy_ms", lambda torch, x: 0.0)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)


def test_resnet_phases_run_and_check_state(small_resnet_phases):
    out, net = chip_smoke.phase_resnet_training(torch, "cpu")
    assert out["shape"]["bn"] == 12 and out["shape"]["adds"] == 3
    assert set(out["launches"].values()) == {0}
    assert out["first_step_state"]["worst"] < 1e-6      # float32 vs float64, CPU
    assert out["grad_rel_vs_cpu"]["kink_flips_pinned"] == 0
    assert out["grad_rel_vs_cpu"]["worst_rel"] < 1e-5
    # both on the CPU here, the second run pinned: its relu is z * mask
    assert out["new_state_err_vs_cpu"] < 1e-6
    assert out["checkpoint"]["bitwise"] == {k: True for k in out["checkpoint"]["bitwise"]}
    served = chip_smoke.phase_resnet_serving(torch, "cpu", net)
    assert set(served["launches"].values()) == {0} and served["forwards"] >= 1
    assert served["max_abs_card_vs_cpu_b2"] == served["avgpool_rel_card_vs_cpu_b2"] == 0.0
    bf16 = chip_smoke.phase_resnet_bf16_training(torch, "cpu")
    assert bf16["state_leaves_float32"] == 24 and len(bf16["scores"]) == 2


def test_first_step_state_check_catches_an_unbiased_variance(small_resnet_phases,
                                                            monkeypatch):
    """A BN whose running variance took the unbiased batch variance (what
    F.batch_norm keeps: n/(n-1) away) fails the first step's check."""
    from deeplearning4j_torch.nn.layers.convolution import BatchNormalization
    fwd = BatchNormalization.forward_with_state

    def unbiased(self, params, state, x, *, train=False, **kw):
        y, new = fwd(self, params, state, x, train=train, **kw)
        if train:
            n = x.numel() // x.shape[-1]
            old = self.decay * state["var"]
            new = {"mean": new["mean"], "var": old + (new["var"] - old) * n / (n - 1)}
        return y, new

    monkeypatch.setattr(BatchNormalization, "forward_with_state", unbiased)
    with pytest.raises(RuntimeError, match="plain recompute"):
        chip_smoke.phase_resnet_training(torch, "cpu")


def test_calibrate_bn_takes_one_forwards_batch_statistics():
    net = _SmallResNet50().init()
    x = np.random.default_rng(3).standard_normal((4, 32, 32, 3)).astype(np.float32)
    initial = net.feed_forward_named(x)   # evaluation on the initial state
    inputs, _ = net._pack_inputs([x])
    with torch.no_grad():   # batch statistics, pivoted on the same state
        acts, _, _ = net._walk(net.params_tree, net.state_tree, inputs, train=True)
    chip_smoke.calibrate_bn(torch, net, x)
    evaluated = net.feed_forward_named(x)
    for name in ("bnstem1", "bn3a_branch2c", "output"):
        np.testing.assert_array_equal(evaluated[name], acts[name].numpy())
        assert not np.array_equal(evaluated[name], initial[name])
    assert all(n.layer.decay == 0.9 for n in net.conf.nodes.values()
               if type(n.layer).__name__ == "BatchNormalization")


# ------------------------------------- the recurrent slice and the face models

class _SmallTextGenerationLSTM(port_zoo.TextGenerationLSTM):
    """Zoo TextGenerationLSTM at 8 units that initializes on the CPU when no
    device is named; its input width and tBPTT are the zoo's."""

    def __init__(self, **kw):
        super().__init__(hidden=8, **kw)

    def init(self, seed=None, dtype=torch.float32, device="cpu"):
        return super().init(seed=seed, dtype=dtype, device=device)


@pytest.fixture
def small_text_phase(monkeypatch, tmp_path):
    """The TextGenerationLSTM phase cut to run here: 8 units, 2 batches of
    4 (still 64 steps: windows of 50 and 14), 2 clients x 2 requests served
    in buckets up to 4, no profiler, no CUDA sync; checkpoints under a
    temporary directory."""
    monkeypatch.setattr(port_zoo, "TextGenerationLSTM", _SmallTextGenerationLSTM)
    for name, value in (("TEXT_BATCH", 4), ("TEXT_BATCHES", 2), ("STREAM_ROWS", 4),
                        ("SERVE_BATCH_LIMIT", 4), ("ROOT", str(tmp_path))):
        monkeypatch.setattr(chip_smoke, name, value)
    requests = chip_smoke.sequence_requests
    monkeypatch.setattr(chip_smoke, "sequence_requests",
                        lambda rng: requests(rng, clients=2, per_client=2))
    monkeypatch.setattr(chip_smoke, "profile_call", lambda torch, label, fn, info: {
        "wall_ms": 0.0})
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)


@pytest.mark.parametrize("case", ["detached", "carry_kept_attached"])
def test_text_generation_phase(small_text_phase, monkeypatch, case):
    if case == "carry_kept_attached":
        # a commit that keeps the autograd history: the check must see it
        monkeypatch.setattr(MultiLayerNetwork, "_split_carry", staticmethod(
            lambda st: ({k: v for k, v in st.items() if k not in ("h", "c")},
                        {k: v for k, v in st.items() if k in ("h", "c")})))
        with pytest.raises(RuntimeError, match="detached"):
            chip_smoke.phase_text_generation(torch, "cpu")
        return
    out = chip_smoke.phase_text_generation(torch, "cpu")
    assert out["windows_per_batch"] == 2 and len(out["scores"]) == 4
    assert out["launches"] == dict.fromkeys(out["launches"], 0)
    assert out["grad_rel_vs_cpu"]["worst_rel"] == 0.0   # both on the CPU here
    assert out["streaming"]["max_abs_vs_output"] <= 1e-6
    assert out["serving"]["forwards"] >= 1
    assert out["checkpoint"]["bitwise"] == {k: True for k in out["checkpoint"]["bitwise"]}


def test_check_streaming_catches_a_lost_carry(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    net = _SmallTextGenerationLSTM(num_labels=77, input_shape=(64, 77)).init()
    x, _ = chip_smoke.text_data(3, 6, seed=1)
    assert chip_smoke.check_streaming(torch, net, x)["max_abs_vs_output"] <= 1e-6
    commit = MultiLayerNetwork._commit_state

    def forgetful(self, new_state):   # each step starts from zeros again
        commit(self, new_state)
        self._rnn_carry = tuple({k: torch.zeros_like(v) for k, v in c.items()}
                                for c in self._rnn_carry)

    monkeypatch.setattr(MultiLayerNetwork, "_commit_state", forgetful)
    with pytest.raises(AssertionError):
        chip_smoke.check_streaming(torch, net, x)


def test_rnn_checkpoint_phase(monkeypatch, tmp_path):
    monkeypatch.setattr(chip_smoke, "ROOT", str(tmp_path))
    out = chip_smoke.phase_rnn_checkpoint(torch, "cpu", device="cpu")
    assert out["max_abs_vs_expected"] <= 1e-6
    assert out["resumed_worst_rel_vs_cpu"] == 0.0   # both on the CPU here
    assert out["checkpoint"]["bitwise"] == {k: True for k in out["checkpoint"]["bitwise"]}


def _small_face(name, hwc):
    base = getattr(port_zoo, name)

    class Small(base):
        def __init__(self, num_labels=5, **kw):
            super().__init__(num_labels=5, input_shape=hwc)

        def init(self, seed=None, dtype=torch.float32, device="cpu"):
            return super().init(seed=seed, dtype=dtype, device=device)
    return Small


@pytest.fixture
def small_face_phase(monkeypatch):
    """The face-model phase cut to run here: FaceNetNN4Small2 at its
    96x96 with 5 classes, 2 steps at batch 2, 2 clients x 2 requests served
    in buckets up to 4, no profiler, no CUDA sync. (InceptionResNetV1's 21
    M parameters make each of its CPU steps slow; the phase is the same
    code for both.)"""
    monkeypatch.setattr(port_zoo, "FaceNetNN4Small2",
                        _small_face("FaceNetNN4Small2", (96, 96, 3)))
    monkeypatch.setattr(chip_smoke, "FACE_BATCH", 2)
    monkeypatch.setattr(chip_smoke, "FACE_STEPS", 2)
    monkeypatch.setattr(chip_smoke, "SERVE_BATCH_LIMIT", 4)
    requests = chip_smoke.serving_requests
    monkeypatch.setattr(chip_smoke, "serving_requests", lambda rng, shape: requests(
        rng, clients=2, per_client=2, shape=shape))
    monkeypatch.setattr(chip_smoke, "profile_call", lambda torch, label, fn, info: {})
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)


def test_face_model_phase(small_face_phase):
    out = chip_smoke.phase_face_model(torch, "cpu", "FaceNetNN4Small2", (96, 96, 3), 5)
    assert out["launches"] == dict.fromkeys(out["launches"], 0)
    assert len(out["scores"]) == 2 and out["first_step_state"]["worst"] <= 1e-5
    nodes = out["nodes_card_vs_cpu_b2"]
    assert nodes["out"] == nodes["grad"] == nodes["state"] == 0.0   # both CPU
    assert nodes["kink_flips_pinned"] == 0 and nodes["kink_entries"] > 0
    assert out["serving"]["forwards"] >= 1 and not out["calibrated"]


def test_check_nodes_one_by_one_catches_one_node_off():
    from deeplearning4j_torch.nn.graph.graph import ComputationGraph
    net = _small_face("FaceNetNN4Small2", (96, 96, 3))().init()
    x = np.random.default_rng(3).standard_normal((2, 96, 96, 3)).astype(np.float32)
    cpu = ComputationGraph(net.conf).init(device="cpu")
    cpu.params_tree, cpu.state_tree = net.params_tree, net.state_tree
    assert chip_smoke.check_nodes_one_by_one(torch, net, cpu, x)["grad"] == 0.0
    moved = dict(cpu.params_tree)
    moved["inception4a-3x3-cnn"] = {k: v * (1 + 1e-3) for k, v in
                                    moved["inception4a-3x3-cnn"].items()}
    cpu.params_tree = moved
    with pytest.raises(RuntimeError, match="inception4a-3x3-cnn"):
        chip_smoke.check_nodes_one_by_one(torch, net, cpu, x)


def test_bn_cancellation_measures_the_pivot_distance():
    from deeplearning4j_torch.nn.layers.convolution import BatchNormalization
    bn = BatchNormalization(n_out=2, eps=1e-3)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(4, 5, 5, 2, generator=gen)
    x[..., 1] = x[..., 1] * 0.1 + 30.0     # channel 1: 300 stds off the pivot
    state = {"mean": torch.zeros(2), "var": torch.ones(2)}
    got = chip_smoke.bn_cancellation(torch, bn, state, x)
    assert got[0] < 1.2 and abs(got[1].item() / (900.01 / 0.011) - 1.0) < 0.2
    assert (chip_smoke.bn_cancellation(torch, bn, {"mean": x.mean((0, 1, 2)),
                                                   "var": state["var"]}, x) < 1.01).all()
    assert chip_smoke.bn_cancellation(torch, DenseLayer(n_in=2, n_out=2), state, x) is None


# ------------------------------------------------------------ the fit loop

def _counting_lrn(monkeypatch):
    """K1 and K2 stand-ins that count a launch per call, as the kernels'
    wrappers do, computing the plain versions."""
    fwd, bwd = port_lrn.lrn_reference, port_lrn.lrn_bwd_reference

    def k1(x, *h):
        port_lrn.launches += 1
        return fwd(x, *h)

    def k2(x, g, *h):
        port_lrn.bwd_launches += 1
        return bwd(x, g, *h)

    monkeypatch.setattr(port_lrn, "lrn_fwd", k1)
    monkeypatch.setattr(port_lrn, "lrn_bwd", k2)


@pytest.fixture
def small_fit_loop_phase(monkeypatch, tmp_path):
    """phase_fit_loop_alexnet cut to run here: AlexNet at 60x60x3, 3 steps
    at batch 4 (one group of 3), profiled calls of 2 batches, one epoch of
    early stopping (one best-model save), no profiler, no CUDA sync,
    counting stand-ins for K1 and K2, build/ under a temporary directory."""
    monkeypatch.setattr(port_zoo, "AlexNet", _SmallAlexNet)
    for name, value in (("TRAIN_BATCH", 4), ("TRAIN_STEPS", 3),
                        ("FIT_PROFILE_BATCHES", 2), ("FIT_ES_MAX_EPOCHS", 1),
                        ("ROOT", str(tmp_path))):
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(chip_smoke, "profile_call", lambda torch, label, fn, info: (
        fn(), {"h2d_share_of_busy": None})[1])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    _counting_lrn(monkeypatch)


@pytest.mark.parametrize("case", ["counted", "uncounted_lrn", "staging_off_by_one_ulp",
                                  "group_skips_a_step"])
def test_fit_loop_alexnet_phase(small_fit_loop_phase, monkeypatch, case):
    from deeplearning4j_torch.data import iterators as port_it
    if case == "uncounted_lrn":   # the second LRN layer goes around K1
        from deeplearning4j_torch.nn.layers.convolution import LocalResponseNormalization
        layer_fwd = LocalResponseNormalization.forward

        def forward(self, params, x, **kw):
            if x.shape[-1] == 192:
                return port_lrn.lrn_reference(x, self.k, self.alpha, self.beta, self.n)
            return layer_fwd(self, params, x, **kw)
        monkeypatch.setattr(LocalResponseNormalization, "forward", forward)
    elif case == "staging_off_by_one_ulp":   # a prefetch that changes the data
        stage = port_it.PinnedStager.stage

        def off(self, arrays, features, cast_dtype=None, consumer=None):
            out = stage(self, arrays, features, cast_dtype, consumer)
            return [torch.nextafter(t, t + 1) if t is not None and f else t
                    for t, f in zip(out, features)]
        monkeypatch.setattr(port_it.PinnedStager, "stage", off)
    elif case == "group_skips_a_step":   # a group that drops its last batch
        def fit_batches(net, batches, _orig=MultiLayerNetwork.fit_batches):
            return _orig(net, batches[:-1])
        monkeypatch.setattr(MultiLayerNetwork, "fit_batches", fit_batches)
    if case == "counted":
        out = chip_smoke.phase_fit_loop_alexnet(torch, "cpu", device="cpu")
        assert out["launches"]["lrn_fwd"] == out["launches"]["lrn_bwd"] == 6
        assert all(v for v in out["prefetch_vs_pageable"].values())
        assert out["etl"]["last_etl_h2d_ms"] > 0
        es = out["early_stopping"]
        assert es["best_answers_bitwise"] and es["total_epochs"] == 1
        assert set(out["timing"]) == {"prefetch", "pageable"}
    else:
        with pytest.raises(RuntimeError, match="launches|bitwise"):
            chip_smoke.phase_fit_loop_alexnet(torch, "cpu", device="cpu")


@pytest.fixture
def small_fit_char_phase(monkeypatch, tmp_path):
    """phase_fit_loop_char cut to run here: 16 wide, 4 heads, bucket 32,
    8 sequences of 4..32 tokens in one base batch packed into rows of 2,
    counting stand-ins for K3-K5 (the plain versions), no CUDA sync."""
    from deeplearning4j_torch.ops import flash_attention as port_fa
    for name, value in (("CHAR_WIDTH", 16), ("CHAR_T", 32), ("CHAR_BATCH", 2),
                        ("FIT_SEQS", 8), ("FIT_SEQ_MIN", 4), ("FIT_BASE_BATCH", 8),
                        ("ROOT", str(tmp_path))):
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    fwd, bwd = port_fa.flash_fwd_reference, port_fa.flash_bwd_reference

    def k3(*a):
        port_fa.fwd_launches += 1
        return fwd(*a)

    def k45(*a):
        port_fa.bwd_dkv_launches += 1
        port_fa.bwd_dq_launches += 1
        return bwd(*a)

    monkeypatch.setattr(port_fa, "flash_fwd", k3)
    monkeypatch.setattr(port_fa, "flash_bwd", k45)


@pytest.mark.parametrize("case", ["counted", "resume_restores_nothing",
                                  "skip_step_keeps_the_update"])
def test_fit_loop_char_phase(small_fit_char_phase, monkeypatch, case):
    from deeplearning4j_torch.optimize import resilience
    if case == "resume_restores_nothing":
        monkeypatch.setattr(resilience.CheckpointManager, "restore_into",
                            lambda self, model: None)
    elif case == "skip_step_keeps_the_update":
        monkeypatch.setattr(resilience.DivergenceSentinel, "_skip_step",
                            lambda self, model: None)
    if case == "counted":
        out = chip_smoke.phase_fit_loop_char(torch, "cpu", device="cpu")
        steps = out["packed_batches"]
        assert steps >= 2 and out["launches"] == dict.fromkeys(out["launches"], 2 * steps)
        assert out["packed_vs_unpacked_score"]["rel"] <= chip_smoke.PACKED_RTOL
        assert out["resume"]["params"] and out["skip_step"]["bitwise"]
        assert out["timing"]["packed"]["util"] >= out["timing"]["padded"]["util"]
    else:
        with pytest.raises(RuntimeError, match="resumed|skip_step"):
            chip_smoke.phase_fit_loop_char(torch, "cpu", device="cpu")
