"""chip_smoke.py's gradient comparison, run on the CPU at a small size.

`compare_grads` compares two runs' per-layer gradients only on a draw of
rows where both decide every ReLU zero and max-pool choice alike
(`recorded_kinks`). These cases hold it to what it must tell apart, on zoo
AlexNet at 60x60x3 and batch 2: the same function passes on the first draw;
parameters moved by 1e-3 flip kinks on every draw and fail; a backward off
by 1e-3, which flips no kink, fails on the first draw.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from deeplearning4j_torch.data.dataset import DataSet
from deeplearning4j_torch.models import zoo as port_zoo
from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_torch.ops import lrn as port_lrn
from deeplearning4j_torch.utils import params as port_params


@pytest.fixture(scope="module")
def setup():
    net = port_zoo.AlexNet(input_shape=(60, 60, 3), num_labels=10).init(device="cpu")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((8, 60, 60, 3), dtype=np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 8)]
    return net, x, y


def _run(model, bwd_scale=1.0):
    def grads(ds, kinks):
        with chip_smoke.recorded_kinks(torch, model, kinks):
            if bwd_scale == 1.0:
                return model.compute_gradient_and_score(ds)
            ref = port_lrn.lrn_bwd_reference
            with chip_smoke.patched(port_lrn, "lrn_bwd_reference",
                                    lambda *a: ref(*a) * bwd_scale):
                return model.compute_gradient_and_score(ds)
    return grads


def _draws(x, y):
    return ((s, DataSet(x[s:s + 2], y[s:s + 2])) for s in range(0, len(x), 2))


def _moved(net, scale):
    gen = torch.Generator().manual_seed(0)
    other = MultiLayerNetwork(net.conf).init(device="cpu")
    other.params_tree = tuple(
        {k: v * (1 + scale * torch.randn(v.shape, generator=gen)) for k, v in lp.items()}
        for lp in net.params_tree)
    return other


@pytest.mark.parametrize("case", ["same", "moved_params", "backward_off"])
def test_compare_grads_tells_kink_flips_from_faults(setup, monkeypatch, case):
    net, x, y = setup
    if case == "same":
        out = chip_smoke.compare_grads(case, port_params, _run(net), _run(net),
                                       _draws(x, y))
        assert out == {"worst_rel": 0.0, "rows_from": 0, "skipped": []}
    elif case == "moved_params":
        # the moved parameters move the score too; only the kinks are under test
        monkeypatch.setattr(chip_smoke, "SCORE_RTOL", 1.0)
        with pytest.raises(RuntimeError, match="no draw with every kink decided alike"):
            chip_smoke.compare_grads(case, port_params, _run(net),
                                     _run(_moved(net, 1e-3)), _draws(x, y))
    else:
        with pytest.raises(RuntimeError, match="with every kink decided alike"):
            chip_smoke.compare_grads(case, port_params, _run(net),
                                     _run(net, bwd_scale=1.001), _draws(x, y))


def test_recorded_kinks_cover_every_layer_and_pool(setup):
    net, x, y = setup
    kinks = []
    with chip_smoke.recorded_kinks(torch, net, kinks):
        net.compute_gradient_and_score(DataSet(x[:2], y[:2]))
    pools = [t for t in kinks if t.dtype == torch.int64]
    # every layer but the output layer (its forward is not on the score's path)
    assert len(kinks) - len(pools) == len(net.layers) - 1
    assert len(pools) == 3   # AlexNet's three max pools
    assert all((t >= -1).all() for t in pools)
