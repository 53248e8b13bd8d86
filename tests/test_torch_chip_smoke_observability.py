"""chip_smoke.py's training-observability, streaming, estimator and churn/lock
phases (`phase_training_ui`, `phase_streaming_route`, `phase_estimators`,
`phase_churn_and_locks`) on the CPU at small sizes: the AlexNet-shaped net of
tests/test_torch_chip_smoke_gateway.py (a few channels wide at 15x15x3, two
LRN layers) with counting stand-ins for K1 and K2 (the plain versions, each
call counting one launch as the kernels' wrappers do), a 64-wide MLP on
512 synthesized MNIST images. The card-against-CPU holds compare the CPU
with itself here; each hold of its own sees a planted fault:

- a histogram bucketed by `torch.histc` fails the count hold;
- a client that drops the registration consume's payload fails the
  first-message hold;
- a churn hook that notes `output` under another label fails the counter
  hold.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from deeplearning4j_torch.models import zoo as port_zoo
from deeplearning4j_torch.optimize import telemetry as ptel
from deeplearning4j_torch.streaming import ndarray_stream as pns
from deeplearning4j_torch.ui import stats as pstats

from test_torch_chip_smoke_gateway import _NarrowAlexNet
from test_torch_chip_smoke_parallel import counting_standins
from test_torch_word2vec import one_torch_thread  # noqa: F401

NARROW = ((15, 15, 3), 10)
OBS_SMALL = dict(alexnet=NARROW, batch=4, steps=3, conv_every=3, timed_fits=1)
STREAM_SMALL = dict(alexnet=NARROW, images=6, clients=2, poll_s=0.2, wait_s=30, first_s=5)
EST_SMALL = dict(n_train=512, hidden=64, batch=64, reg_n=256, reg_d=4, reg_hidden=8,
                 reg_epochs=2)
LOCK_SMALL = dict(alexnet=NARROW, clients=2, per_client=3, max_rows=2, batch_limit=4,
                  join_s=60)


@pytest.fixture
def small(monkeypatch):
    monkeypatch.setattr(port_zoo, "AlexNet", _NarrowAlexNet)
    for mod, name, fn in counting_standins():
        monkeypatch.setattr(mod, name, fn)
    monkeypatch.delenv(ptel.ENV_CHURN_THRESHOLD, raising=False)


def test_training_ui_phase_passes(small):
    r = chip_smoke.phase_training_ui(torch, "cpu", device="cpu", size=OBS_SMALL)
    assert r["launches"]["lrn_fwd"] == 2 * (3 + 1) and r["launches"]["lrn_bwd"] == 6
    leaves = 10   # 4 conv and 6 dense leaves
    assert r["records"] == 4 and r["held"]["histograms"] == 4 * leaves
    assert r["held"]["updates"] == 3 * leaves and r["held"]["edge_leaves"] == 6
    # one transfer of the ranges and one of everything else: a few hundred
    # numbers, not the parameters
    assert r["record_transfers"] == 2
    assert r["record_host_bytes"] == 8 * (2 * leaves) + 8 * (1 + 3 * leaves + 20 * leaves - leaves)
    assert r["record_host_bytes"] < r["param_bytes"]
    assert set(r["pages"]) == {"/", "model", "activations", "metrics", "train/sessions",
                               "sessions"}
    assert len(r["step_ms"]["runs"]["plain"]) == 2


def test_training_ui_fails_with_histc_bins(small, monkeypatch):
    def histc(x, edges):
        return torch.histc(x.to(edges.dtype), bins=edges.numel() - 1,
                           min=float(edges[0]), max=float(edges[-1])).to(torch.int64)
    monkeypatch.setattr(pstats, "histogram_counts", histc)
    with pytest.raises(RuntimeError, match="histogram"):
        chip_smoke.phase_training_ui(torch, "cpu", device="cpu", size=OBS_SMALL)


def test_streaming_route_phase_passes(small):
    r = chip_smoke.phase_streaming_route(torch, "cpu", device="cpu", size=STREAM_SMALL)
    assert (r["served"], r["errors"]) == (6 + 1, 1)   # and the image after the bad one
    assert r["launches"]["lrn_fwd"] == 2 * 6 and r["max_rel_err"] <= chip_smoke.STREAM_RTOL


def test_streaming_route_fails_when_the_registration_payload_is_dropped(small, monkeypatch):
    post = pns._HttpTopic._post

    def dropping(self, route, payload):
        out = post(self, route, payload)
        if route == "/consume" and payload.get("timeout") == 0.0:
            return {"empty": True}   # the registration consume's payload, lost
        return out

    monkeypatch.setattr(pns._HttpTopic, "_post", dropping)
    with pytest.raises(RuntimeError, match="first prediction"):
        chip_smoke.phase_streaming_route(torch, "cpu", device="cpu", size=STREAM_SMALL)


def test_match_answers_sees_a_lost_or_wrong_answer():
    direct = [np.array([[0.1, 0.9]]), np.array([[0.6, 0.4]])]
    assert chip_smoke.match_answers(direct[::-1], direct) == 0.0
    with pytest.raises(RuntimeError, match="no image's direct output"):
        chip_smoke.match_answers([direct[0], direct[0]], direct)
    with pytest.raises(RuntimeError, match="not answered"):
        chip_smoke.match_answers([direct[1]], direct)


def test_estimators_phase_passes(small):
    r = chip_smoke.phase_estimators(torch, "cpu", device="cpu", size=EST_SMALL)
    assert r["device_param"] == "cpu" and r["proba_max_abs_err"] == 0.0
    assert r["predictions_differing"] == 0 and r["accuracy"] > 0.2   # chance is 0.1
    assert set(r["launches"].values()) == {0}


def test_churn_and_locks_phase_passes(small):
    r = chip_smoke.phase_churn_and_locks(torch, "cpu", device="cpu", size=LOCK_SMALL)
    assert r["churn"]["warnings"] == 1 and r["churn"]["counter"] == chip_smoke.CHURN_EXTRA
    assert r["churn"]["launches"]["lrn_fwd"] == 2 * (5 + chip_smoke.CHURN_EXTRA)
    locks = r["locks"]
    assert "ParallelInference._lock" in locks["adopted"] and not locks["cycles"]
    assert locks["launches"]["lrn_fwd"] == 2 * locks["forwards"] > 0


def test_churn_and_locks_fails_on_the_wrong_label(small, monkeypatch):
    note = ptel.note_step_signature
    monkeypatch.setattr(ptel, "note_step_signature",
                        lambda label, sig: note(label.replace("_output#", "_infer#"), sig))
    with pytest.raises(RuntimeError, match="churn guard"):
        chip_smoke.phase_churn_and_locks(torch, "cpu", device="cpu", size=LOCK_SMALL)
