"""The torch port's data normalizers against the JAX package's:
NormalizerStandardize, NormalizerMinMaxScaler and ImagePreProcessingScaler,
`fit` (on a DataSet and on an iterator of them) to the same statistics,
`transform` and `revert` to the same arrays (rtol 1e-6: the JAX package may
take its native host kernel), and serde both ways under the same names."""
import numpy as np
import pytest

import deeplearning4j_torch as port
from deeplearning4j_torch.data import normalizers as port_norm
from deeplearning4j_torch.utils import serde as port_serde
from deeplearning4j_tpu.data import normalizers as ref_norm
from deeplearning4j_tpu.data.dataset import DataSet as RefDataSet
from deeplearning4j_tpu.utils import serde as ref_serde

NAMES = ["NormalizerStandardize", "NormalizerMinMaxScaler",
         "ImagePreProcessingScaler"]


def _data(seed=0, shape=(20, 6)):
    rng = np.random.default_rng(seed)
    x = (3.0 + 2.0 * rng.standard_normal(shape)).astype(np.float32)
    return x, np.zeros((shape[0], 1), np.float32)


def _pair(name, **kw):
    return getattr(port_norm, name)(**kw), getattr(ref_norm, name)(**kw)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("source", ["dataset", "iterator"])
def test_fit_transform_revert_match_reference(name, source):
    x, y = _data()
    if name == "ImagePreProcessingScaler":
        x = np.random.default_rng(1).integers(0, 256, x.shape).astype(np.uint8)
    kw = {} if name == "NormalizerStandardize" else dict(min_range=-1.0, max_range=2.0)
    mine, theirs = _pair(name, **kw)
    if source == "dataset":
        mine.fit(port.DataSet(x, y))
        theirs.fit(RefDataSet(x, y))
    else:  # batches of 7, 7 and 6
        mine.fit(port.DataSet(x[i:i + 7], y[i:i + 7]) for i in range(0, 20, 7))
        theirs.fit(iter([RefDataSet(x[i:i + 7], y[i:i + 7]) for i in range(0, 20, 7)]))
    assert port_serde.to_dict(mine) == ref_serde.to_dict(theirs)
    out = mine.transform(port.DataSet(x, y))
    want = theirs.transform(RefDataSet(x, y))
    np.testing.assert_allclose(out.features, np.asarray(want.features), rtol=1e-6,
                               atol=1e-6)
    assert out.labels is y
    back = mine.revert(out)
    np.testing.assert_allclose(back.features, theirs.revert(want).features,
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(back.features, x.astype(np.float32), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_array_equal(mine(port.DataSet(x, y)).features, out.features)


def test_standardize_over_every_axis_but_the_last():
    x, y = _data(shape=(4, 5, 3))
    mine, theirs = _pair("NormalizerStandardize")
    mine.fit(port.DataSet(x, y))
    theirs.fit(RefDataSet(x, y))
    assert len(mine.mean) == 3 and mine.mean == theirs.mean and mine.std == theirs.std
    np.testing.assert_allclose(mine.mean, x.reshape(-1, 3).astype(np.float64).mean(0))


@pytest.mark.parametrize("name", NAMES)
def test_serde_round_trips_both_ways(name):
    x, y = _data(2)
    mine, _ = _pair(name)
    mine.fit(port.DataSet(x, y))
    theirs = ref_serde.from_json(port_serde.to_json(mine))
    assert type(theirs).__name__ == name
    assert ref_serde.to_dict(theirs) == port_serde.to_dict(mine)
    back = port_serde.from_json(ref_serde.to_json(theirs))
    assert type(back) is type(mine) and back == mine


def test_unfitted_and_empty_raise():
    with pytest.raises(RuntimeError, match="fit"):
        port_norm.NormalizerStandardize().transform(port.DataSet(*_data()))
    with pytest.raises(RuntimeError, match="fit"):
        port_norm.NormalizerMinMaxScaler().transform(port.DataSet(*_data()))
    with pytest.raises(ValueError, match="no data"):
        port_norm.NormalizerStandardize().fit(iter([]))
    with pytest.raises(ValueError, match="no data"):
        port_norm.NormalizerMinMaxScaler().fit(iter([]))
