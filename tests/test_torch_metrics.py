"""The port's binomial threshold tables and anomaly metrics held against
``h2o_tpu``'s on the same predictions.

``thresholds_and_metric_scores`` and ``max_criteria_and_metric_scores``
come from the same 1,024-bin score histograms in both packages: their
TwoDimTableV3 layout (names, column specs, row count) is equal, the
integer columns (tns, fns, fps, tps, idx) are equal and the double
columns agree to 1e-9, without weights and with weights on a 1/8 grid
(so the float32 histograms sum exactly in either package).  The
anomaly metrics are the same numpy means of the same predictions.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from h2o_tpu.models import metrics as jmm

from h2o_tpu_torch.models import metrics as pmm

TOL = 1e-9


def _inputs(case: str, n: int = 3000):
    rng = np.random.default_rng({"plain": 0, "weighted": 1, "nan_y": 2,
                                 "ties": 3}[case])
    p1 = rng.uniform(size=n).astype(np.float32)
    if case == "ties":
        p1 = np.round(p1 * 20) / 20          # few distinct scores
    y = (rng.uniform(size=n) < p1).astype(np.float32)
    w = None
    if case == "weighted":
        w = (rng.integers(1, 17, n) / 8).astype(np.float32)
    if case == "nan_y":
        y[rng.uniform(size=n) < 0.05] = np.nan
    return p1.astype(np.float32), y, w


def _tables_close(got, want):
    assert got["name"] == want["name"]
    assert got["rowcount"] == want["rowcount"] > 0
    assert [c["name"] for c in got["columns"]] == \
        [c["name"] for c in want["columns"]]
    assert [c["type"] for c in got["columns"]] == \
        [c["type"] for c in want["columns"]]
    for spec, g, w in zip(got["columns"], got["data"], want["data"]):
        if spec["type"] in ("long", "int", "string"):
            assert g == w, spec["name"]
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=TOL,
                                       err_msg=spec["name"])


@pytest.mark.parametrize("case", ["plain", "weighted", "nan_y", "ties"])
def test_threshold_tables_equal_reference(case):
    p1, y, w = _inputs(case)
    want = jmm.binomial_metrics(jnp.asarray(p1), jnp.asarray(y),
                                w=None if w is None else jnp.asarray(w))
    got = pmm.binomial_metrics(torch.from_numpy(p1), torch.from_numpy(y),
                               w=None if w is None else torch.from_numpy(w))
    for key in ("thresholds_and_metric_scores",
                "max_criteria_and_metric_scores"):
        _tables_close(got[key], want[key])
    assert got["AUC"] == want["AUC"]
    # the keys the reference's binomial metrics carry, and no fewer
    assert set(want.data) <= set(got.data)


def test_threshold_tables_of_no_rows():
    assert pmm._threshold_tables(np.zeros(8), np.zeros(8)) == (None, None)


def test_anomaly_metrics_are_the_reference_means():
    raw = np.random.default_rng(4).uniform(size=(500, 2)).astype(np.float32)
    from h2o_tpu.models.tree.isofor import AnomalyModel
    assert pmm.anomaly_metrics(raw).data == \
        AnomalyModel._metrics_from(raw).data
