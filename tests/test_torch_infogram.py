"""Infogram in the port held against ``h2o_tpu``'s on the CPU.

``test_rules_selection.py``'s data (1,500 rows, 4 predictors, the label
a logistic draw on 2.5 x0 + 2 x1; seed 3): the core infogram, and the
fair one with x3 protected.  Both packages train the same GBMs (one of
20 trees at depth 5 for the relevance, one of 10 trees at depth 3 per
predictor, on the conditioning set plus it), so the trees are equal and
the indices agree to their float32 sums: the relevance and information
indices within 1e-5, the admissible set and the table's order equal,
and the reference test's claims hold.  The converter keeps the table,
``Model.save``/``load`` round-trips it, and ``predict_raw`` is refused.
"""

import os
import tempfile

import numpy as np
import pytest

from h2o_tpu.core.frame import Frame as JFrame, T_CAT as J_CAT, Vec as JVec
from h2o_tpu.models.infogram import Infogram as JInfogram

from h2o_tpu_torch.core.frame import T_CAT, Frame, Vec
from h2o_tpu_torch.models.infogram import Infogram, infogram_from_jax_output
from h2o_tpu_torch.models.model import Model

pytestmark = pytest.mark.shared_dkv

CASES = {"core": {}, "fair": dict(protected_columns=["x3"])}


def _frames():
    rng = np.random.default_rng(42)
    n = 1500
    X = rng.normal(size=(n, 4)).astype(np.float32)
    logits = 2.5 * X[:, 0] + 2.0 * X[:, 1]
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-logits))).astype(np.int32)
    names = [f"x{j}" for j in range(4)] + ["y"]
    jf = JFrame(names, [JVec(X[:, j]) for j in range(4)] +
                [JVec(y, J_CAT, domain=["0", "1"])])
    pf = Frame(names, [Vec(X[:, j]) for j in range(4)] +
               [Vec(y, T_CAT, domain=["0", "1"])])
    return jf, pf


@pytest.fixture(scope="module")
def fits(cl):
    jf, pf = _frames()
    return {case: (pf, JInfogram(seed=3, **kw).train(y="y", training_frame=jf),
                   Infogram(device="cpu", seed=3, **kw).train(
                       y="y", training_frame=pf))
            for case, kw in CASES.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_infogram_matches_reference(fits, case):
    _, jm, pm = fits[case]
    jt, pt = jm.result(), pm.result()
    assert [r[0] for r in pt] == [r[0] for r in jt]
    for a, b in zip(pt, jt):
        assert abs(a[1] - b[1]) <= 1e-5 and abs(a[2] - b[2]) <= 1e-5, (a, b)
        assert a[3] == b[3]
    assert pm.admissible_features() == jm.admissible_features()
    assert pm.output["training_metrics"]["admissible_features"] == \
        jm.admissible_features()
    adm = pm.admissible_features()
    table = {r[0]: r for r in pt}
    if case == "core":                  # the reference test's claims
        assert "x0" in adm and "x1" in adm
        assert table["x0"][1] > table["x2"][1]
        assert table["x0"][2] > table["x2"][2]
    else:
        assert "x3" not in table and pm.output["protected_columns"] == ["x3"]


def test_converter_save_load_and_refusals(fits):
    pf, jm, pm = fits["core"]
    cm = infogram_from_jax_output(jm.output, jm.params, device="cpu")
    assert cm.result() == [tuple(r) for r in jm.result()]
    assert cm.admissible_features() == jm.admissible_features()
    with tempfile.TemporaryDirectory() as d:
        back = Model.load(pm.save(os.path.join(d, "ig.bin")), device="cpu")
    assert back.result() == pm.result()
    with pytest.raises(NotImplementedError, match="diagnostic"):
        pm.predict_raw(pf)
    with pytest.raises(ValueError, match="cross-validation"):
        Infogram(device="cpu", nfolds=3).train(y="y", training_frame=pf)
