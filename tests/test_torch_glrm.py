"""GLRM in the port held against ``h2o_tpu``'s on the CPU.

The same seeded numpy matrices go to ``h2o_tpu.models.glrm.GLRM`` (on
the 8-device CPU mesh) and to the port's ``GLRM(device="cpu")``: the
three cases of ``test_matrix_algos.py`` (low-rank recovery, 20 %
missing cells, NonNegative on both factors), a Random init with a
Quadratic Y regularizer, Huber loss with an L1 X regularizer, and a
frame with a categorical column.

The reference's R is its padded row count, rows rounded up to 64 on the
test mesh (8 devices x row_align 8); the port takes R from
``statpack.padded_rows``, one device's 128.  R enters the starting step
and the Random init's draw, so the two agree where both pad alike: the
tests set the port's quantum to the mesh's (``statpack.ROW_QUANTUM``
64), and ``test_random_init_where_both_pad_alike`` runs 512 rows, which
both pad to 512, at the port's own quantum.

Tolerances: the first 20 accepted objectives within 1e-5 relative each
(these runs: within 2.2e-6).  The accept test ``new < old`` is a discrete
decision on float32 values, and later steps amplify the last bits: the
final objective and numerr are held within 1e-4 relative where the fit
converges (recovery, NonNegative, Huber/L1, the categorical frame),
even where the packages' last accept differs (recovery stops after 13
iterations in the reference and 12 in the port at objectives 4.4e-7
apart).  On the two slowly converging paths (missing cells at their
300-iteration cap, 0.8 % apart by then; the Random init, numerr 2.6e-4
apart) the final values are held against the reference test's own
claims and the drift is printed by ``tools/torch_port_probes.py
glrm``.  Scoring from one set of archetypes (the converter) is held
within 1e-5 of the reference's.
"""

import os
import tempfile

import numpy as np
import pytest

from h2o_tpu.core.frame import Frame as JFrame, T_CAT as J_CAT, Vec as JVec
from h2o_tpu.models.glrm import GLRM as JGLRM

from h2o_tpu_torch.core.frame import T_CAT, Frame, Vec
from h2o_tpu_torch.models.glrm import GLRM, GLRMModel, glrm_from_jax_output
from h2o_tpu_torch.models.model import Model
from h2o_tpu_torch.ops import statpack

pytestmark = pytest.mark.shared_dkv


@pytest.fixture(autouse=True)
def mesh_quantum(monkeypatch):
    monkeypatch.setattr(statpack, "ROW_QUANTUM", 64)


def _pair(A, cat=None):
    names = [f"x{j}" for j in range(A.shape[1])]
    jv = [JVec(A[:, j]) for j in range(A.shape[1])]
    pv = [Vec(A[:, j]) for j in range(A.shape[1])]
    if cat is not None:
        names.append("k")
        jv.append(JVec(cat, J_CAT, domain=list("pqr")))
        pv.append(Vec(cat, T_CAT, domain=list("pqr")))
    return JFrame(names, jv), Frame(names, pv)


def _low_rank():                 # test_glrm_low_rank_recovery
    rng = np.random.default_rng(42)
    Xt = rng.normal(size=(400, 3)).astype(np.float32)
    Yt = rng.normal(size=(3, 8)).astype(np.float32)
    return Xt @ Yt + 0.01 * rng.normal(size=(400, 8)).astype(np.float32)


def _missing():                  # test_glrm_handles_missing_cells
    rng = np.random.default_rng(42)
    A = (rng.normal(size=(300, 2)) @ rng.normal(size=(2, 6))).astype(
        np.float32)
    holes = rng.uniform(size=A.shape) < 0.2
    A_obs = A.copy()
    A_obs[holes] = np.nan
    return A_obs, A, holes


def _nonneg():                   # test_glrm_nonneg_regularizer
    rng = np.random.default_rng(42)
    return np.abs(rng.normal(size=(200, 5))).astype(np.float32)


def _mixed():
    rng = np.random.default_rng(3)
    A = (rng.normal(size=(256, 2)) @ rng.normal(size=(2, 4))).astype(
        np.float32)
    A[rng.uniform(size=A.shape) < 0.1] = np.nan
    cat = rng.integers(0, 3, 256).astype(np.int32)
    cat[rng.uniform(size=256) < 0.05] = -1
    return A, cat


#: case -> (matrix builder, params, converges)
CASES = {
    "recovery": (lambda: (_low_rank(), None),
                 dict(k=3, max_iterations=300, seed=1), True),
    "missing": (lambda: (_missing()[0], None),
                dict(k=2, max_iterations=300, seed=2), False),
    "nonneg": (lambda: (_nonneg(), None),
               dict(k=2, regularization_x="NonNegative",
                    regularization_y="NonNegative", max_iterations=150,
                    seed=3), True),
    "random_quadratic": (lambda: (_low_rank(), None),
                         dict(k=3, init="Random",
                              regularization_y="Quadratic", gamma_y=0.5,
                              max_iterations=200, seed=4), False),
    "huber_l1": (lambda: (_missing()[0], None),
                 dict(k=2, loss="Huber", regularization_x="L1", gamma_x=0.1,
                      max_iterations=200, seed=5), True),
    "categorical": (_mixed, dict(k=2, max_iterations=100, seed=6,
                                 transform="STANDARDIZE"), True),
}


@pytest.fixture(scope="module")
def fits(cl):
    out = {}
    mp = pytest.MonkeyPatch()
    mp.setattr(statpack, "ROW_QUANTUM", 64)
    try:
        for case, (make, kw, _) in CASES.items():
            A, cat = make()
            jf, pf = _pair(A, cat)
            out[case] = (jf, pf, JGLRM(**kw).train(training_frame=jf),
                         GLRM(device="cpu", **kw).train(training_frame=pf))
    finally:
        mp.undo()
    return out


def _cols(fr, n):
    return np.stack([np.asarray(fr.vec(c).to_numpy())[:n]
                     for c in fr.names], axis=1)


@pytest.mark.parametrize("case", sorted(CASES))
def test_glrm_matches_reference(fits, case):
    jf, pf, jm, pm = fits[case]
    jo, po = jm.output, pm.output
    assert po["feature_names"] == list(jo["feature_names"])
    jh, ph = np.asarray(jo["history"]), np.asarray(po["history"])
    m = min(20, len(jh), len(ph))
    np.testing.assert_allclose(ph[:m], jh[:m], rtol=1e-5)
    assert po["archetypes"].shape == np.asarray(jo["archetypes"]).shape
    if CASES[case][2]:
        np.testing.assert_allclose(po["objective"], jo["objective"],
                                   rtol=1e-4)
        np.testing.assert_allclose(po["numerr"], jo["numerr"], rtol=1e-4)
    tm = po["training_metrics"]
    assert tm.kind == "glrm" and tm["iterations"] == po["iterations"]
    assert po["representation_frame"].names == [
        f"Arch{i + 1}" for i in range(po["k"])]
    assert po["representation_frame"].nrows == pf.nrows


def test_reference_claims(fits):
    """The reference tests' claims, on the port's fits."""
    _, pf, _, pm = fits["recovery"]
    A = _low_rank()
    assert pm.output["numerr"] / np.sum(A ** 2) < 0.02
    assert pm.output["archetypes"].shape == (3, 8)
    xf = pm.transform(pf)
    assert xf.ncols == 3 and xf.nrows == 400
    _, pf, jm, pm = fits["missing"]
    _, A, holes = _missing()
    for m, n in ((pm, pf.nrows), (jm, pf.nrows)):
        fr = pf if m is pm else fits["missing"][0]
        recon = _cols(m.predict(fr), n)
        assert np.median(np.abs(recon[holes] - A[holes])) < 0.35
    assert (fits["nonneg"][3].output["archetypes"] >= 0).all()
    _, _, jm, pm = fits["random_quadratic"]
    for m in (jm, pm):             # the fit has left its random start
        assert m.output["objective"] < 0.01 * m.output["history"][0]


def test_random_init_where_both_pad_alike(cl, monkeypatch):
    """512 rows pad to 512 on the mesh and at the port's own quantum."""
    monkeypatch.setattr(statpack, "ROW_QUANTUM", 128)
    rng = np.random.default_rng(9)
    A = (rng.normal(size=(512, 2)) @ rng.normal(size=(2, 5)) +
         0.1 * rng.normal(size=(512, 5))).astype(np.float32)
    jf, pf = _pair(A)
    kw = dict(k=2, init="Random", max_iterations=40, seed=11)
    jm = JGLRM(**kw).train(training_frame=jf)
    pm = GLRM(device="cpu", **kw).train(training_frame=pf)
    jh, ph = np.asarray(jm.output["history"]), np.asarray(pm.output["history"])
    m = min(20, len(jh), len(ph))
    np.testing.assert_allclose(ph[:m], jh[:m], rtol=1e-5)
    assert statpack.padded_rows(512, statpack.ROW_QUANTUM) == 512


@pytest.mark.parametrize("case", ["recovery", "missing", "categorical"])
def test_converter_scores_as_reference(fits, case):
    """One set of archetypes: the 30-iteration X solve, its
    reconstruction and its archetype coordinates within 1e-5 (scaled
    by the largest |value|)."""
    jf, pf, jm, _ = fits[case]
    cm = glrm_from_jax_output(jm.output, jm.params, device="cpu")
    assert isinstance(cm, GLRMModel)
    for fn in ("predict", "transform"):
        got = _cols(getattr(cm, fn)(pf), pf.nrows)
        want = _cols(getattr(jm, fn)(jf), pf.nrows)
        assert getattr(cm, fn)(pf).names == getattr(jm, fn)(jf).names
        scale = np.abs(want).max()
        np.testing.assert_allclose(got / scale, want / scale, rtol=0,
                                   atol=1e-5)


def test_save_load(fits):
    _, pf, _, pm = fits["categorical"]
    with tempfile.TemporaryDirectory() as d:
        m2 = Model.load(pm.save(os.path.join(d, "glrm.bin")), device="cpu")
    assert isinstance(m2, GLRMModel)
    np.testing.assert_array_equal(m2.predict_raw(pf).numpy(),
                                  pm.predict_raw(pf).numpy())


@pytest.mark.parametrize("kw", [
    dict(regularization_x="OneSparse"), dict(regularization_y="Simplex"),
    dict(loss="Periodic"), dict(init="PlusPlus"), dict(transform="DEMEAN"),
    dict(multi_loss="Ordinal"), dict(recover_svd=True)],
    ids=["rx_onesparse", "ry_simplex", "loss_periodic", "init_plusplus",
         "transform_demean", "multi_loss", "recover_svd"])
def test_refusals(kw):
    with pytest.raises(ValueError, match=list(kw)[0]):
        GLRM(device="cpu", **kw)
