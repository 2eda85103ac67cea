"""PCA and SVD in the port held against ``h2o_tpu``'s on the CPU.

The same seeded numpy columns go to ``h2o_tpu.models.pca.PCA`` /
``h2o_tpu.models.svd.SVD`` (on the 8-device CPU mesh) and to the port's
builders with ``device="cpu"``: the data of ``test_algos.py::
test_pca_variance_split`` and of ``test_matrix_algos.py``'s three SVD
tests, and a frame with NaNs and a categorical column (one-hot) under
each transform.

Tolerances: eigenvalues (PCA's variances) and SVD's ``d`` within 1e-5 relative,
plus 1e-6 of the largest: the two Grams are float32 sums in different orders,
and an eigenvalue moves by up to the norm of that difference (Weyl), so a small
one (``corr``'s 2.1e-3 beside 5.2) is determined only to ~2e-7 absolute;
eigenvectors and V with equal column signs (the host factorization is LAPACK's
``evd``, as the reference's, so the signs are never flipped to match) and
values within 1e-5; Randomized's Omega bitwise the reference's draw, its V
within 1e-4 (three (P, k) QRs of products whose summation order differs);
scores within 1e-5 of the largest |score| (a score's error is |x| times its
vector's).

Randomized's V is held up to each column's sign.  LAPACK's ``evd``
returns the reference's bits, signs included, on the same matrix
(``test_factorizations_are_the_references``), but its signs are not
continuous in the input: the projected Gram B = Q'X'XQ is a float32
product whose summation order differs between XLA and torch (the two
B's 1e-4 apart at a scale of 2,590 on ``corr``), and that alone negates
two of four eigenvectors there, and two of three on ``mixed``.  The
Gram path's signs (PCA, GramSVD, Power) are held equal.
"""

import os
import tempfile

import jax
import numpy as np
import pytest

from h2o_tpu.core.frame import Frame as JFrame, T_CAT as J_CAT, Vec as JVec
from h2o_tpu.models.pca import PCA as JPCA
from h2o_tpu.models.svd import SVD as JSVD

from h2o_tpu_torch.core.frame import T_CAT, Frame, Vec
from h2o_tpu_torch.models.model import Model
from h2o_tpu_torch.models.pca import PCA, PCAModel, pca_from_jax_output
from h2o_tpu_torch.models.svd import SVD, SVDModel, svd_from_jax_output
from h2o_tpu_torch.ops import prng
from h2o_tpu_torch.core.store import unpublish_on_exit


@pytest.fixture(autouse=True)
def _unpublish():
    """What a test publishes in the port's DKV is removed after it."""
    with unpublish_on_exit():
        yield


pytestmark = pytest.mark.shared_dkv


def _pair(X, cat=None):
    names = [f"x{j}" for j in range(X.shape[1])]
    jv = [JVec(X[:, j]) for j in range(X.shape[1])]
    pv = [Vec(X[:, j]) for j in range(X.shape[1])]
    if cat is not None:
        names.append("k")
        jv.append(JVec(cat, J_CAT, domain=list("pqrs")))
        pv.append(Vec(cat, T_CAT, domain=list("pqrs")))
    return JFrame(names, jv), Frame(names, pv)


def _data(case):
    rng = np.random.default_rng(42)
    if case == "split":           # test_pca_variance_split
        z = rng.normal(size=(2000, 2)).astype(np.float32)
        mix = np.array([[3, 1, 0.5], [0, 0.5, -1.0]], np.float32)
        X = z @ mix + 0.01 * rng.normal(size=(2000, 3)).astype(np.float32)
        return _pair(X)
    if case == "corr":            # test_svd_matches_numpy
        X = rng.normal(size=(500, 6)).astype(np.float32)
        X[:, 1] = 2 * X[:, 0] + 0.1 * X[:, 1]
        return _pair(X)
    if case == "wide":            # test_svd_randomized_close_to_exact
        return _pair(rng.normal(size=(400, 8)).astype(np.float32))
    X = rng.normal(size=(800, 5)).astype(np.float32)
    X[:, 2] = X[:, 0] - 0.5 * X[:, 1] + 0.2 * X[:, 2]
    X[:, 4] *= 10.0
    X[rng.uniform(size=800) < 0.05, 3] = np.nan
    cat = rng.integers(0, 4, 800).astype(np.int32)
    cat[rng.uniform(size=800) < 0.03] = -1
    return _pair(X, cat)


@pytest.fixture(scope="module")
def frames(cl):
    return {c: _data(c) for c in ("split", "corr", "wide", "mixed")}


def _cols(fr, n):
    return np.stack([np.asarray(fr.vec(c).to_numpy())[:n]
                     for c in fr.names], axis=1)


def _vectors_close(got, want, atol, signs=True):
    """Equal column signs (with ``signs``; else each column aligned to
    the reference's sign), values within ``atol``."""
    if signs:
        np.testing.assert_array_equal(np.sign(got.sum(axis=0)),
                                      np.sign(want.sum(axis=0)))
    else:
        got = got * np.sign(np.sum(got * want, axis=0))[None, :]
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def _eig_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())


def _scores_close(pf, jf, pm, jm, atol=1e-5, signs=True):
    ps, js = _cols(pm.predict(pf), pf.nrows), _cols(jm.predict(jf), pf.nrows)
    if not signs:
        ps = ps * np.sign(np.sum(ps * js, axis=0))[None, :]
    scale = np.abs(js).max()
    np.testing.assert_allclose(ps / scale, js / scale, rtol=0, atol=atol)


PCA_CASES = {"split_demean": ("split", dict(k=3, transform="DEMEAN")),
             "mixed_standardize": ("mixed", dict(k=4,
                                                 transform="STANDARDIZE")),
             "mixed_none": ("mixed", dict(k=3, use_all_factor_levels=True)),
             "corr_demean": ("corr", dict(k=6, transform="DEMEAN"))}


@pytest.mark.parametrize("case", sorted(PCA_CASES))
def test_pca_matches_reference(frames, case):
    data, kw = PCA_CASES[case]
    jf, pf = frames[data]
    jm = JPCA(**kw).train(training_frame=jf)
    pm = PCA(device="cpu", **kw).train(training_frame=pf)
    jo, po = jm.output, pm.output
    assert po["coef_names"] == list(jo["coef_names"]) and po["k"] == jo["k"]
    _eig_close(po["std_deviation"] ** 2,
               np.asarray(jo["std_deviation"]) ** 2)
    _eig_close(po["pct_variance"], jo["pct_variance"])
    _vectors_close(po["eigenvectors"], np.asarray(jo["eigenvectors"]), 1e-5)
    _scores_close(pf, jf, pm, jm)
    assert pm.predict(pf).names == [f"PC{i + 1}" for i in range(po["k"])]
    tm = po["training_metrics"]
    assert tm.kind == "dimreduction"
    _eig_close(tm["pct_variance"], jo["training_metrics"]["pct_variance"])
    if case == "split_demean":    # the reference test's claims
        pct = po["pct_variance"]
        assert pct[0] > 0.5 and pct[0] + pct[1] > 0.99


SVD_CASES = {"gram": ("corr", dict(nv=3, svd_method="GramSVD")),
             "power": ("corr", dict(nv=2, svd_method="Power",
                                    transform="STANDARDIZE")),
             "randomized": ("wide", dict(nv=2, svd_method="Randomized",
                                         seed=0, max_iterations=8)),
             "randomized_mixed": ("mixed", dict(nv=3, seed=7,
                                                svd_method="Randomized",
                                                transform="DEMEAN")),
             "mixed_gram": ("mixed", dict(nv=4, transform="STANDARDIZE"))}


@pytest.mark.parametrize("case", sorted(SVD_CASES))
def test_svd_matches_reference(frames, case):
    data, kw = SVD_CASES[case]
    jf, pf = frames[data]
    jm = JSVD(keep_u=False, **kw).train(training_frame=jf)
    pm = SVD(device="cpu", **kw).train(training_frame=pf)
    jo, po = jm.output, pm.output
    assert po["v_names"] == list(jo["v_names"]) and po["nv"] == jo["nv"]
    _eig_close(po["d"] ** 2, np.asarray(jo["d"]) ** 2)
    randomized = kw.get("svd_method") == "Randomized"
    tol = 1e-4 if randomized else 1e-5
    _vectors_close(po["v"], np.asarray(jo["v"]), tol,
                   signs=not randomized)
    _scores_close(pf, jf, pm, jm, tol, signs=not randomized)
    assert pm.predict(pf).names == [f"SVD{i + 1}" for i in range(po["nv"])]
    _eig_close(np.asarray(po["training_metrics"]["d"]) ** 2,
               np.asarray(jo["training_metrics"]["d"]) ** 2)
    if case == "gram":            # test_svd_matches_numpy's claim
        X = _cols(pf, pf.nrows)
        s = np.linalg.svd(X, compute_uv=False)
        np.testing.assert_allclose(po["d"], s[:3], rtol=2e-3)
    if case == "randomized":      # test_svd_randomized_close_to_exact's
        s = np.linalg.svd(_cols(pf, pf.nrows), compute_uv=False)
        np.testing.assert_allclose(po["d"], s[:2], rtol=5e-2)


@pytest.mark.parametrize("seed,shape", [(0, (8, 2)), (7, (9, 3)),
                                        (123, (28, 10))])
def test_randomized_omega_is_the_reference_draw(seed, shape):
    """Omega = normal(key, (P, nv)), bitwise jax's."""
    got = prng.normal(prng.key(seed), shape, "cpu").numpy()
    want = np.asarray(jax.random.normal(jax.random.key(seed), shape))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case,nv,iters", [("mixed", 3, 10),
                                           ("wide", 2, 8), ("corr", 4, 2)])
def test_randomized_range_on_one_matrix(frames, case, nv, iters):
    """The port's ``randomized_range`` and the reference's
    ``_randomized_range`` on the same expanded matrix: V within 1e-5 up
    to each column's sign, the eigenvalues within 1e-5 relative."""
    import jax.numpy as jnp
    import torch
    from h2o_tpu.models.svd import _randomized_range
    from h2o_tpu_torch.models.pca import decomposition_matrix
    from h2o_tpu_torch.models.svd import randomized_range
    _, pf = frames[case]
    _, X = decomposition_matrix(pf, pf.names, torch.device("cpu"), "DEMEAN",
                                True)
    Vj, ej = _randomized_range(jnp.asarray(X.numpy()),
                               jnp.ones(X.shape[0], bool),
                               jax.random.key(7), nv, iters=iters)
    Vp, ep = randomized_range(X, prng.key(7), nv, iters)
    _vectors_close(Vp, np.asarray(Vj), 1e-5, signs=False)
    np.testing.assert_allclose(ep, np.asarray(ej), rtol=1e-5)


@pytest.mark.parametrize("P", [4, 5, 12, 28, 54])
def test_factorizations_are_the_references(P):
    """``eigh_desc`` and ``qr_q`` on one float32 matrix equal
    ``jnp.linalg.eigh`` (reordered as the reference reorders) and
    ``jnp.linalg.qr`` bit for bit, signs included."""
    import jax.numpy as jnp
    from h2o_tpu_torch.ops.linalg import eigh_desc, qr_q
    rng = np.random.default_rng(P)
    X = rng.normal(size=(3 * P, P)).astype(np.float32)
    G = X.T @ X
    e, v = jnp.linalg.eigh(jnp.asarray(G))
    order = jnp.argsort(-e)
    ge, gv = eigh_desc(G)
    np.testing.assert_array_equal(ge, np.asarray(jnp.maximum(e[order], 0)))
    np.testing.assert_array_equal(gv, np.asarray(v[:, order]))
    Y = X[:, : max(P // 3, 1)]
    np.testing.assert_array_equal(qr_q(Y),
                                  np.asarray(jnp.linalg.qr(jnp.asarray(Y))[0]))


def test_svd_keeps_u_frame(frames):
    """test_svd_keeps_u_frame's claims, the frame on the model (the
    reference's is in its DKV), and U equal to the reference's."""
    from h2o_tpu.core.cloud import cloud
    rng = np.random.default_rng(42)
    X = rng.normal(size=(300, 4)).astype(np.float32)
    jf, pf = _pair(X)
    pm = SVD(device="cpu", nv=2, keep_u=True).train(training_frame=pf)
    jm = JSVD(nv=2, keep_u=True).train(training_frame=jf)
    uf = pm.output["u_frame"]
    assert uf.names == ["u1", "u2"] and uf.nrows == 300
    U = _cols(uf, 300)
    np.testing.assert_allclose(U.T @ U, np.eye(2), atol=1e-2)
    ju = cloud().dkv.get(jm.output["u_key"])
    np.testing.assert_allclose(U, _cols(ju, 300), rtol=0, atol=1e-5)
    assert "u_frame" not in SVD(device="cpu", nv=2, keep_u=False).train(
        training_frame=pf).output


def test_converters_score_as_reference(frames):
    jf, pf = frames["mixed"]
    for jcls, conv, cls, kw, prefix in (
            (JPCA, pca_from_jax_output, PCAModel,
             dict(k=3, transform="STANDARDIZE"), "PC"),
            (JSVD, svd_from_jax_output, SVDModel,
             dict(nv=3, keep_u=False, transform="DEMEAN"), "SVD")):
        jm = jcls(**kw).train(training_frame=jf)
        cm = conv(jm.output, jm.params, device="cpu")
        assert isinstance(cm, cls)
        got = _cols(cm.predict(pf), pf.nrows)
        want = _cols(jm.predict(jf), pf.nrows)
        assert cm.predict(pf).names[0] == prefix + "1"
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_save_load(frames):
    _, pf = frames["mixed"]
    with tempfile.TemporaryDirectory() as d:
        for m in (PCA(device="cpu", k=2).train(training_frame=pf),
                  SVD(device="cpu", nv=2).train(training_frame=pf)):
            m2 = Model.load(m.save(os.path.join(d, m.algo + ".bin")),
                            device="cpu")
            assert type(m2) is type(m)
            np.testing.assert_array_equal(m2.predict_raw(pf).numpy(),
                                          m.predict_raw(pf).numpy())


@pytest.mark.parametrize("cls,kw", [
    (PCA, dict(pca_method="Power")), (PCA, dict(pca_method="GLRM")),
    (PCA, dict(transform="NORMALIZE")), (SVD, dict(svd_method="Lanczos")),
    (SVD, dict(transform="DESCALE"))],
    ids=["pca_power", "pca_glrm", "pca_normalize", "svd_lanczos",
         "svd_descale"])
def test_refusals(cls, kw):
    with pytest.raises(ValueError, match=list(kw)[0]):
        cls(device="cpu", **kw)
    with pytest.raises(ValueError, match="cross-validation"):
        cls(device="cpu", nfolds=3).train(training_frame=_data("wide")[1])
