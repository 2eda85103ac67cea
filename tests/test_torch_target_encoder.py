"""TargetEncoder in the port held against ``h2o_tpu``'s on the CPU.

The data of ``test_tree_variants.py``'s three TargetEncoder tests (a
4-level column with known level means, KFold with 5 folds, blending of
a rare level) and three more: LeaveOneOut with blending, a weighted
frame with NA responses, NA codes and two encoded columns under a
``fold_column``, and KFold with noise 0.02 and a seed; each transformed
as training and as scoring, the scoring frame also with an unseen level.

Tolerances: the (fold, level) counts and response sums within 1e-6
relative (one-hot products summed in another order; they are integers
here and come out equal), the prior equal; the encodings equal with
``noise=0`` and the noisy ones within 1e-6 (the same ``default_rng``
draws added to the same float32 values, in float64, then cast).  The
converter transforms like the reference model, ``Model.save``/``load``
round-trips one, and the leakage modes the reference treats as None are
refused by name.
"""

import os
import tempfile

import numpy as np
import pytest

from h2o_tpu.core.frame import Frame as JFrame, T_CAT as J_CAT, Vec as JVec
from h2o_tpu.models.target_encoder import TargetEncoder as JTE

from h2o_tpu_torch.core.frame import T_CAT, Frame, Vec
from h2o_tpu_torch.models.model import Model
from h2o_tpu_torch.models.target_encoder import (
    TargetEncoder, level_fold_aggregates, targetencoder_from_jax_output)
from h2o_tpu_torch.core.store import unpublish_on_exit


@pytest.fixture(autouse=True)
def _unpublish():
    """What a test publishes in the port's DKV is removed after it."""
    with unpublish_on_exit():
        yield


pytestmark = pytest.mark.shared_dkv


def _pair(cols):
    jv, pv = [], []
    for v, dom in cols.values():
        if dom is None:
            jv.append(JVec(v.astype(np.float32)))
            pv.append(Vec(v.astype(np.float32)))
        else:
            jv.append(JVec(v.astype(np.int32), J_CAT, domain=dom))
            pv.append(Vec(v.astype(np.int32), T_CAT, domain=dom))
    return JFrame(list(cols), jv), Frame(list(cols), pv)


def _data(case):
    rng = np.random.default_rng(42)
    if case == "basic":             # test_target_encoder_basic
        n = 2000
        c = rng.integers(0, 4, n)
        y = (rng.uniform(size=n) < np.array([0.1, 0.4, 0.6, 0.9])[c])
        return _pair({"cat": (c, list("abcd")),
                      "y": (y, ["0", "1"])}), dict(noise=0.0), ["cat"]
    if case == "kfold":             # ..._kfold_leakage_handling
        n = 1000
        return _pair({"cat": (rng.integers(0, 3, n), list("xyz")),
                      "y": (rng.integers(0, 2, n), ["0", "1"])}), \
            dict(data_leakage_handling="KFold", nfolds=5, noise=0.0), ["cat"]
    if case == "blending":          # ..._blending_pulls_rare_levels
        n = 500
        c = np.where(rng.uniform(size=n) < 0.02, 1, 0)
        y = np.where(c == 1, 1, rng.integers(0, 2, n))
        return _pair({"cat": (c, ["a", "b"]), "y": (y, ["0", "1"])}), \
            dict(blending=True, inflection_point=20.0, smoothing=10.0,
                 noise=0.0), ["cat"]
    n = 1500
    c1 = rng.integers(0, 6, n)
    c2 = rng.integers(0, 3, n)
    y = (rng.uniform(size=n) < 0.2 + 0.1 * c1).astype(np.int32)
    if case == "loo":
        return _pair({"c1": (c1, list("abcdef")), "y": (y, ["n", "p"])}), \
            dict(data_leakage_handling="LeaveOneOut", blending=True,
                 noise=0.0), ["c1"]
    if case == "weighted_folds":
        c1[rng.uniform(size=n) < 0.04] = -1
        y[rng.uniform(size=n) < 0.03] = -1
        w = (rng.integers(1, 5, n) / 2).astype(np.float32)
        f = rng.integers(0, 4, n).astype(np.float32)
        return _pair({"c1": (c1, list("abcdef")), "c2": (c2, list("uvw")),
                      "w": (w, None), "f": (f, None),
                      "y": (y, ["n", "p"])}), \
            dict(data_leakage_handling="KFold", fold_column="f",
                 weights_column="w", blending=True, noise=0.0), ["c1", "c2"]
    return _pair({"c1": (c1, list("abcdef")), "c2": (c2, list("uvw")),
                  "y": (y, ["n", "p"])}), \
        dict(data_leakage_handling="KFold", nfolds=3, noise=0.02,
             seed=11), ["c1", "c2"]


CASES = ("basic", "kfold", "blending", "loo", "weighted_folds", "noisy")


@pytest.fixture(scope="module")
def fits(cl):
    out = {}
    for case in CASES:
        (jf, pf), kw, x = _data(case)
        out[case] = (jf, pf, kw, JTE(**kw).train(x=x, y="y",
                                                 training_frame=jf),
                     TargetEncoder(device="cpu", **kw).train(
                         x=x, y="y", training_frame=pf))
    return out


@pytest.mark.parametrize("case", CASES)
def test_aggregates_match_reference(fits, case):
    _, _, _, jm, pm = fits[case]
    jo, po = jm.output, pm.output
    assert po["columns"] == list(jo["columns"])
    assert po["prior"] == jo["prior"]
    for c in po["columns"]:
        for k in ("cnt", "sum"):
            np.testing.assert_allclose(po["enc"][c][k],
                                       np.asarray(jo["enc"][c][k]),
                                       rtol=1e-6, atol=0, err_msg=k)
    if jo["fold_assign"] is None:
        assert po["fold_assign"] is None
    else:
        np.testing.assert_array_equal(po["fold_assign"], jo["fold_assign"])


def _unseen(case, jf, pf):
    """The training frame with one code outside each column's domain."""
    def bump(fr, vec_cls, cat):
        vecs = []
        for nm, v in zip(fr.names, fr.vecs):
            d = np.array(v.to_numpy())
            if v.domain is not None and nm != "y":
                d = d.copy()
                d[:7] = len(v.domain)
            vecs.append(vec_cls(d, cat, domain=v.domain)
                        if v.domain is not None else vec_cls(d))
        return type(fr)(list(fr.names), vecs)
    return bump(jf, JVec, J_CAT), bump(pf, Vec, T_CAT)


@pytest.mark.parametrize("case", CASES)
def test_encodings_match_reference(fits, case):
    jf, pf, kw, jm, pm = fits[case]
    ju, pu = _unseen(case, jf, pf)
    for j, p, as_training in ((jf, pf, True), (jf, pf, False),
                              (ju, pu, False)):
        tj = jm.transform(j, as_training=as_training)
        tp = pm.transform(p, as_training=as_training)
        for c in pm.output["columns"]:
            a = tp.vec(f"{c}_te").to_numpy()
            b = np.asarray(tj.vec(f"{c}_te").to_numpy())[: p.nrows]
            assert a.dtype == np.float32
            if as_training and kw.get("noise", 0.01) > 0:
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
            else:
                np.testing.assert_array_equal(a, b)


def test_reference_claims(fits):
    """``test_tree_variants.py``'s claims hold for the port."""
    _, pf, _, _, pm = fits["basic"]
    c = pf.vec("cat").to_numpy()
    y = pf.vec("y").to_numpy()
    enc = pm.transform(pf).vec("cat_te").to_numpy()
    for k in range(4):
        assert abs(enc[c == k][0] - y[c == k].mean()) < 1e-5
    _, pf, _, _, pm = fits["kfold"]
    e1 = pm.transform(pf, as_training=True).vec("cat_te").to_numpy()
    e2 = pm.transform(pf).vec("cat_te").to_numpy()
    assert not np.allclose(e1, e2)
    assert abs(e1.mean() - pf.vec("y").to_numpy().mean()) < 0.05


def test_blocked_products_equal_one_product():
    """Row blocks of the one-hot products add up to the whole product."""
    import torch
    import h2o_tpu_torch.models.target_encoder as te
    rng = np.random.default_rng(0)
    n, card = 5000, 300
    codes = torch.from_numpy(rng.integers(-1, card, n).astype(np.int32))
    y = torch.from_numpy(rng.integers(0, 2, n).astype(np.float32))
    w = torch.ones(n)
    fold = torch.from_numpy((np.arange(n) % 4).astype(np.int32))
    whole = level_fold_aggregates(codes, y, w, fold, card, 4)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(te, "BLOCK_ELEMS", 700 * card)
        blocked = level_fold_aggregates(codes, y, w, fold, card, 4)
    for a, b in zip(whole, blocked):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_converter_and_save_load(fits):
    jf, pf, kw, jm, _ = fits["noisy"]
    out = {k: v for k, v in jm.output.items()}
    out["enc"] = {c: {k: np.asarray(a) for k, a in e.items()}
                  for c, e in out["enc"].items()}
    cm = targetencoder_from_jax_output(out, jm.params, device="cpu")
    for as_training in (False, True):
        want = jm.transform(jf, as_training=as_training)
        got = cm.transform(pf, as_training=as_training)
        for c in ("c1", "c2"):
            np.testing.assert_allclose(
                got.vec(f"{c}_te").to_numpy(),
                np.asarray(want.vec(f"{c}_te").to_numpy())[: pf.nrows],
                rtol=1e-6, atol=1e-6)
    with tempfile.TemporaryDirectory() as d:
        path = cm.save(os.path.join(d, "te.bin"))
        back = Model.load(path, device="cpu")
    np.testing.assert_array_equal(
        back.transform(pf).vec("c1_te").to_numpy(),
        cm.transform(pf).vec("c1_te").to_numpy())


def test_refusals(fits):
    _, pf, _, _, _ = fits["basic"]
    with pytest.raises(ValueError, match="data_leakage_handling"):
        TargetEncoder(device="cpu", data_leakage_handling="KFoldish")
    pf2 = Frame(list(pf.names) + ["num"],
                list(pf.vecs) + [Vec(np.arange(pf.nrows, dtype=np.float32))])
    with pytest.raises(ValueError, match="categorical"):
        TargetEncoder(device="cpu", columns=["num"]).train(
            y="y", training_frame=pf2)
    # recovery_dir: the build's snapshot, dropped when it succeeds, as
    # the reference's; no iteration checkpoint
    from h2o_tpu_torch.core.recovery import pending_recoveries
    with tempfile.TemporaryDirectory() as d:
        TargetEncoder(device="cpu", recovery_dir=d).train(
            y="y", training_frame=pf)
        assert pending_recoveries(d) == [] and os.listdir(d) == []
    with pytest.raises(NotImplementedError):
        TargetEncoder(device="cpu").train(
            y="y", training_frame=pf).predict_raw(pf)
