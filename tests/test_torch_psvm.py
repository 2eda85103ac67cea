"""PSVM in the port held against ``h2o_tpu``'s on the CPU.

Two cases: ``test_rules_selection.py``'s circle (1,500 rows, 2
features, ``y = [x0^2 + x1^2 < 1]``, C 1, 300 iterations, seed 1),
whose classes the Fourier features separate, and a noisy frame (10 % of
labels flipped; 3 numerics with NaN cells and a categorical; 64
features, positive_weight 2, 100 iterations, seed 3).  The port's
``statpack.ROW_QUANTUM`` is the 8-device mesh's 64, so the step's row
count R is the reference's padded one.

- W and b bitwise (``ops/prng`` is ``jax.random`` bit for bit);
- Z = sqrt(2/D) cos(X W + b) within its rounding bound, per element:
  sqrt(2/D) times [(P + 2) 2^-24 (|X| |W| + |b|), the product's and
  bias's rounding, plus |X_port - X_ref| |W|, the expansions' float32
  standardization, plus 2^-23 for cos's last place] plus Z's own last
  place: XLA's CPU ``cos`` and torch's differ in the last place (and
  CUDA's is a third implementation), so Z is not held bitwise;
- the averaged beta within 1e-4 of its largest |value| and the decision
  values within 1e-4 of theirs: the hinge masks ``margin < 1`` are the
  same at every step on this data (``tools/torch_port_probes.py psvm``
  prints the first step where they part, and the drift);
- labels equal, p1 within 1e-4; Platt's (a, b) within 1e-4 relative on
  the noisy frame.  On the separable circle Platt's Newton steps diverge
  in both packages (|a| passes 1e8, and their a differ by about 1 %), p1
  saturating alike;
- the reference test's claims: accuracy > 0.9 and AUC > 0.95.

The converter scores like the reference model, ``Model.save``/``load``
round-trips one, and the kernels other than gaussian and iteration
checkpoints are refused by name.
"""

import os
import tempfile
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from h2o_tpu.core.frame import Frame as JFrame, T_CAT as J_CAT, Vec as JVec
from h2o_tpu.models.glm import expand_for_scoring as j_expand
from h2o_tpu.models.psvm import PSVM as JPSVM

from h2o_tpu_torch.core.frame import T_CAT, Frame, Vec
from h2o_tpu_torch.models.glm import expand_for_scoring
from h2o_tpu_torch.models.model import Model
from h2o_tpu_torch.models.psvm import (PSVM, fourier_features,
                                       psvm_from_jax_output)
from h2o_tpu_torch.ops import statpack
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
    if case == "circle":
        n = 1500
        X = rng.normal(size=(n, 2)).astype(np.float32)
        y = ((X[:, 0] ** 2 + X[:, 1] ** 2) < 1.0).astype(np.int32)
        return _pair({"x0": (X[:, 0], None), "x1": (X[:, 1], None),
                      "y": (y, ["0", "1"])}), \
            dict(hyper_param=1.0, max_iterations=300, seed=1)
    n = 1200
    X = rng.normal(size=(n, 3)).astype(np.float32)
    c = rng.integers(0, 3, n)
    y = ((X[:, 0] - X[:, 1] ** 2 + 0.8 * (c == 1)) > 0).astype(np.int32)
    flip = rng.uniform(size=n) < 0.1
    y[flip] = 1 - y[flip]
    X[rng.uniform(size=n) < 0.03, 2] = np.nan
    return _pair({"x0": (X[:, 0], None), "x1": (X[:, 1], None),
                  "x2": (X[:, 2], None), "c": (c, list("pqr")),
                  "y": (y, ["n", "p"])}), \
        dict(feature_dim=64, positive_weight=2.0, max_iterations=100, seed=3)


CASES = ("circle", "noisy")


@pytest.fixture(scope="module")
def fits(cl):
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(statpack, "ROW_QUANTUM", 64)
        for case in CASES:
            (jf, pf), kw = _data(case)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                out[case] = (jf, pf, kw,
                             JPSVM(**kw).train(y="y", training_frame=jf),
                             PSVM(device="cpu", **kw).train(
                                 y="y", training_frame=pf))
    return out


@pytest.mark.parametrize("case", CASES)
def test_fourier_map_matches_reference(fits, case):
    jf, pf, _, jm, pm = fits[case]
    jo, po = jm.output, pm.output
    np.testing.assert_array_equal(po["rff_w"], np.asarray(jo["rff_w"]))
    np.testing.assert_array_equal(po["rff_b"], np.asarray(jo["rff_b"]))
    assert po["gamma"] == jo["gamma"] and \
        po["feature_dim"] == jo["feature_dim"]
    W, b = po["rff_w"], po["rff_b"]
    Xr = np.asarray(j_expand(jf, jo["expansion_spec"]))[: pf.nrows]
    Xp = expand_for_scoring(pf, po["expansion_spec"], "cpu")
    Zr = np.asarray(jnp.sqrt(2.0 / W.shape[1]) *
                    jnp.cos(jnp.asarray(Xr) @ W + b[None, :]))
    Zp = fourier_features(Xp, torch.from_numpy(W),
                          torch.from_numpy(b)).numpy()
    Xp = Xp.numpy()
    P = W.shape[0]
    scale = np.sqrt(2.0 / W.shape[1])
    absW = np.abs(W).astype(np.float64)
    bound = scale * ((P + 2) * 2.0 ** -24 * (np.abs(Xr) @ absW + np.abs(b))
                     + np.abs(Xp - Xr) @ absW + 2.0 ** -23) + \
        np.spacing(np.abs(Zr).astype(np.float32))
    assert np.all(np.abs(Zp - Zr) <= bound)


@pytest.mark.parametrize("case", CASES)
def test_fit_matches_reference(fits, case):
    jf, pf, _, jm, pm = fits[case]
    jo, po = jm.output, pm.output
    bj = np.asarray(jo["beta"])
    assert np.abs(po["beta"] - bj).max() <= 1e-4 * np.abs(bj).max()
    fj = np.asarray(jm.output["beta"])      # decision values
    dec_p = pm.decision(pf).numpy()
    Xr = jnp.asarray(np.asarray(j_expand(jf, jo["expansion_spec"])))
    W, b = jnp.asarray(jo["rff_w"]), jnp.asarray(jo["rff_b"])
    dec_j = np.asarray((jnp.sqrt(2.0 / W.shape[1]) *
                        jnp.cos(Xr @ W + b[None, :])) @ fj[:-1] +
                       fj[-1])[: pf.nrows]
    assert np.abs(dec_p - dec_j).max() <= 1e-4 * np.abs(dec_j).max()
    raw_j = np.asarray(jm.predict_raw(jf))[: pf.nrows]
    raw_p = pm.predict_raw(pf).numpy()
    np.testing.assert_array_equal(raw_p[:, 0], raw_j[:, 0])
    np.testing.assert_allclose(raw_p[:, 1:], raw_j[:, 1:], rtol=0,
                               atol=1e-4)
    assert po["svs_count"] == jo["svs_count"]
    tm = po["training_metrics"]
    assert abs(tm["AUC"] - jo["training_metrics"]["AUC"]) <= 1e-6
    if case == "circle":                # the reference test's claims
        y = pf.vec("y").to_numpy()
        assert float((raw_p[:, 0] == y).mean()) > 0.9 and tm["AUC"] > 0.95
        assert abs(po["platt_a"]) > 1e8 and abs(jo["platt_a"]) > 1e8
    else:
        for k in ("platt_a", "platt_b"):
            np.testing.assert_allclose(po[k], jo[k], rtol=1e-4)


def test_converter_save_load_and_refusals(fits):
    jf, pf, _, jm, pm = fits["noisy"]
    out = {k: (np.asarray(v) if hasattr(v, "shape") else v)
           for k, v in jm.output.items()}
    cm = psvm_from_jax_output(out, jm.params, device="cpu")
    want = np.asarray(jm.predict_raw(jf))[: pf.nrows]
    got = cm.predict_raw(pf).numpy()
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_allclose(got[:, 1:], want[:, 1:], rtol=0, atol=1e-5)
    with tempfile.TemporaryDirectory() as d:
        back = Model.load(pm.save(os.path.join(d, "psvm.bin")), device="cpu")
    np.testing.assert_array_equal(back.predict_raw(pf).numpy(),
                                  pm.predict_raw(pf).numpy())
    with pytest.raises(ValueError, match="kernel_type"):
        PSVM(device="cpu", kernel_type="polynomial")
    # recovery_dir: the build's snapshot, dropped when it succeeds, as
    # the reference's; no iteration checkpoint
    from h2o_tpu_torch.core.recovery import pending_recoveries
    with tempfile.TemporaryDirectory() as d, warnings.catch_warnings():
        warnings.simplefilter("ignore")             # the Fourier note
        PSVM(device="cpu", max_iterations=2, recovery_dir=d).train(
            y="y", training_frame=pf)
        assert pending_recoveries(d) == [] and os.listdir(d) == []
    with pytest.warns(UserWarning, match="Fourier"):
        PSVM(device="cpu", max_iterations=2).train(y="y", training_frame=pf)
    three = Frame(["x0", "y"], [Vec(np.arange(9, dtype=np.float32)),
                                Vec(np.arange(9) % 3, T_CAT,
                                    domain=list("abc"))])
    with pytest.raises(ValueError, match="binary"), \
            warnings.catch_warnings():
        warnings.simplefilter("ignore")
        PSVM(device="cpu").train(y="y", training_frame=three)
