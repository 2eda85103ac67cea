"""CPU probes behind the tolerances of the port's tests: where the
reference (``h2o_tpu``) and the port (``h2o_tpu_torch``) cannot agree
closer, because float32 rounding decides and both packages round.

    JAX_PLATFORMS=cpu python tools/torch_port_probes.py \
        [dl|gam|rulefit|glrm|word2vec|coxph|psvm ...]

Prints one JSON line per case:

- ``dl``: DeepLearning on HIGGS-like data (20,480 x 28, seed 0) after
  20 ... 200 ADADELTA steps at hidden [200, 200] and [16, 16]: the max
  |p(reference) - p(port)| over the rows, and the port against itself
  (0: the drift is the two packages' rounding, amplified by training);
- ``gam``: the wiggly curve of ``tests/test_gam_bases.py`` at lambda 0
  per basis: the condition number of the penalized Gram and each
  package's max |beta - beta_float64|;
- ``rulefit``: ``tests/test_rules_selection.py``'s separable data and
  the same with 15 % of labels flipped: the GLM's iterations and the
  largest |coefficient| and |difference| between the packages;
- ``glrm``: ``tests/test_torch_glrm.py``'s cases: each package's
  iterations and accepted steps, the largest relative gap over the
  first 20 accepted objectives, and the final objective's and numerr's
  relative gaps;
- ``word2vec``: ``tests/test_torch_word2vec.py``'s topic corpus: the
  largest |Win| gap over the largest |Win| after the second step (the
  first moves Wout alone) and after all 8 epochs, and each package's
  three synonyms of "cat";
- ``coxph``: ``tests/test_torch_coxph.py``'s cases: iterations, the
  largest coefficient gap beside the region the float32 likelihood
  cannot resolve (``unresolved``), the log-likelihood's relative gap
  and both concordances;
- ``psvm``: ``tests/test_torch_psvm.py``'s cases: the reference's
  subgradient loop (``h2o_tpu/models/psvm.py`` ``_svm_fit``'s body, run
  a step at a time on the reference's Z) beside the port's on its own Z:
  the first step whose hinge mask ``margin < 1`` differs, the rows that
  differ there and their margins, and beta's drift over its largest
  |value| at that step and at the end.
"""

import json
import os
import sys

os.environ.setdefault("XLA_FLAGS",
                      "--xla_force_host_platform_device_count=8")
os.environ.setdefault("H2O_TPU_ROW_ALIGN", "8")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from h2o_tpu.core.cloud import Cloud  # noqa: E402
from h2o_tpu.core.frame import Frame as JFrame, T_CAT as J_CAT  # noqa: E402
from h2o_tpu.core.frame import Vec as JVec  # noqa: E402

from h2o_tpu_torch.core.frame import T_CAT, Frame, Vec  # noqa: E402


def _pair(X, y, dom=None):
    names = [f"x{j}" for j in range(X.shape[1])] + ["y"]
    jv = [JVec(X[:, j]) for j in range(X.shape[1])]
    pv = [Vec(X[:, j]) for j in range(X.shape[1])]
    jv.append(JVec(y, J_CAT, domain=dom) if dom else JVec(y))
    pv.append(Vec(y, T_CAT, domain=dom) if dom else Vec(y))
    return JFrame(names, jv), Frame(names, pv)


def probe_dl():
    from h2o_tpu.models.deeplearning import DeepLearning as JDL
    from h2o_tpu_torch.models.deeplearning import DeepLearning
    n = 20480
    rng = np.random.default_rng(0)
    X = rng.normal(size=(n, 28)).astype(np.float32)
    logit = (1.2 * X[:, 0] - 0.8 * X[:, 1] + X[:, 2] * X[:, 3]
             + 0.5 * np.sin(3 * X[:, 4]))
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-logit))).astype(np.int32)
    jf, pf = _pair(X, y, ["b", "s"])
    for hidden, steps in (([200, 200], 20), ([200, 200], 50),
                          ([200, 200], 100), ([200, 200], 200),
                          ([16, 16], 200)):
        kw = dict(seed=1, epochs=steps * 1024 / n, hidden=hidden)
        jm = JDL(**kw).train(y="y", training_frame=jf)
        pm = DeepLearning(device="cpu", **kw).train(y="y", training_frame=pf)
        pm2 = DeepLearning(device="cpu", **kw).train(y="y",
                                                    training_frame=pf)
        pp = pm.predict_raw(pf).numpy()[:, 1:]
        print(json.dumps(dict(
            probe="dl", hidden=hidden, steps=steps,
            reference_vs_port=float(np.abs(
                np.asarray(jm.predict_raw(jf))[:n, 1:] - pp).max()),
            port_vs_port=float(np.abs(
                pm2.predict_raw(pf).numpy()[:, 1:] - pp).max()))),
            flush=True)


def probe_gam():
    import h2o_tpu.models.gam as jg
    import h2o_tpu_torch.models.gam as pg
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(-3, 3, size=1600)).astype(np.float32)
    y = (np.sin(2.0 * x) + 0.3 * x +
         rng.normal(scale=0.25, size=1600)).astype(np.float32)
    jf = JFrame(["x", "y"], [JVec(x), JVec(y)])
    pf = Frame(["x", "y"], [Vec(x), Vec(y)])
    for bs in (0, 1, 2, 3):
        kw = dict(gam_columns=["x"], num_knots=10, lambda_=0.0, seed=1,
                  bs=[bs])
        jm = jg.GAM(**kw).train(y="y", training_frame=jf)
        pm = pg.GAM(device="cpu", **kw).train(y="y", training_frame=pf)
        ef = pm.expand(pf)
        names = pm.output["glm_output"]["coef_names"]
        X1 = np.stack([ef.vec(c).data.astype(np.float64) for c in names] +
                      [np.ones(pf.nrows)], axis=1)
        G = X1.T @ X1 + pm.output["glm_params"]["_penalty"] + \
            1e-8 * np.eye(X1.shape[1])
        exact = np.linalg.solve(G, X1.T @ y.astype(np.float64))
        print(json.dumps(dict(
            probe="gam", bs=bs, gram_condition=float(np.linalg.cond(G)),
            port_err=float(np.abs(pm.output["glm_output"]["beta"] -
                                  exact).max()),
            reference_err=float(np.abs(np.asarray(
                jm.output["glm_output"]["beta"]) - exact).max()))),
            flush=True)


def probe_rulefit():
    import h2o_tpu.models.rulefit as jrf
    import h2o_tpu_torch.models.rulefit as prf
    rng = np.random.default_rng(42)
    n = 2500
    X = rng.normal(size=(n, 4)).astype(np.float32)
    y = ((X[:, 0] > 0.5) & (X[:, 1] < 0)).astype(np.int32)
    flip = np.random.default_rng(5).uniform(size=n) < 0.15
    kw = dict(min_rule_length=2, max_rule_length=3,
              rule_generation_ntrees=20, seed=2)
    for name, labels in (("separable", y), ("flipped_15pct", y ^ flip)):
        jf, pf = _pair(X, labels.astype(np.int32), ["0", "1"])
        jm = jrf.RuleFit(**kw).train(y="y", training_frame=jf)
        pm = prf.RuleFit(device="cpu", **kw).train(y="y", training_frame=pf)
        jc, pc = jm._inner().coef(), pm._inner().coef()
        print(json.dumps(dict(
            probe="rulefit", data=name,
            iterations=(jm.output["glm_output"]["iterations"],
                        pm.output["glm_output"]["iterations"]),
            max_abs_coef=float(max(abs(v) for v in jc.values())),
            max_coef_diff=float(max(abs(jc[k] - pc[k]) for k in jc)))),
            flush=True)


def probe_glrm():
    from h2o_tpu.models.glrm import GLRM as JGLRM
    from h2o_tpu_torch.models.glrm import GLRM
    from h2o_tpu_torch.ops import statpack
    from tests.test_torch_glrm import CASES, _pair as glrm_pair
    statpack.ROW_QUANTUM = 64           # the test mesh's padding
    for case, (make, kw, _) in CASES.items():
        A, cat = make()
        jf, pf = glrm_pair(A, cat)
        jo = JGLRM(**kw).train(training_frame=jf).output
        po = GLRM(device="cpu", **kw).train(training_frame=pf).output
        jh, ph = np.asarray(jo["history"]), np.asarray(po["history"])
        m = min(20, len(jh), len(ph))
        print(json.dumps(dict(
            probe="glrm", case=case,
            iterations=(jo["iterations"], po["iterations"]),
            accepted=(len(jh) - 1, len(ph) - 1),
            first20_max_rel=float(np.max(np.abs(ph[:m] - jh[:m]) /
                                         np.abs(jh[:m]))),
            objective_rel=abs(po["objective"] - jo["objective"]) /
            abs(jo["objective"]),
            numerr_rel=abs(po["numerr"] - jo["numerr"]) /
            abs(jo["numerr"]))), flush=True)


def probe_word2vec():
    import h2o_tpu.models.word2vec as jw2v
    import h2o_tpu_torch.models.word2vec as pw2v
    from tests.test_torch_word2vec import SYN, _pair as w2v_pair, _topics
    firsts = {}

    def first(module, name, jax_side):
        """Win after the second step (the first moves Wout alone)."""
        orig = getattr(module, name)

        def wrap(Win, Wout, *a):
            out = orig(Win, Wout, *a)
            seen = firsts.setdefault(name, [])
            if len(seen) < 2:
                seen.append(np.array(out[0] if jax_side else Win))
            return out
        setattr(module, name, wrap)

    first(jw2v, "_sgns_step", True)
    first(pw2v, "sgns_step", False)
    jf, pf = w2v_pair(_topics())
    jm = jw2v.Word2Vec(**SYN).train(training_frame=jf)
    pm = pw2v.Word2Vec(device="cpu", **SYN).train(training_frame=pf)
    jv, pv = np.asarray(jm.output["vectors"]), pm.output["vectors"]
    f_j, f_p = firsts["_sgns_step"][1], firsts["sgns_step"][1]
    print(json.dumps(dict(
        probe="word2vec", steps=8,
        second_step_drift=float(np.abs(f_p - f_j).max() / np.abs(f_j).max()),
        final_drift=float(np.abs(pv - jv).max() / np.abs(jv).max()),
        synonyms_reference=list(jm.find_synonyms("cat", 3)),
        synonyms_port=list(pm.find_synonyms("cat", 3)))), flush=True)


def probe_coxph():
    import h2o_tpu.models.coxph as jcox
    from h2o_tpu_torch.models.coxph import CoxPH
    from tests.test_torch_coxph import CASES
    for case, (make, kw) in CASES.items():
        jf, pf = make()
        x = [c for c in pf.names if c not in ("time", "start", "stop",
                                              "event", "w")]
        jo = jcox.CoxPH(**kw).train(x=x, y="event",
                                    training_frame=jf).output
        po = CoxPH(device="cpu", **kw).train(x=x, y="event",
                                             training_frame=pf).output
        print(json.dumps(dict(
            probe="coxph", case=case,
            iterations=(jo["iterations"], po["iterations"]),
            max_coef_diff=float(np.abs(po["coef"] -
                                       np.asarray(jo["coef"])).max()),
            unresolved=float(np.sqrt(
                8 * np.spacing(np.float32(abs(jo["loglik"]))) *
                np.sum(np.asarray(jo["se_coef"]) ** 2))),
            loglik_rel=abs(po["loglik"] - jo["loglik"]) / abs(jo["loglik"]),
            concordance=(jo["concordance"], po["concordance"]))),
            flush=True)


def probe_psvm():
    import warnings

    import jax.numpy as jnp

    from h2o_tpu.models.glm import expand_for_scoring as j_expand
    from h2o_tpu_torch.models import psvm as ppsvm
    from h2o_tpu_torch.ops import statpack
    from tests.test_torch_psvm import CASES, _data
    statpack.ROW_QUANTUM = 64
    warnings.simplefilter("ignore")
    for case in CASES:
        (jf, pf), kw = _data(case)
        masks, betas = [], []
        ppsvm.PSVM(device="cpu", **kw)._fit(
            [c for c in pf.names if c != "y"], "y", pf, None,
            step_hook=lambda t, beta, mask: (masks.append(mask.numpy()),
                                             betas.append(beta.numpy())))
        from h2o_tpu.models.psvm import PSVM as JPSVM
        jo = JPSVM(**kw).train(y="y", training_frame=jf).output
        # the reference's loop body, a step at a time, on its Z
        X = j_expand(jf, jo["expansion_spec"])
        W, b = jnp.asarray(jo["rff_w"]), jnp.asarray(jo["rff_b"])
        D = W.shape[1]
        Z = jnp.sqrt(2.0 / D) * jnp.cos(X @ W + b[None, :])
        yv = jnp.asarray(np.pad(pf.vec("y").as_float(),
                                (0, X.shape[0] - pf.nrows),
                                constant_values=np.nan))
        valid = ~jnp.isnan(yv)
        ysign = jnp.where(jnp.nan_to_num(yv) > 0, 1.0, -1.0)
        w = jnp.where(ysign > 0, float(kw.get("positive_weight", 1.0)),
                      float(kw.get("negative_weight", 1.0)))
        w = jnp.where(valid, w, 0.0)
        C = jnp.float32(kw.get("hyper_param", 1.0))
        beta = jnp.zeros((D + 1,), jnp.float32)
        Rn = Z.shape[0]
        first, drift = None, 0.0
        for t in range(int(kw["max_iterations"])):
            marg = ysign * (Z @ beta[:-1] + beta[-1])
            g_mask = jnp.where(valid & (marg < 1.0), w, 0.0)
            gw = beta[:-1] - C * (Z.T @ (g_mask * ysign))
            gb = -C * jnp.sum(g_mask * ysign)
            g = jnp.concatenate([gw, jnp.array([gb])])
            step = 0.5 / jnp.sqrt(t + 1.0)
            beta = beta - step * g / (1.0 + C * jnp.sum(w * valid) / Rn)
            jmask = np.asarray(valid & (marg < 1.0))[: pf.nrows]
            bj = np.asarray(beta)
            drift = float(np.abs(betas[t] - bj).max() / np.abs(bj).max())
            if first is None and not np.array_equal(jmask, masks[t]):
                rows = np.flatnonzero(jmask != masks[t])
                first = dict(step=t, rows=rows[:5].tolist(),
                             margins=np.asarray(marg)[rows[:5]].tolist(),
                             beta_drift_there=drift)
        print(json.dumps(dict(probe="psvm", case=case,
                              first_mask_difference=first,
                              final_beta_drift=drift)), flush=True)


if __name__ == "__main__":
    Cloud.boot()
    probes = {"dl": probe_dl, "gam": probe_gam, "rulefit": probe_rulefit,
              "glrm": probe_glrm, "word2vec": probe_word2vec,
              "coxph": probe_coxph, "psvm": probe_psvm}
    for name in sys.argv[1:] or list(probes):
        probes[name]()
