"""Pure-numpy MOJO scorers, one per algo — port of
``h2o_tpu/mojo/scorers.py``, copied: these scorers are host numpy in
both packages, so the port keeps its own copy instead of importing the
reference's.

Reference: h2o-genmodel/src/main/java/hex/genmodel/algos/{gbm,drf,glm,
kmeans,deeplearning,pca}/*.java — standalone score0 implementations that
walk the serialized model with no cluster.  Each scorer replays the
in-cluster scoring math in numpy so artifacts score on any host.

Input convention: X is (rows, C) float64 of raw column values in training
order — categoricals as domain codes, NAs as NaN.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

EPS = 1e-15


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def _softmax(x):
    e = np.exp(x - x.max(axis=1, keepdims=True))
    return e / e.sum(axis=1, keepdims=True)


def _link_inv(dist: str, f):
    if dist in ("bernoulli", "quasibinomial", "modified_huber"):
        return _sigmoid(f)
    if dist in ("poisson", "gamma", "tweedie"):
        return np.exp(f)
    return f


# -- trees ------------------------------------------------------------------

def _bin_matrix(X, split_points, is_cat, nbins: int) -> np.ndarray:
    """Raw values -> bin ids (shared_tree._bin_all in numpy)."""
    valid_t = ~np.isnan(split_points)                       # (C, B-1)
    num_bins = ((X[:, :, None] >= split_points[None, :, :]) &
                valid_t[None, :, :]).sum(axis=2)
    cat_bins = np.clip(np.nan_to_num(X), 0, nbins - 1).astype(np.int64)
    b = np.where(is_cat[None, :], cat_bins, num_bins).astype(np.int64)
    return np.where(np.isnan(X), nbins, b)


def _forest_score(bins, split_col, bitset, value, depth: int,
                  child=None, thr=None, na_l=None,
                  fine_na: int = -1) -> np.ndarray:
    """Sum of per-tree leaf values (shared_tree.forest_score in numpy).
    ``child`` None = dense heap (2n+1/2n+2), else left-child pointers;
    ``thr``/``na_l`` carry adaptive numeric fine-bin thresholds."""
    T, K, H = split_col.shape
    B = bitset.shape[-1] - 1
    R = bins.shape[0]
    out = np.zeros((R, K), np.float64)
    rows = np.arange(R)
    for t in range(T):
        for k in range(K):
            sc, bs, vl = split_col[t, k], bitset[t, k], value[t, k]
            ch = child[t, k] if child is not None else None
            th = thr[t, k] if thr is not None else None
            na = na_l[t, k] if na_l is not None else None
            node = np.zeros(R, np.int64)
            for _ in range(depth):
                c = sc[node]
                term = c < 0
                b = bins[rows, np.maximum(c, 0)]
                go_left = bs[node, np.minimum(b, B)]
                if th is not None:
                    tn = th[node]
                    g_thr = np.where(b == fine_na, na[node], b < tn)
                    go_left = np.where(tn >= 0, g_thr, go_left)
                if ch is None:
                    nxt = 2 * node + np.where(go_left, 1, 2)
                else:
                    left = ch[node]
                    term = term | (left < 0)
                    nxt = left + np.where(go_left, 0, 1)
                node = np.where(term, node, nxt)
            out[:, k] += vl[node]
    return out


def _tree_F(arrays: Dict, meta: Dict, X) -> np.ndarray:
    fine = int(meta.get("fine_nbins") or meta["nbins"])
    bins = _bin_matrix(X, arrays["split_points"],
                       arrays["is_cat"].astype(bool), fine)
    return _forest_score(bins, arrays["split_col"], arrays["bitset"],
                         arrays["value"], int(meta["max_depth"]),
                         child=arrays.get("child"),
                         thr=arrays.get("thr_bin"),
                         na_l=arrays.get("na_left"), fine_na=fine)


def _classify(F, dom):
    if dom is None:
        return F[:, 0]
    if len(dom) == 2:
        p1 = F[:, 0]
        return np.stack([(p1 >= 0.5).astype(np.float64), 1 - p1, p1],
                        axis=1)
    label = np.argmax(F, axis=1).astype(np.float64)
    return np.concatenate([label[:, None], F], axis=1)


def score_gbm(arrays, meta, X):
    F = _tree_F(arrays, meta, X) + arrays["f0"][None, :]
    dom = meta.get("response_domain")
    if dom is None:
        return _link_inv(meta["distribution_resolved"], F[:, 0])
    if len(dom) == 2:
        return _classify(_sigmoid(F), dom)
    return _classify(_softmax(F), dom)


def score_drf(arrays, meta, X):
    F = _tree_F(arrays, meta, X) / max(int(meta["ntrees_actual"]), 1)
    dom = meta.get("response_domain")
    if dom is None:
        return F[:, 0]
    if len(dom) == 2:
        p1 = np.clip(F[:, 0], 0.0, 1.0)
        return np.stack([(p1 >= 0.5).astype(np.float64), 1 - p1, p1],
                        axis=1)
    P = np.maximum(F, 0.0)
    P = P / np.maximum(P.sum(axis=1, keepdims=True), EPS)
    return _classify(P, dom)


# -- expanded-matrix models -------------------------------------------------

def _expand(meta: Dict, X) -> np.ndarray:
    """Apply the training expansion spec (one-hot + impute + standardize)
    to raw columns (glm.expand_for_scoring in numpy)."""
    spec = meta["expansion_spec"]
    cols = []
    # X columns arrive in MojoModel.columns order: meta["x"] when the model
    # recorded it, else spec order (cats first) — must match the encoder
    order = list(meta.get("x") or
                 (list(spec["cat_names"]) + list(spec["num_names"])))
    pos = {c: i for i, c in enumerate(order)}
    for c, card in zip(spec["cat_names"], spec["cat_cards"]):
        codes = X[:, pos[c]]
        lo = 0 if spec["use_all_factor_levels"] else 1
        for k in range(lo, card):
            cols.append((codes == k).astype(np.float64))
    for c, mean, sigma in zip(spec["num_names"], spec["means"],
                              spec["sigmas"]):
        d = np.nan_to_num(X[:, pos[c]], nan=float(mean))
        if spec["standardize"]:
            d = (d - mean) / (sigma or 1.0)
        cols.append(d)
    return np.stack(cols, axis=1) if cols else np.zeros((X.shape[0], 0))


def score_glm(arrays, meta, X):
    Xe = _expand(meta, X)
    dom = meta.get("response_domain")
    if meta.get("is_multinomial"):
        B = arrays["beta_multinomial"]                   # (K, P+1)
        eta = Xe @ B[:, :-1].T + B[:, -1][None, :]
        return _classify(_softmax(eta), dom)
    beta = arrays["beta"]
    eta = Xe @ beta[:-1] + beta[-1]
    fam = meta["family_resolved"]
    if meta.get("is_ordinal"):
        # cumulative logit: P(y<=k) = sigmoid(thr_k - eta)
        thr = arrays["ordinal_thresholds"]
        c = _sigmoid(thr[None, :] - eta[:, None])
        c = np.concatenate([np.zeros_like(c[:, :1]), c,
                            np.ones_like(c[:, :1])], axis=1)
        P = np.maximum(np.diff(c, axis=1), 0.0)
        P = P / np.maximum(P.sum(axis=1, keepdims=True), EPS)
        label = np.argmax(P, axis=1).astype(np.float64)
        return np.concatenate([label[:, None], P], axis=1)
    mu = _sigmoid(eta) if fam in ("binomial", "quasibinomial",
                                  "fractionalbinomial") else \
        (np.exp(eta) if fam in ("poisson", "gamma", "tweedie",
                                "negativebinomial") else eta)
    if dom is not None:
        return np.stack([(mu >= 0.5).astype(np.float64), 1 - mu, mu],
                        axis=1)
    return mu


def score_kmeans(arrays, meta, X):
    Xe = _expand(meta, X)
    centers = arrays["centers_std"]
    d2 = (Xe * Xe).sum(1, keepdims=True) - 2 * Xe @ centers.T + \
        (centers * centers).sum(1)[None, :]
    return np.argmin(d2, axis=1).astype(np.float64)


def score_deeplearning(arrays, meta, X):
    Xe = _expand(meta, X)
    n = int(meta["n_layers"])
    act = meta["activation"].lower()
    h = Xe
    for i in range(n):
        h = h @ arrays[f"W{i}"] + arrays[f"b{i}"]
        if i < n - 1:
            if "tanh" in act:
                h = np.tanh(h)
            else:                       # rectifier / maxout fallback
                h = np.maximum(h, 0.0)
    dom = meta.get("response_domain")
    if dom is None:
        return _link_inv(meta["distribution_resolved"], h[:, 0])
    P = _softmax(h)
    if len(dom) == 2:
        return np.stack([(P[:, 1] >= 0.5).astype(np.float64),
                         P[:, 0], P[:, 1]], axis=1)
    return _classify(P, dom)


def score_pca(arrays, meta, X):
    Xe = _expand(meta, X)
    return Xe @ arrays["eigenvectors"]


def score_svd(arrays, meta, X):
    """Project rows onto the right singular vectors (models/svd.py
    predict_raw: U*D scores = X_expanded @ V)."""
    Xe = _expand(meta, X)
    return Xe @ arrays["v"]


def score_psvm(arrays, meta, X):
    """PSVM decision function over the stored random-Fourier-feature map
    + Platt-scaled probabilities (models/psvm.py _phi/predict_raw)."""
    Xe = _expand(meta, X)
    W, b = arrays["rff_w"], arrays["rff_b"]
    D = W.shape[1]
    phi = np.sqrt(2.0 / D) * np.cos(Xe @ W + b[None, :])
    beta = arrays["beta"]
    fdec = phi @ beta[:-1] + beta[-1]
    p1 = _sigmoid(float(meta["platt_a"]) * fdec + float(meta["platt_b"]))
    label = (fdec >= 0).astype(np.float64)
    return np.stack([label, 1 - p1, p1], axis=1)


def score_naivebayes(arrays, meta, X):
    """Gaussian/categorical naive Bayes log-likelihood sum
    (models/naive_bayes.py predict_raw)."""
    cols = list(meta["x"])
    k = len(meta["response_domain"])
    floor_p = 1e-3
    ll = np.broadcast_to(np.log(arrays["apriori"] + EPS)[None, :],
                         (X.shape[0], k)).copy()
    for key, tab in arrays.items():
        if not key.startswith("pcond_cat__"):
            continue
        name = key[len("pcond_cat__"):]
        codes = X[:, cols.index(name)]
        t = np.maximum(tab, floor_p)                     # (k, card)
        safe = np.clip(np.nan_to_num(codes, nan=0.0), 0,
                       t.shape[1] - 1).astype(np.int64)
        contrib = np.log(t[:, safe]).T
        known = ~np.isnan(codes) & (codes >= 0) & (codes < t.shape[1])
        ll += np.where(known[:, None], contrib, 0.0)
    num_names = meta.get("num_names") or []
    if num_names:
        Xn = X[:, [cols.index(c) for c in num_names]]
        mu, sd = arrays["num_mean"], arrays["num_sd"]     # (k, C)
        z = (Xn[:, None, :] - mu[None, :, :]) / sd[None, :, :]
        pdf = np.exp(-0.5 * z * z) / (np.sqrt(2 * np.pi) * sd[None, :, :])
        pdf = np.maximum(pdf, floor_p)
        ll += np.sum(np.where(np.isnan(Xn)[:, None, :], 0.0,
                              np.log(pdf)), axis=2)
    P = _softmax(ll)
    label = np.argmax(P, axis=1).astype(np.float64)
    return np.concatenate([label[:, None], P], axis=1)


def score_xgboost(arrays, meta, X):
    """XGBoost models ARE this engine's GBM trees (models/tree/xgboost);
    booster='gblinear' delegates to GLM and scores as one."""
    if "split_col" not in arrays:
        return score_glm(arrays, meta, X)
    return score_gbm(arrays, meta, X)


def score_dt(arrays, meta, X):
    """Single decision tree = a one-tree DRF (models/tree/dt.py)."""
    return score_drf(arrays, meta, X)


# -- GAM: numpy twins of the spline bases (models/gam.py; the cluster-vs-
# artifact consistency tests pin these against the device versions) ------

def _np_ncs_basis(x, knots):
    K = len(knots)

    def d(k):
        num = np.maximum(x - knots[k], 0.0) ** 3 - \
            np.maximum(x - knots[K - 1], 0.0) ** 3
        return num / max(knots[K - 1] - knots[k], 1e-12)

    cols = [x]
    dK2 = d(K - 2)
    for k in range(K - 2):
        cols.append(d(k) - dK2)
    return cols


def _np_tp_basis(x, knots):
    scale = max(float(knots[-1] - knots[0]), 1e-6)
    return [x] + [np.abs(x - knots[k]) ** 3 / scale ** 3
                  for k in range(len(knots))]


def _np_bspline_cols(x, knots, degree=3):
    t = np.concatenate([[knots[0]] * degree, knots,
                        [knots[-1]] * degree]).astype(np.float64)
    n_basis = len(t) - degree - 1
    x = np.clip(x, t[0], t[-1])
    B = []
    for i in range(len(t) - 1):
        if t[i + 1] > t[i]:
            hi = (x <= t[i + 1]) if t[i + 1] >= t[-1] else (x < t[i + 1])
            B.append(((x >= t[i]) & hi).astype(np.float64))
        else:
            B.append(np.zeros_like(x))
    for dd in range(1, degree + 1):
        Bn = []
        for i in range(len(t) - dd - 1):
            den1 = t[i + dd] - t[i]
            den2 = t[i + dd + 1] - t[i + 1]
            term = np.zeros_like(x)
            if den1 > 0:
                term = term + (x - t[i]) / den1 * B[i]
            if den2 > 0:
                term = term + (t[i + dd + 1] - x) / den2 * B[i + 1]
            Bn.append(term)
        B = Bn
    return B[:n_basis]


def _np_is_basis(x, knots):
    B = _np_bspline_cols(x, knots, 3)
    cols, acc = [], np.zeros_like(x)
    for b in reversed(B[1:]):
        acc = acc + b
        cols.append(acc)
    return list(reversed(cols))


def _np_ms_basis(x, knots):
    return _np_bspline_cols(x, knots, 3)[1:]


_NP_BASES = {0: _np_ncs_basis, 1: _np_tp_basis, 2: _np_is_basis,
             3: _np_ms_basis}


def score_gam(arrays, meta, X):
    """Expand the gam columns with the stored knots/bases, then score
    through the inner GLM (models/gam.py GAMModel.predict_raw)."""
    from h2o_tpu_torch.mojo import sub_model
    cols = list(meta.get("input_columns") or meta["x"])
    gam_cols = list(meta["gam_columns"])
    bs_map = {k: int(v) for k, v in meta["bs_map"].items()}
    means = meta["gam_col_means"]
    plain = set(meta["x"])    # the skip-linear rule keys on the PLAIN
    #                           predictors (models/gam.py _expand_gam)
    glm_a, glm_m = sub_model(arrays, meta, "glm_output")
    feats = {c: np.nan_to_num(X[:, cols.index(c)],
                              nan=float(means[c])) for c in gam_cols}
    extra = {}
    for c in gam_cols:
        basis = _NP_BASES[bs_map[c]]
        linear_first = bs_map[c] in (0, 1)
        for i, bcol in enumerate(basis(feats[c], arrays[f"knots__{c}"])):
            if linear_first and i == 0 and c in plain:
                continue
            extra[f"{c}_gam_{i}"] = bcol
    # inner GLM scores its own expansion spec's column order
    spec = glm_m["expansion_spec"]
    order = list(spec["cat_names"]) + list(spec["num_names"])
    Xg = np.full((X.shape[0], len(order)), np.nan, np.float64)
    for j, name in enumerate(order):
        if name in extra:
            Xg[:, j] = extra[name]
        elif name in cols:
            Xg[:, j] = X[:, cols.index(name)]
    glm_m = dict(glm_m)
    # Xg is stacked in SPEC order (cats first) — _expand must index it
    # that way, not by the inner model's original x order
    glm_m["x"] = order
    return score_glm(glm_a, glm_m, Xg)


def score_rulefit(arrays, meta, X):
    """Terminal-node rule features from the stored (dense-heap) trees,
    then the inner sparse GLM (models/rulefit.py)."""
    from h2o_tpu_torch.mojo import sub_model
    cols = list(meta["x"])
    R = X.shape[0]
    bins = _bin_matrix(X[:, [cols.index(c) for c in meta["x"]]],
                       arrays["split_points"],
                       arrays["is_cat"].astype(bool), int(meta["nbins"]))
    n_forests = int(meta["forests__len"])
    feats = {}
    rows = np.arange(R)
    for fi in range(n_forests):
        sc_f = arrays[f"forests__{fi}__split_col"]        # (T, H)
        bs_f = arrays[f"forests__{fi}__bitset"]
        depth = int(meta[f"forests__{fi}__depth"])
        nodes_cache = {}
        for t, h in meta[f"forests__{fi}__rule_nodes"]:
            if t not in nodes_cache:
                sc, bsx = sc_f[t], bs_f[t]
                node = np.zeros(R, np.int64)
                for _ in range(depth):
                    c = sc[node]
                    term = c < 0
                    b = bins[rows, np.maximum(c, 0)]
                    go_left = bsx[node, b]
                    nxt = 2 * node + np.where(go_left, 1, 2)
                    node = np.where(term, node, nxt)
                nodes_cache[t] = node
            feats[f"rule.d{depth}.t{t}.n{h}"] = \
                (nodes_cache[t] == h).astype(np.float64)
    for c in meta.get("linear_names") or []:
        feats[f"linear.{c}"] = np.nan_to_num(X[:, cols.index(c)])
    glm_a, glm_m = sub_model(arrays, meta, "glm_output")
    spec = glm_m["expansion_spec"]
    order = list(spec["cat_names"]) + list(spec["num_names"])
    Xg = np.stack([feats[n] for n in order], axis=1) if order else \
        np.zeros((R, 0))
    glm_m = dict(glm_m)
    glm_m["x"] = order                  # Xg is in spec order (see score_gam)
    return score_glm(glm_a, glm_m, Xg)
