"""POJO (plain-old-Java-object) scoring source generation; port of
``h2o_tpu/mojo/pojo.py`` (``tree_pojo`` :88, ``glm_pojo`` :192,
``kmeans_pojo`` :314, ``deeplearning_pojo`` :350, ``pojo_source`` :434).

Reference: the h2o-3 POJO codegen emits a standalone Java class per model
(`hex/tree/TreeJCodeGen.java`, `hex/glm/GLMModel.toJavaPredictBody`,
`water/util/JCodeGen.java`); clients fetch it via GET /3/Models.java/{id}
(`water/api/ModelsHandler.java` fetchJavaCode; h2o-py h2o.download_pojo,
h2o.py:1868).

The package stores trees as node arrays (split_col / bitset / value
per node, models/tree/engine.py) rather than CompressedTree bytecode,
so the generator walks them directly: node n's children are 2n+1 / 2n+2
(dense heap) or child[n] / child[n]+1 (sparse-frontier pool),
split_col[n] < 0 is a leaf, bitset[n, b] routes bin b LEFT with bit B the
NA bucket, and numeric prefix-bitsets lower to float thresholds exactly
like the MOJO encoder (mojo/genmodel.py _TreeEncoder._split_parts).
The class is named by ``model.model_id`` (the reference's key); output
values held as tensors become numpy first.
"""

from __future__ import annotations

from typing import List

import numpy as np

from h2o_tpu_torch.mojo import host_view


def _j(name: str) -> str:
    """Java-identifier-safe name."""
    return "".join(ch if ch.isalnum() or ch == "_" else "_" for ch in name)


def _tree_node_java(sc, bs, vl, sp, is_cat, cards, n: int, depth: int,
                    lines: List[str], ch=None, thr=None, na_l=None) -> None:
    ind = "    " * (depth + 2)
    H = len(sc)
    if n < 0 or n >= H or sc[n] < 0 or \
            (ch is not None and ch[n] < 0):
        v = float(vl[n]) if 0 <= n < H else 0.0
        lines.append(f"{ind}pred = {v!r}f;")
        return
    c = int(sc[n])
    b = bs[n]
    B = len(b) - 1
    if thr is not None and thr[n] >= 0:
        # adaptive numeric split: fine-bin threshold -> grid value
        # (mojo/genmodel.py _TreeEncoder adaptive branch); falls through
        # to the shared child-emission tail
        tb = int(thr[n])
        na_left = bool(na_l[n])
        spc = np.asarray(sp[c], np.float64)
        k = min(max(tb - 1, 0), len(spc) - 1)
        t_val = float(spc[k]) if not np.isnan(spc[k]) else 0.0
        cond = f"data[{c}] < {t_val!r}"
        if na_left:
            cond = f"Double.isNaN(data[{c}]) || ({cond})"
        else:
            cond = f"!Double.isNaN(data[{c}]) && ({cond})"
    elif is_cat[c]:
        na_left = bool(b[B])
        card = max(int(cards[c]), 1)
        leftset = [bool(x) for x in b[:card]]
        arr = ", ".join("true" if x else "false" for x in leftset)
        cond = (f"!Double.isNaN(data[{c}]) && (int) data[{c}] < {card} && "
                f"new boolean[]{{{arr}}}[(int) data[{c}]]")
        if na_left:
            cond = f"Double.isNaN(data[{c}]) || ({cond})"
    else:
        na_left = bool(b[B])
        nleft = int(np.sum(b[:B]))
        spc = np.asarray(sp[c], np.float64)
        finite = np.flatnonzero(~np.isnan(spc))
        k = min(max(nleft - 1, 0), (finite[-1] if len(finite) else 0))
        t_val = float(spc[k]) if len(finite) else 0.0
        cond = f"data[{c}] < {t_val!r}"
        if na_left:
            cond = f"Double.isNaN(data[{c}]) || ({cond})"
        else:
            cond = f"!Double.isNaN(data[{c}]) && ({cond})"
    left = 2 * n + 1 if ch is None else int(ch[n])
    right = 2 * n + 2 if ch is None else int(ch[n]) + 1
    lines.append(f"{ind}if ({cond}) {{")
    _tree_node_java(sc, bs, vl, sp, is_cat, cards, left, depth + 1,
                    lines, ch, thr, na_l)
    lines.append(f"{ind}}} else {{")
    _tree_node_java(sc, bs, vl, sp, is_cat, cards, right, depth + 1,
                    lines, ch, thr, na_l)
    lines.append(f"{ind}}}")


def tree_pojo(model) -> str:
    """GBM/DRF model -> standalone Java scoring class source.

    XGBoost/DT models ARE this engine's GBM/DRF trees, so they lower in
    those scoring semantics — the same mapping write_tree_mojo applies."""
    model = host_view(model)
    out = model.output
    algo = {"xgboost": "gbm", "dt": "drf"}.get(model.algo, model.algo)
    x = list(out["x"])
    dom_map = out.get("domains") or {}
    resp_dom = out.get("response_domain")
    nclass = len(resp_dom) if resp_dom else 1
    sc = np.asarray(out["split_col"])
    bs = np.asarray(out["bitset"])
    vl = np.asarray(out["value"])
    ch = np.asarray(out["child"]) if out.get("child") is not None else None
    th = np.asarray(out["thr_bin"]) if out.get("thr_bin") is not None \
        else None
    na = np.asarray(out["na_left"]) if out.get("thr_bin") is not None \
        else None
    sp = np.asarray(out["split_points"])
    is_cat = np.asarray(out["is_cat"], bool)
    cards = [len(dom_map.get(c, [])) for c in x]
    f0 = np.asarray(out.get("f0", [0.0]), np.float64)
    T, K, _H = sc.shape
    dist = out.get("distribution_resolved", "gaussian")
    cls = _j(model.model_id)

    lines = [
        "// Generated POJO scorer - h2o-tpu "
        "(reference format: hex/tree/TreeJCodeGen.java)",
        f"// Model: {model.model_id}  algo={model.algo}  ntrees={T} "
        f"nclasses={nclass}",
        f"public class {cls} {{",
        "  public static final String[] NAMES = {%s};"
        % ", ".join('"%s"' % n for n in x),
    ]
    if resp_dom:
        doms = ", ".join(f'"{d}"' for d in resp_dom)
        lines.append(f"  public static final String[] DOMAIN = {{{doms}}};")
    for t in range(T):
        for k in range(K):
            lines.append(
                f"  static double tree_{t}_{k}(double[] data) {{")
            lines.append("    double pred;")
            _tree_node_java(sc[t, k], bs[t, k], vl[t, k], sp, is_cat,
                            cards, 0, 0, lines,
                            ch[t, k] if ch is not None else None,
                            th[t, k] if th is not None else None,
                            na[t, k] if na is not None else None)
            lines.append("    return pred;")
            lines.append("  }")
    lines.append("  public static double[] score0(double[] data) {")
    lines.append(f"    double[] f = new double[{K}];")
    if algo == "gbm" and dist != "multinomial":
        lines.append(f"    f[0] = {float(f0[0])!r};")
    elif algo == "gbm":
        for k in range(K):
            lines.append(f"    f[{k}] = {float(f0[k])!r};")
    for t in range(T):
        for k in range(K):
            lines.append(f"    f[{k}] += tree_{t}_{k}(data);")
    if algo == "drf":
        lines.append(f"    for (int k = 0; k < {K}; k++) "
                     f"f[k] /= {float(T)!r};")
    if nclass == 2 and K == 1:
        if algo == "gbm":
            lines.append("    double p1 = 1.0 / (1.0 + Math.exp(-f[0]));")
        else:
            lines.append("    double p1 = f[0];")
        lines.append("    return new double[]{p1 > 0.5 ? 1 : 0, "
                     "1.0 - p1, p1};")
    elif nclass > 2 and algo == "drf":
        # vote normalization, NOT softmax (raw_from_votes: clipped
        # per-class vote shares)
        lines.append(f"    double s = 0; double[] p = "
                     f"new double[{K} + 1];")
        lines.append(f"    for (int k = 0; k < {K}; k++) "
                     "{ p[k + 1] = Math.max(f[k], 0.0); s += p[k + 1]; }")
        lines.append("    if (s <= 0) s = 1;")
        lines.append(f"    int best = 0; for (int k = 0; k < {K}; k++) "
                     "{ p[k + 1] /= s; if (p[k + 1] > p[best + 1]) "
                     "best = k; }")
        lines.append("    p[0] = best; return p;")
    elif nclass > 2:
        lines.append("    double mx = f[0]; "
                     f"for (int k = 1; k < {K}; k++) "
                     "if (f[k] > mx) mx = f[k];")
        lines.append("    double s = 0; "
                     f"double[] p = new double[{K} + 1];")
        lines.append(f"    for (int k = 0; k < {K}; k++) "
                     "{ p[k + 1] = Math.exp(f[k] - mx); s += p[k + 1]; }")
        lines.append(f"    int best = 0; for (int k = 0; k < {K}; k++) "
                     "{ p[k + 1] /= s; if (p[k + 1] > p[best + 1]) "
                     "best = k; }")
        lines.append("    p[0] = best; return p;")
    else:
        inv = {"poisson": "Math.exp(f[0])", "gamma": "Math.exp(f[0])",
               "tweedie": "Math.exp(f[0])"}.get(dist, "f[0]")
        lines.append(f"    return new double[]{{{inv}}};")
    lines.append("  }")
    lines.append("}")
    return "\n".join(lines) + "\n"


def glm_pojo(model) -> str:
    """GLM model -> standalone Java scoring class source (raw-value
    scoring; standardized coefficients are de-standardized exactly as in
    mojo/genmodel.py write_glm_mojo)."""
    model = host_view(model)
    out = model.output
    if out.get("is_multinomial"):
        raise NotImplementedError("multinomial GLM POJO export")
    spec = out["expansion_spec"]
    cat_names = list(spec["cat_names"])
    num_names = list(spec["num_names"])
    cards = list(spec["cat_cards"])
    uafl = bool(spec["use_all_factor_levels"])
    beta = np.asarray(out["beta"], np.float64)
    n_cat_coef = sum(c - (0 if uafl else 1) for c in cards)
    cat_beta = beta[:n_cat_coef]
    num_beta = beta[n_cat_coef:-1].copy()
    intercept = float(beta[-1])
    means = np.asarray(spec["means"], np.float64)
    sigmas = np.asarray(spec["sigmas"], np.float64)
    if spec["standardize"] and len(num_beta):
        sig = np.where(sigmas == 0, 1.0, sigmas)
        intercept -= float(np.sum(num_beta * means / sig))
        num_beta = num_beta / sig
    fam = out.get("family_resolved", "gaussian")
    cls = _j(model.model_id)
    x = cat_names + num_names
    lines = [
        "// Generated POJO scorer - h2o-tpu "
        "(reference format: hex/glm/GLMModel.toJavaPredictBody)",
        f"public class {cls} {{",
        "  public static final String[] NAMES = {%s};"
        % ", ".join('"%s"' % n for n in x),
        "  public static double[] score0(double[] data) {",
        f"    double eta = {intercept!r};",
    ]
    off = 0
    for j, (name, card) in enumerate(zip(cat_names, cards)):
        ncoef = card - (0 if uafl else 1)
        coefs = ", ".join(repr(float(c)) for c in
                          cat_beta[off:off + ncoef])
        base = 0 if uafl else 1
        lines.append(f"    // categorical {name}")
        lines.append(f"    if (!Double.isNaN(data[{j}])) {{")
        lines.append(f"      int lvl = (int) data[{j}] - {base};")
        lines.append(f"      double[] cb = {{{coefs}}};")
        lines.append("      if (lvl >= 0 && lvl < cb.length) "
                     "eta += cb[lvl];")
        lines.append("    }")
        off += ncoef
    for j, name in enumerate(num_names):
        col = len(cat_names) + j
        b = float(num_beta[j]) if j < len(num_beta) else 0.0
        m = float(means[j]) if j < len(means) else 0.0
        lines.append(f"    eta += {b!r} * (Double.isNaN(data[{col}]) "
                     f"? {m!r} : data[{col}]);")
    if fam in ("binomial", "quasibinomial"):
        lines.append("    double p1 = 1.0 / (1.0 + Math.exp(-eta));")
        lines.append("    return new double[]{p1 > 0.5 ? 1 : 0, "
                     "1.0 - p1, p1};")
    elif fam in ("poisson", "gamma", "tweedie"):
        lines.append("    return new double[]{Math.exp(eta)};")
    else:
        lines.append("    return new double[]{eta};")
    lines.append("  }")
    lines.append("}")
    return "\n".join(lines) + "\n"


def _expand_java(spec, x, lines, ind="    ") -> int:
    """Emit Java that fills double[] e with the training expansion
    (one-hot + mean-impute + standardize) — mojo/scorers.py _expand in
    codegen form.  Returns the expanded width."""
    cat_names = list(spec["cat_names"])
    num_names = list(spec["num_names"])
    cards = list(spec["cat_cards"])
    uafl = bool(spec["use_all_factor_levels"])
    means = np.asarray(spec["means"], np.float64)
    sigmas = np.asarray(spec["sigmas"], np.float64)
    pos = {c: i for i, c in enumerate(x)}
    lo = 0 if uafl else 1
    P = sum(c - lo for c in cards) + len(num_names)
    lines.append(f"{ind}double[] e = new double[{P}];")
    off = 0
    for c, card in zip(cat_names, cards):
        j = pos[c]
        lines.append(
            f"{ind}if (!Double.isNaN(data[{j}]) && (int) data[{j}] >= "
            f"{lo} && (int) data[{j}] < {card}) "
            f"e[{off} + (int) data[{j}] - {lo}] = 1.0;")
        off += card - lo
    for k, c in enumerate(num_names):
        j = pos[c]
        m = float(means[k]) if k < len(means) else 0.0
        expr = f"(Double.isNaN(data[{j}]) ? {m!r} : data[{j}])"
        if spec["standardize"]:
            sg = float(sigmas[k]) if k < len(sigmas) and sigmas[k] != 0 \
                else 1.0
            expr = f"(({expr}) - {m!r}) / {sg!r}"
        lines.append(f"{ind}e[{off}] = {expr};")
        off += 1
    return P


def _matrix_java(name: str, M: np.ndarray, lines, rows_per_init=40):
    """Static double[][] with the initializer chunked into helper methods
    (a single <clinit> is capped at 64KB bytecode — JCodeGen.java uses
    the same trick for large constant pools)."""
    r, c = M.shape
    lines.append(f"  static final double[][] {name} = "
                 f"new double[{r}][{c}];")
    for blk in range(0, r, rows_per_init):
        hi = min(blk + rows_per_init, r)
        lines.append(f"  static void init_{name}_{blk}() {{")
        for i in range(blk, hi):
            row = ", ".join(repr(float(v)) for v in M[i])
            lines.append(f"    {name}[{i}] = new double[]{{{row}}};")
        lines.append("  }")
    calls = "".join(f" init_{name}_{blk}();"
                    for blk in range(0, r, rows_per_init))
    lines.append(f"  static {{{calls} }}")


def kmeans_pojo(model) -> str:
    """KMeans -> Java scorer: standardized squared-distance argmin
    (reference hex/kmeans KMeansModel toJava; numeric predictors only,
    the same restriction as the genmodel MOJO writer)."""
    model = host_view(model)
    out = model.output
    spec = out["expansion_spec"]
    if spec["cat_names"]:
        raise NotImplementedError(
            "KMeans POJO export supports numeric predictors only (one-"
            "hot cluster centers have no faithful POJO representation)")
    x = list(out.get("x") or spec["num_names"])
    centers = np.asarray(out["centers_std"], np.float64)
    cls = _j(model.model_id)
    lines = [
        "// Generated POJO scorer - h2o-tpu "
        "(reference format: hex/kmeans KMeansModel POJO)",
        f"public class {cls} {{",
        "  public static final String[] NAMES = {%s};"
        % ", ".join('"%s"' % n for n in x),
    ]
    _matrix_java("CENTERS", centers, lines)
    lines.append("  public static double[] score0(double[] data) {")
    P = _expand_java(spec, x, lines)
    lines.append(f"    int best = 0; double bd = Double.MAX_VALUE;")
    lines.append(f"    for (int k = 0; k < {centers.shape[0]}; k++) {{")
    lines.append("      double d2 = 0;")
    lines.append(f"      for (int j = 0; j < {P}; j++) "
                 "{ double d = e[j] - CENTERS[k][j]; d2 += d * d; }")
    lines.append("      if (d2 < bd) { bd = d2; best = k; }")
    lines.append("    }")
    lines.append("    return new double[]{best};")
    lines.append("  }")
    lines.append("}")
    return "\n".join(lines) + "\n"


def deeplearning_pojo(model) -> str:
    """DeepLearning MLP -> Java scorer: the expansion + dense forward
    pass (reference DeepLearningModel toJava — DeepwaterMojo-era
    codegen).  Rectifier/Tanh activations; softmax or distribution link
    on the output layer (mojo/scorers.py score_deeplearning semantics)."""
    model = host_view(model)
    out = model.output
    if out.get("autoencoder"):
        raise NotImplementedError("autoencoder POJO export (anomaly "
                                  "scoring is served by the cluster)")
    act = str(out.get("activation", "Rectifier")).lower()
    if "maxout" in act:
        raise NotImplementedError(
            "Maxout POJO export (the engine substitutes maxout~relu "
            "with a client-visible warning; POJOs carry only the "
            "faithful activations)")
    spec = out["expansion_spec"]
    cat_names = list(spec["cat_names"])
    num_names = list(spec["num_names"])
    x = list(out.get("x") or (cat_names + num_names))
    weights = out["weights"]
    resp_dom = out.get("response_domain")
    nclass = len(resp_dom) if resp_dom else 1
    dist = out.get("distribution_resolved", "gaussian")
    cls = _j(model.model_id)
    lines = [
        "// Generated POJO scorer - h2o-tpu "
        "(reference format: DeepLearningModel POJO codegen)",
        f"public class {cls} {{",
        "  public static final String[] NAMES = {%s};"
        % ", ".join('"%s"' % n for n in x),
    ]
    if resp_dom:
        doms = ", ".join(f'"{d}"' for d in resp_dom)
        lines.append(f"  public static final String[] DOMAIN = {{{doms}}};")
    for i, layer in enumerate(weights):
        _matrix_java(f"W{i}", np.asarray(layer["W"], np.float64), lines)
        bias = ", ".join(repr(float(v)) for v in np.asarray(layer["b"]))
        lines.append(f"  static final double[] B{i} = {{{bias}}};")
    lines.append("  static double[] dense(double[] h, double[][] W, "
                 "double[] b, boolean act) {")
    lines.append("    double[] o = new double[b.length];")
    lines.append("    for (int j = 0; j < b.length; j++) {")
    lines.append("      double s = b[j];")
    lines.append("      for (int i = 0; i < h.length; i++) "
                 "s += h[i] * W[i][j];")
    acj = "Math.tanh(s)" if "tanh" in act else "Math.max(s, 0.0)"
    lines.append(f"      o[j] = act ? {acj} : s;")
    lines.append("    }")
    lines.append("    return o;")
    lines.append("  }")
    lines.append("  public static double[] score0(double[] data) {")
    _expand_java(spec, x, lines)
    lines.append("    double[] h = e;")
    n_layers = len(weights)
    for i in range(n_layers):
        last = i == n_layers - 1
        lines.append(f"    h = dense(h, W{i}, B{i}, "
                     f"{'false' if last else 'true'});")
    if resp_dom is None:
        inv = {"poisson": "Math.exp(h[0])", "gamma": "Math.exp(h[0])",
               "tweedie": "Math.exp(h[0])"}.get(dist, "h[0]")
        lines.append(f"    return new double[]{{{inv}}};")
    else:
        K = nclass
        lines.append("    double mx = h[0]; "
                     f"for (int k = 1; k < {K}; k++) "
                     "if (h[k] > mx) mx = h[k];")
        lines.append(f"    double s = 0; double[] p = "
                     f"new double[{K} + 1];")
        lines.append(f"    for (int k = 0; k < {K}; k++) "
                     "{ p[k + 1] = Math.exp(h[k] - mx); s += p[k + 1]; }")
        lines.append(f"    for (int k = 0; k < {K}; k++) p[k + 1] /= s;")
        if nclass == 2:
            lines.append("    p[0] = p[2] >= 0.5 ? 1 : 0;")
        else:
            lines.append(f"    int best = 0; for (int k = 1; k < {K}; "
                         "k++) if (p[k + 1] > p[best + 1]) best = k;")
            lines.append("    p[0] = best;")
        lines.append("    return p;")
    lines.append("  }")
    lines.append("}")
    return "\n".join(lines) + "\n"


def pojo_source(model) -> str:
    model = host_view(model)
    if model.output.get("preprocessing_te_key"):
        raise NotImplementedError(
            "model was trained with AutoML target-encoding "
            "preprocessing; the POJO cannot carry the encoder step — "
            "score through the cluster, or retrain without "
            "preprocessing for a standalone artifact")
    if model.algo in ("gbm", "drf", "xgboost", "dt"):
        if model.output.get("split_col") is None:
            # booster='gblinear' XGBoost: GLM-shaped output
            return glm_pojo(model)
        return tree_pojo(model)
    if model.algo == "glm":
        return glm_pojo(model)
    if model.algo == "kmeans":
        return kmeans_pojo(model)
    if model.algo == "deeplearning":
        return deeplearning_pojo(model)
    raise NotImplementedError(
        f"POJO export not implemented for '{model.algo}' — the reference "
        "also gates POJO support per algo (Model.havePojo)")
