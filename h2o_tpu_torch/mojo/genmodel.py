"""genmodel-spec MOJO zips — the reference's interchange format; port of
``h2o_tpu/mojo/genmodel.py`` (``_TreeEncoder`` :65-203, ``_ZipWriter``
:210-252, ``_common_info`` :255-280, the writers behind
``write_genmodel_mojo`` :982-1020, ``read_genmodel_mojo`` :1190,
``score_decoded_tree`` :1132 and ``GenmodelMojoModel`` :1548).

Writer: produces the exact zip layout `hex.genmodel.ModelMojoReader` parses
(AbstractMojoWriter.java:182-275 — model.ini [info]/[columns]/[domains],
domains/dNNN.txt, per-algo sections), with tree bytecode in the
`SharedTreeMojoModel.scoreTree` v1.2+ format (DTree.java:891-935 compress,
ScoreTree2) for GBM/DRF and the GLM key set of GLMMojoWriter.java:22-42.

Reader: parses the same format (including MOJOs produced by a real H2O
cluster) back into flat node arrays scoreable by pure numpy — the
`h2o.import_mojo` / `upload_mojo` path (h2o-py/h2o/h2o.py:2292,2318).

Byte order is little-endian: H2O writes AutoBuffer in native order and
records `endianness` in model.ini (AbstractMojoWriter.java:192); x86/ARM
hosts and genmodel's ByteBufferWrapper (nativeOrder) agree.

The port names a model by ``model.model_id`` where the reference reads
its DKV key (the uuid is the md5 of that name, as there); output values
held as tensors become numpy at ``write_genmodel_mojo``'s boundary; a
StackedEnsemble is written from the metalearner and base models its
output holds, under their ``model_id``s, where the reference reads them
from its DKV.  Everything else is the reference's, byte for byte.
"""

from __future__ import annotations

import io
import struct
import time
import zipfile
from typing import Dict, List, Optional, Tuple

import numpy as np

from h2o_tpu_torch.mojo import host_view

# hex.genmodel.algos.tree.NaSplitDir values
NA_VS_REST, NA_LEFT, NA_RIGHT, DIR_LEFT, DIR_RIGHT = 1, 2, 3, 4, 5


def _escape_newlines(s: str) -> str:
    """genmodel StringEscapeUtils.escapeNewlines: backslash-escape so
    multi-line tokens survive line-oriented text files."""
    return s.replace("\\", "\\\\").replace("\n", "\\n").replace(
        "\r", "\\r")


def _unescape_newlines(s: str) -> str:
    out = []
    i = 0
    while i < len(s):
        c = s[i]
        if c == "\\" and i + 1 < len(s):
            nxt = s[i + 1]
            out.append({"n": "\n", "r": "\r",
                        "\\": "\\"}.get(nxt, "\\" + nxt))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


# ---------------------------------------------------------------------------
# tree bytecode writer (DTree.DecidedNode.compress, DTree.java:891-935)
# ---------------------------------------------------------------------------

def _bitset_bytes(rightset: np.ndarray) -> bytes:
    """Pack a boolean right-membership array LSB-first per byte
    (IcedBitSet layout: bit i -> byte[i>>3] bit (i&7))."""
    return np.packbits(rightset.astype(np.uint8), bitorder="little").tobytes()


class _TreeEncoder:
    """One (tree, class) node array -> genmodel bytecode + aux blob.

    Node layout: dense heap (jit_engine.build_tree_traced — node n has
    children 2n+1/2n+2, ``child`` None) or sparse-frontier pool
    (build_tree_frontier — ``child[n]`` is the left-child id, right =
    left+1).  split_col[n] < 0 marks a leaf holding value[n];
    bitset[n, b] = True routes bin b LEFT; bit B is the NA bucket.
    """

    child = None     # dense heap unless an instance carries pool pointers

    def __init__(self, split_col, bitset, value, split_points, is_cat,
                 cardinalities, leaf_offset: float = 0.0,
                 leaf_transform=None, child=None, thr=None, na_l=None):
        self.split_col = np.asarray(split_col)
        self.bitset = np.asarray(bitset)
        self.value = np.asarray(value, np.float32)
        self.child = np.asarray(child) if child is not None else None
        self.thr = np.asarray(thr) if thr is not None else None
        self.na_l = np.asarray(na_l) if na_l is not None else None
        self.split_points = split_points          # (C, B-1) float, NaN-pad
        self.is_cat = is_cat
        self.cards = cardinalities                # per-column cardinality
        self.H = len(self.split_col)
        self.leaf_offset = np.float32(leaf_offset)
        self.leaf_transform = leaf_transform
        self._size_cache: Dict[int, int] = {}

    def _left(self, n: int) -> int:
        return 2 * n + 1 if self.child is None else int(self.child[n])

    def _right(self, n: int) -> int:
        return 2 * n + 2 if self.child is None else int(self.child[n]) + 1

    def _is_leaf(self, n: int) -> bool:
        if n < 0 or n >= self.H or self.split_col[n] < 0:
            return True
        return self.child is not None and self.child[n] < 0

    def _leaf_val(self, n: int) -> float:
        v = np.float32(self.value[n]) + self.leaf_offset
        if self.leaf_transform is not None:
            v = np.float32(self.leaf_transform(v))
        return float(v)

    def _split_parts(self, n: int) -> Tuple[int, int, bytes]:
        """(equal, naSplitDir, payload bytes after the naSplitDir byte)."""
        c = int(self.split_col[n])
        bs = self.bitset[n]
        B = len(bs) - 1
        if self.thr is not None and self.thr[n] >= 0:
            # adaptive numeric split: fine-bin threshold -> the exact
            # boundary value of the stored fine grid (v < value = left)
            tb = int(self.thr[n])
            na_dir = NA_LEFT if self.na_l[n] else NA_RIGHT
            sp = self.split_points[c]
            k = min(max(tb - 1, 0), len(sp) - 1)
            thr = float(sp[k]) if not np.isnan(sp[k]) else 0.0
            return 0, na_dir, struct.pack("<f", np.float32(thr))
        na_dir = NA_LEFT if bs[B] else NA_RIGHT
        if self.is_cat[c]:
            card = max(int(self.cards[c]), 1)
            rightset = ~bs[:card]                 # our bitset = LEFT set
            if card <= 32:
                packed = np.zeros(32, bool)
                packed[:card] = rightset
                return 8, na_dir, _bitset_bytes(packed)   # compress2
            payload = struct.pack("<Hi", 0, card) + _bitset_bytes(rightset)
            return 12, na_dir, payload                     # compress3
        # numeric: prefix bitset in natural bin order -> float threshold
        nleft = int(bs[:B].sum())
        sp = self.split_points[c]
        finite = np.flatnonzero(~np.isnan(sp))
        k = min(max(nleft - 1, 0), (finite[-1] if len(finite) else 0))
        thr = float(sp[k]) if len(finite) else 0.0
        return 0, na_dir, struct.pack("<f", np.float32(thr))

    def _size(self, n: int) -> int:
        if self._is_leaf(n):
            return 4
        if n in self._size_cache:
            return self._size_cache[n]
        equal, _na, payload = self._split_parts(n)
        sz = 1 + 2 + 1 + len(payload)       # type + colId + naDir + payload
        lsz = self._size(self._left(n))
        sz += lsz
        if not self._is_leaf(self._left(n)):
            sz += 1 + (0 if lsz < 256 else
                       (1 if lsz < 65535 else (2 if lsz < (1 << 24) else 3)))
        sz += self._size(self._right(n))
        self._size_cache[n] = sz
        return sz

    def encode(self) -> Tuple[bytes, bytes]:
        ab = io.BytesIO()
        aux = io.BytesIO()
        if self._is_leaf(0):
            # root-is-leaf special form (DTree.compress:978)
            ab.write(struct.pack("<BH", 0, 65535))
            ab.write(struct.pack("<f", self._leaf_val(0)))
            return ab.getvalue(), aux.getvalue()
        self._encode_node(0, ab, aux)
        return ab.getvalue(), aux.getvalue()

    def _n_decided(self, n: int) -> int:
        if self._is_leaf(n):
            return 0
        return 1 + self._n_decided(self._left(n)) + \
            self._n_decided(self._right(n))

    def _encode_node(self, n: int, ab: io.BytesIO, aux: io.BytesIO):
        if self._is_leaf(n):
            ab.write(struct.pack("<f", self._leaf_val(n)))
            return
        equal, na_dir, payload = self._split_parts(n)
        left, right = self._left(n), self._right(n)
        lsz = self._size(left)
        node_type = equal
        if self._is_leaf(left):
            node_type |= 48
            slen = None
        else:
            slen = 0 if lsz < 256 else \
                (1 if lsz < 65535 else (2 if lsz < (1 << 24) else 3))
            node_type |= slen
        if self._is_leaf(right):
            node_type |= 48 << 2
        ab.write(struct.pack("<BHB", node_type, int(self.split_col[n]),
                             na_dir))
        ab.write(payload)
        # aux record (DTree.compress abAux block, 40 bytes/node)
        aux.write(struct.pack("<ii", n, self._n_decided(left)))
        aux.write(struct.pack("<ffffff", 0, 0, 0, 0, 0, 0))
        aux.write(struct.pack("<ii", left, right))
        if slen is not None:
            ab.write(lsz.to_bytes(slen + 1, "little"))
        self._encode_node(left, ab, aux)
        self._encode_node(right, ab, aux)


# ---------------------------------------------------------------------------
# zip writer
# ---------------------------------------------------------------------------

class _ZipWriter:
    def __init__(self):
        self.buf = io.BytesIO()
        self.z = zipfile.ZipFile(self.buf, "w", zipfile.ZIP_DEFLATED)
        self.kv: Dict[str, str] = {}

    def writekv(self, k, v):
        if isinstance(v, bool):
            v = "true" if v else "false"
        elif isinstance(v, (list, tuple, np.ndarray)):
            v = "[" + ", ".join(str(x) for x in v) + "]"
        self.kv[k] = str(v)

    def writeblob(self, name: str, blob: bytes):
        self.z.writestr(name, blob)

    def write_text(self, name: str, lines: List[str]):
        self.z.writestr(name, "".join(ln + "\n" for ln in lines))

    def finish(self, columns: List[str],
               domains: List[Optional[List[str]]]) -> bytes:
        ini = ["[info]"]
        for k, v in self.kv.items():
            ini.append(f"{k} = {v}")
        ini.append("")
        ini.append("[columns]")
        ini.extend(columns)
        ini.append("")
        ini.append("[domains]")
        di = 0
        for ci, dom in enumerate(domains):
            if dom is not None:
                ini.append(f"{ci}: {len(dom)} d{di:03d}.txt")
                di += 1
        self.write_text("model.ini", ini)
        di = 0
        for dom in domains:
            if dom is not None:
                self.write_text(f"domains/d{di:03d}.txt",
                                [str(s) for s in dom])
                di += 1
        self.z.close()
        return self.buf.getvalue()


def _common_info(w: _ZipWriter, algo: str, algo_full: str, category: str,
                 model_key: str, supervised: bool, n_features: int,
                 n_classes: int, n_columns: int, n_domains: int,
                 mojo_version: str):
    w.writekv("h2o_version", "3.46.0-tpu")
    w.writekv("mojo_version", mojo_version)
    w.writekv("license", "Apache License Version 2.0")
    w.writekv("algo", algo)
    w.writekv("algorithm", algo_full)
    w.writekv("endianness", "LITTLE_ENDIAN")
    w.writekv("category", category)
    # deterministic per model key (hash() varies with PYTHONHASHSEED)
    import hashlib
    w.writekv("uuid", str(int.from_bytes(
        hashlib.md5(model_key.encode()).digest()[:8], "big")))
    w.writekv("supervised", supervised)
    w.writekv("n_features", n_features)
    w.writekv("n_classes", n_classes)
    w.writekv("n_columns", n_columns)
    w.writekv("n_domains", n_domains)
    w.writekv("balance_classes", False)
    w.writekv("default_threshold", 0.5)
    w.writekv("prior_class_distrib", "null")
    w.writekv("model_class_distrib", "null")
    w.writekv("timestamp", int(time.time() * 1000))
    w.writekv("escape_domain_values", True)


_GBM_DIST = {"bernoulli": ("bernoulli", "logit"),
             "quasibinomial": ("quasibinomial", "logit"),
             "multinomial": ("multinomial", "identity"),
             "gaussian": ("gaussian", "identity"),
             "poisson": ("poisson", "log"),
             "gamma": ("gamma", "log"),
             "tweedie": ("tweedie", "log"),
             "laplace": ("laplace", "identity"),
             "quantile": ("quantile", "identity"),
             "huber": ("huber", "identity")}


def write_tree_mojo(model) -> bytes:
    """GBM/DRF model -> genmodel MOJO zip bytes.

    Custom-distribution models are refused: the artifact cannot embed
    the python UDF (the reference's MOJO has the same restriction).

    XGBoost/DT models are mathematically this engine's GBM/DRF trees
    (models/tree/{xgboost,dt}.py), so they export in those byte formats —
    a real genmodel jar scores them as gbm/drf (the reference's xgboost
    MOJO wraps a native booster blob that has no TPU analog)."""
    out = model.output
    if out.get("custom_link") is not None:
        raise NotImplementedError(
            "custom-distribution models cannot export a standalone MOJO")
    algo = {"xgboost": "gbm", "dt": "drf"}.get(model.algo, model.algo)
    x = list(out["x"])
    dom_map = out.get("domains") or {}
    resp_dom = out.get("response_domain")
    nclass = len(resp_dom) if resp_dom else 1
    sc = np.asarray(out["split_col"])          # (T, K, N)
    bs = np.asarray(out["bitset"])
    vl = np.asarray(out["value"])
    ch = np.asarray(out["child"]) if out.get("child") is not None else None
    th = np.asarray(out["thr_bin"]) if out.get("thr_bin") is not None \
        else None
    na = np.asarray(out["na_left"]) if out.get("thr_bin") is not None \
        else None
    T, K, H = sc.shape
    sp = np.asarray(out["split_points"])
    is_cat = np.asarray(out["is_cat"], bool)
    cards = [len(dom_map.get(c, [])) for c in x]
    f0 = np.asarray(out.get("f0", [0.0]), np.float32)

    resp_name = model.params.get("response_column") or "response"
    columns = x + ([resp_name] if resp_dom is not None or
                   model.params.get("response_column") else [])
    domains: List[Optional[List[str]]] = [
        (dom_map.get(c) if is_cat[j] else None) for j, c in enumerate(x)]
    if len(columns) > len(x):
        domains.append(list(resp_dom) if resp_dom else None)

    w = _ZipWriter()
    category = ("Binomial" if nclass == 2 else
                "Multinomial" if nclass > 2 else "Regression")
    _common_info(w, algo, "Gradient Boosting Machine" if algo == "gbm"
                 else "Distributed Random Forest", category,
                 model.model_id, True, len(x), nclass, len(columns),
                 sum(d is not None for d in domains), "1.30")
    w.writekv("n_trees", T)
    w.writekv("n_trees_per_class", K)
    w.writekv("default_threshold",
              float(out.get("default_threshold", 0.5)))
    dist = out.get("distribution_resolved", "gaussian")
    if algo == "gbm":
        fam, link = _GBM_DIST.get(dist, ("gaussian", "identity"))
        w.writekv("distribution", fam)
        w.writekv("link_function", link)
        # multinomial per-class priors are folded into class tree 0's
        # leaves below (genmodel has no per-class init_f)
        w.writekv("init_f", float(f0[0]) if dist != "multinomial" else 0.0)
    else:
        w.writekv("binomial_double_trees", False)

    for t in range(T):
        for k in range(K):
            offset = 0.0
            transform = None
            if algo == "gbm" and dist == "multinomial" and t == 0:
                offset = float(f0[k])
            if algo == "drf" and nclass == 2:
                # genmodel DRF binomial trees predict P(class0)
                # (DrfMojoModel.unifyPreds: preds[2] = 1 - preds[1])
                transform = lambda v: 1.0 - v  # noqa: E731
            enc = _TreeEncoder(sc[t, k], bs[t, k], vl[t, k], sp, is_cat,
                               cards, leaf_offset=offset,
                               leaf_transform=transform,
                               child=ch[t, k] if ch is not None else None,
                               thr=th[t, k] if th is not None else None,
                               na_l=na[t, k] if na is not None else None)
            blob, aux = enc.encode()
            w.writeblob(f"trees/t{k:02d}_{t:03d}.bin", blob)
            w.writeblob(f"trees/t{k:02d}_{t:03d}_aux.bin", aux)
    return w.finish(columns, domains)


def _glm_mojo_prep(model):
    """Shared GLM writer prep: spec unpacking, de-standardization of one
    beta vector, cat offsets, column/domain assembly, common kv."""
    out = model.output
    spec = out["expansion_spec"]
    cat_names = list(spec["cat_names"])
    num_names = list(spec["num_names"])
    cards = list(spec["cat_cards"])
    uafl = bool(spec["use_all_factor_levels"])
    means = np.asarray(spec["means"], np.float64)

    def destandardize(beta_row):
        """[cats..., nums..., b0] standardized -> raw-space flat list
        (the same affine inverse the coefficient table uses)."""
        from h2o_tpu_torch.models.glm import _destandardize as _glm_destd
        raw, _ = _glm_destd(spec, np.asarray(beta_row, np.float64))
        return [float(v) for v in raw]

    cat_offsets = [0]
    for c in cards:
        cat_offsets.append(cat_offsets[-1] + (c - (0 if uafl else 1)))
    resp_name = model.params.get("response_column") or "response"
    x = cat_names + num_names
    columns = x + [resp_name]
    cat_domains = list(spec.get("cat_domains") or [])
    domains = [(cat_domains[j] if j < len(cat_domains) else
                [str(i) for i in range(cards[j])])
               for j in range(len(cat_names))]
    domains += [None] * len(num_names)

    def common_kv(w):
        w.writekv("use_all_factor_levels", uafl)
        w.writekv("cats", len(cat_names))
        w.writekv("cat_offsets", cat_offsets)
        w.writekv("nums", len(num_names))
        w.writekv("mean_imputation", True)
        w.writekv("num_means", [float(m) for m in means])
        w.writekv("cat_modes", [0] * len(cat_names))

    return dict(out=out, spec=spec, x=x, columns=columns,
                domains=domains, destandardize=destandardize,
                common_kv=common_kv)


def write_glm_mojo(model) -> bytes:
    """GLM model -> genmodel MOJO zip bytes (GLMMojoWriter key set).

    genmodel scores raw values, so standardized coefficients are
    de-standardized here (beta/sigma; intercept -= sum beta*mean/sigma)."""
    out = model.output
    if out.get("is_multinomial"):
        return _write_glm_multinomial_mojo(model)
    if out.get("is_ordinal"):
        # genmodel's ordinal byte format (GlmOrdinalMojoModel) is not
        # implemented; the npz MOJO (mojo/__init__.py) covers ordinal
        raise NotImplementedError(
            "genmodel-spec MOJO export for family='ordinal' is not "
            "implemented; use the npz MOJO (export_mojo) instead")
    p = _glm_mojo_prep(model)
    fam = out.get("family_resolved", "gaussian")
    link = {"binomial": "logit", "quasibinomial": "logit",
            "fractionalbinomial": "logit",
            "gaussian": "identity", "poisson": "log", "gamma": "log",
            "negativebinomial": "log",
            "tweedie": "tweedie"}.get(fam, "identity")
    resp_dom = out.get("response_domain")
    nclass = len(resp_dom) if resp_dom else 1
    domains = list(p["domains"]) + [list(resp_dom) if resp_dom else None]
    w = _ZipWriter()
    _common_info(w, "glm", "Generalized Linear Modeling",
                 "Binomial" if nclass == 2 else "Regression",
                 model.model_id, True, len(p["x"]), nclass,
                 len(p["columns"]), sum(d is not None for d in domains),
                 "1.00")
    p["common_kv"](w)
    w.writekv("default_threshold",
              float(out.get("default_threshold", 0.5)))
    w.writekv("beta", p["destandardize"](out["beta"]))
    w.writekv("family", fam)
    w.writekv("link", link)
    if fam == "tweedie":
        w.writekv("tweedie_link_power",
                  float(model.params.get("tweedie_power", 1.5)))
    return w.finish(p["columns"], domains)


class _IFTreeEncoder(_TreeEncoder):
    """Isolation-forest heap (split_col + raw thresholds, no bins) ->
    genmodel bytecode.  Leaf value = leaf depth (the PathTracker
    contribution); NA routes right (our `x < th` comparison is False for
    NaN), numeric splits only."""

    def __init__(self, split_col, thresh):
        self.split_col = np.asarray(split_col)
        self.thresh = np.asarray(thresh, np.float32)
        self.H = len(self.split_col)
        # value[n] = depth of node n in the heap (leaf contribution)
        depths = np.floor(np.log2(np.arange(self.H) + 1)).astype(
            np.float32)
        self.value = depths
        self.leaf_offset = np.float32(0.0)
        self.leaf_transform = None
        self._size_cache: Dict[int, int] = {}

    def _split_parts(self, n: int):
        return 0, NA_RIGHT, struct.pack(
            "<f", np.float32(self.thresh[n]))


def write_isofor_mojo(model) -> bytes:
    """IsolationForest -> genmodel MOJO (IsolationForestMojoWriter key
    set: n_trees + min/max path length; trees score total path length)."""
    out = model.output
    x = list(out["x"])
    dom_map = out.get("domains") or {}
    sc = np.asarray(out["split_col"])          # (T, H)
    th = np.asarray(out["thresh"])
    T = sc.shape[0]
    domains: List[Optional[List[str]]] = [
        (dom_map.get(c) if c in dom_map else None) for c in x]
    w = _ZipWriter()
    _common_info(w, "isolationforest", "Isolation Forest",
                 "AnomalyDetection", model.model_id, False, len(x), 1,
                 len(x), sum(d is not None for d in domains), "1.40")
    w.writekv("n_trees", T)
    w.writekv("n_trees_per_class", 1)
    w.writekv("min_path_length", int(out["min_path_length"]))
    w.writekv("max_path_length", int(out["max_path_length"]))
    w.writekv("sample_size", int(out.get("sample_size", 0)))
    for t in range(T):
        enc = _IFTreeEncoder(sc[t], th[t])
        blob, aux = enc.encode()
        w.writeblob(f"trees/t00_{t:03d}.bin", blob)
        w.writeblob(f"trees/t00_{t:03d}_aux.bin", aux)
    return w.finish(x, domains)


def _write_glm_multinomial_mojo(model) -> bytes:
    """Multinomial GLM -> genmodel MOJO (GlmMultinomialMojoModel layout:
    flat beta of length K*P, per class c the block [coefs..., intercept]
    at offset c*P — GlmMultinomialMojoModel.java:38-52)."""
    out = model.output
    p = _glm_mojo_prep(model)
    B = np.asarray(out["beta_multinomial"], np.float64)   # (K, P+1)
    K = B.shape[0]
    flat = []
    for c in range(K):
        flat.extend(p["destandardize"](B[c]))
    resp_dom = out.get("response_domain") or [str(i) for i in range(K)]
    domains = list(p["domains"]) + [list(resp_dom)]
    w = _ZipWriter()
    _common_info(w, "glm", "Generalized Linear Modeling", "Multinomial",
                 model.model_id, True, len(p["x"]), K, len(p["columns"]),
                 sum(d is not None for d in domains), "1.00")
    p["common_kv"](w)
    w.writekv("beta", flat)
    w.writekv("family", "multinomial")
    w.writekv("link", "multinomial")
    return w.finish(p["columns"], domains)


def write_kmeans_mojo(model) -> bytes:
    """KMeans -> genmodel MOJO (KMeansMojoWriter key set: standardize +
    standardize_means/mults + center_num/center_i).

    The genmodel layout keeps centers in ORIGINAL column space with
    per-column standardization; categorical clustering centers have no
    faithful representation there for our one-hot training path, so
    export is numeric-columns-only (fail loudly otherwise)."""
    out = model.output
    spec = out["expansion_spec"]
    if spec["cat_names"]:
        raise NotImplementedError(
            "KMeans MOJO export supports numeric predictors only (the "
            "genmodel layout cannot carry one-hot cluster centers)")
    num_names = list(spec["num_names"])
    centers_std = np.asarray(out["centers_std"], np.float64)
    means = np.asarray(spec["means"], np.float64)
    sigmas = np.where(np.asarray(spec["sigmas"], np.float64) == 0, 1.0,
                      np.asarray(spec["sigmas"], np.float64))
    standardize = bool(spec["standardize"])
    w = _ZipWriter()
    _common_info(w, "kmeans", "K-means", "Clustering", model.model_id,
                 False, len(num_names), 1, len(num_names), 0, "1.00")
    w.writekv("standardize", standardize)
    if standardize:
        w.writekv("standardize_means", [float(m) for m in means])
        w.writekv("standardize_mults", [float(1.0 / s) for s in sigmas])
        w.writekv("standardize_modes", [0] * 0)
    w.writekv("center_num", centers_std.shape[0])
    for i in range(centers_std.shape[0]):
        w.writekv(f"center_{i}", [float(v) for v in centers_std[i]])
    return w.finish(num_names, [None] * len(num_names))


def write_deeplearning_mojo(model) -> bytes:
    """DeepLearning MLP -> genmodel MOJO (DeepLearningMojoWriter key set:
    nums/cats/cat_offsets/norm_mul/norm_sub, neural_network_sizes,
    weight_layer{i}/bias_layer{i} row-major, activation).

    Weights are stored transposed relative to our (in, out) layout —
    genmodel's DenseRowMatrix is (units[i+1] x units[i]) row-major."""
    out = model.output
    if out.get("autoencoder"):
        raise NotImplementedError("autoencoder MOJO export (the anomaly "
                                  "scorer is served by the binary model)")
    spec = out["expansion_spec"]
    cat_names = list(spec["cat_names"])
    num_names = list(spec["num_names"])
    cards = list(spec["cat_cards"])
    uafl = bool(spec["use_all_factor_levels"])
    means = np.asarray(spec["means"], np.float64)
    sigmas = np.where(np.asarray(spec["sigmas"], np.float64) == 0, 1.0,
                      np.asarray(spec["sigmas"], np.float64))
    weights = out["weights"]
    units = [int(weights[0]["W"].shape[0])] + \
        [int(l["W"].shape[1]) for l in weights]
    resp_dom = out.get("response_domain")
    nclass = len(resp_dom) if resp_dom else 1
    cat_offsets = [0]
    for c in cards:
        cat_offsets.append(cat_offsets[-1] + (c - (0 if uafl else 1)))
    resp_name = model.params.get("response_column") or "response"
    x = cat_names + num_names
    columns = x + [resp_name]
    cat_domains = list(spec.get("cat_domains") or [])
    domains: List[Optional[List[str]]] = \
        [(cat_domains[j] if j < len(cat_domains) else
          [str(i) for i in range(cards[j])]) for j in range(len(cat_names))]
    domains += [None] * len(num_names)
    domains.append(list(resp_dom) if resp_dom else None)

    w = _ZipWriter()
    _common_info(w, "deeplearning", "Deep Learning",
                 "Binomial" if nclass == 2 else
                 ("Multinomial" if nclass > 2 else "Regression"),
                 model.model_id, True, len(x), nclass, len(columns),
                 sum(d is not None for d in domains), "1.10")
    w.writekv("default_threshold",
              float(out.get("default_threshold", 0.5)))
    w.writekv("mini_batch_size", 1)
    w.writekv("nums", len(num_names))
    w.writekv("cats", len(cat_names))
    w.writekv("cat_offsets", cat_offsets)
    if spec["standardize"] and num_names:
        w.writekv("norm_mul", [float(1.0 / s) for s in sigmas])
        w.writekv("norm_sub", [float(m) for m in means])
    w.writekv("use_all_factor_levels", uafl)
    w.writekv("activation", out.get("activation", "Rectifier"))
    w.writekv("distribution", out.get("distribution_resolved", "AUTO"))
    w.writekv("mean_imputation", True)
    w.writekv("cat_modes", [0] * len(cat_names))
    w.writekv("neural_network_sizes", units)
    for i, layer in enumerate(weights):
        W = np.asarray(layer["W"], np.float64)          # (in, out)
        b = np.asarray(layer["b"], np.float64)
        w.writekv(f"weight_layer{i}",
                  [float(v) for v in W.T.reshape(-1)])  # row-major out×in
        w.writekv(f"bias_layer{i}", [float(v) for v in b])
    w.writekv("hidden_dropout_ratios",
              [0.0] * (len(units) - 2))
    return w.finish(columns, domains)


def write_word2vec_mojo(model) -> bytes:
    """Word2Vec -> genmodel MOJO (Word2VecMojoWriter: vec_size +
    vocab_size kv, 'vocabulary' text file, 'vectors' blob of
    BIG-endian float32s — ByteBuffer's default order, unlike the
    native-order tree buffers)."""
    out = model.output
    words = [str(w) for w in out["words"]]
    W = np.asarray(out["vectors"], np.float32)
    w = _ZipWriter()
    _common_info(w, "word2vec", "Word2Vec", "WordEmbedding",
                 model.model_id, False, 0, 1, 0, 0, "1.00")
    w.writekv("vec_size", int(W.shape[1]))
    w.writekv("vocab_size", len(words))
    w.write_text("vocabulary", [_escape_newlines(s) for s in words])
    w.writeblob("vectors", W.astype(">f4").tobytes())
    return w.finish([], [])


def write_isotonic_mojo(model) -> bytes:
    """IsotonicRegression -> genmodel MOJO (IsotonicCalibrator layout:
    min_x/max_x + thresholds_x/thresholds_y kv)."""
    out = model.output
    tx = np.asarray(out["thresholds_x"], np.float64)
    ty = np.asarray(out["thresholds_y"], np.float64)
    x = list(out["x"])
    resp = model.params.get("response_column") or "response"
    columns = x + [resp]
    w = _ZipWriter()
    _common_info(w, "isotonicregression", "Isotonic Regression",
                 "Regression", model.model_id, True, len(x), 1,
                 len(columns), 0, "1.00")
    w.writekv("min_x", float(tx[0]) if len(tx) else 0.0)
    w.writekv("max_x", float(tx[-1]) if len(tx) else 0.0)
    w.writekv("out_of_bounds", out.get("out_of_bounds", "clip"))
    w.writekv("thresholds_x", [float(v) for v in tx])
    w.writekv("thresholds_y", [float(v) for v in ty])
    return w.finish(columns, [None] * len(columns))


def write_pca_mojo(model) -> bytes:
    """PCA -> genmodel MOJO (PCAMojoWriter key set: k, norm sub/mul,
    catOffsets, eigenvectors_raw as BIG-endian doubles row-major)."""
    out = model.output
    spec = out["expansion_spec"]
    if spec["cat_names"]:
        # genmodel PCA keeps categorical levels + catOffsets; our one-hot
        # expansion matches only for the numeric case — fail loudly
        raise NotImplementedError(
            "PCA MOJO export supports numeric predictors only")
    num_names = list(spec["num_names"])
    V = np.asarray(out["eigenvectors"], np.float64)   # (P, k)
    means = np.asarray(spec["means"], np.float64)
    sigmas = np.where(np.asarray(spec["sigmas"], np.float64) == 0, 1.0,
                      np.asarray(spec["sigmas"], np.float64))
    w = _ZipWriter()
    _common_info(w, "pca", "Principal Components Analysis",
                 "DimReduction", model.model_id, False, len(num_names),
                 1, len(num_names), 0, "1.00")
    w.writekv("k", int(V.shape[1]))
    w.writekv("use_all_factor_levels", bool(spec["use_all_factor_levels"]))
    w.writekv("permutation", list(range(len(num_names))))
    w.writekv("ncats", 0)
    w.writekv("nnums", len(num_names))
    if spec["standardize"]:
        w.writekv("normSub", [float(m) for m in means])
        w.writekv("normMul", [float(1.0 / s) for s in sigmas])
    else:
        w.writekv("normSub", [0.0] * len(num_names))
        w.writekv("normMul", [1.0] * len(num_names))
    # training means for NaN imputation (expand_for_scoring contract)
    w.writekv("num_means", [float(m) for m in means])
    w.writekv("catOffsets", [0])
    w.writekv("eigenvector_size", int(V.shape[0]))
    w.writeblob("eigenvectors_raw", V.astype(">f8").tobytes())
    return w.finish(num_names, [None] * len(num_names))


def write_target_encoder_mojo(model) -> bytes:
    """TargetEncoder -> genmodel MOJO (TargetEncoderMojoWriter: blending
    kv + 'feature_engineering/target_encoding/encoding_map.ini' with
    [column] sections of 'level_index = num den' lines)."""
    out = model.output
    p = model.params
    w = _ZipWriter()
    cols = list(out["columns"])
    columns = cols + [p.get("response_column") or "response"]
    dom_map = out.get("domains") or {}
    domains: List[Optional[List[str]]] = [
        dom_map.get(c) for c in cols] + [None]
    _common_info(w, "targetencoder", "TargetEncoder", "TargetEncoder",
                 model.model_id, True, len(cols), 1, len(columns),
                 sum(d is not None for d in domains), "1.00")
    w.writekv("with_blending", bool(p.get("blending")))
    if p.get("blending"):
        w.writekv("inflection_point",
                  float(p.get("inflection_point", 10.0)))
        w.writekv("smoothing", float(p.get("smoothing", 20.0)))
    w.writekv("priorMean", float(out["prior"]))
    lines = []
    for col in cols:
        lines.append(f"[{col}]")
        cnt = np.asarray(out["enc"][col]["cnt"]).sum(axis=0)
        s = np.asarray(out["enc"][col]["sum"]).sum(axis=0)
        for lvl in range(len(cnt)):
            lines.append(f"{lvl} = {float(s[lvl])} {float(cnt[lvl])}")
    w.write_text(
        "feature_engineering/target_encoding/encoding_map.ini", lines)
    return w.finish(columns, domains)


def write_stackedensemble_mojo(model) -> bytes:
    """StackedEnsemble -> genmodel MOJO (MultiModelMojoReader layout:
    submodel_count/key_i/dir_i kv, each sub-model's complete mojo nested
    under models/<key>/; parent kv base_models_num + metalearner —
    StackedEnsembleMojoWriter.java:49-55).  The sub-models are the
    metalearner and base models the output holds, keyed by their
    ``model_id``s."""
    out = model.output
    meta = out["metalearner"]
    base = list(out["base_models"])
    base_keys = [b.model_id for b in base]
    subs = [(meta.model_id, meta)] + list(zip(base_keys, base))
    # parent columns: the UNION of base-model predictor columns (sub
    # scorers select their features from the parent column space, so
    # every base feature must exist there even if outside the SE's x)
    x: List[str] = []
    for _k, m in subs[1:]:
        for c in m.output.get("x", []):
            if c not in x:
                x.append(c)
    for c in out["x"]:
        if c not in x:
            x.append(c)
    resp = model.params.get("response_column") or "response"
    resp_dom = out.get("response_domain")
    columns = x + [resp]
    # domains for categorical parent columns, harvested from every
    # sub-model's view: tree-family models carry output['domains'],
    # GLM/DL carry them in expansion_spec.cat_domains
    dom_map = {}
    for _k, m in subs:
        dom_map.update(m.output.get("domains") or {})
        spec = m.output.get("expansion_spec")
        if spec:
            for cn, cd in zip(spec.get("cat_names") or [],
                              spec.get("cat_domains") or []):
                dom_map.setdefault(cn, list(cd))
    domains: List[Optional[List[str]]] = [dom_map.get(c) for c in x]
    domains.append(list(resp_dom) if resp_dom else None)
    w = _ZipWriter()
    nclass = len(resp_dom) if resp_dom else 1
    _common_info(w, "stackedensemble", "Stacked Ensemble",
                 "Binomial" if nclass == 2 else
                 ("Multinomial" if nclass > 2 else "Regression"),
                 model.model_id, True, len(x), nclass, len(columns),
                 sum(d is not None for d in domains), "1.01")
    w.writekv("submodel_count", len(subs))
    for i, (k, m) in enumerate(subs):
        w.writekv(f"submodel_key_{i}", k)
        w.writekv(f"submodel_dir_{i}", f"models/{k}/")
        # nest the sub-model's complete mojo under its directory
        sub_blob = write_genmodel_mojo(m)
        with zipfile.ZipFile(io.BytesIO(sub_blob)) as sz:
            for entry in sz.namelist():
                w.writeblob(f"models/{k}/{entry}", sz.read(entry))
    w.writekv("base_models_num", len(base_keys))
    w.writekv("metalearner", meta.model_id)
    w.writekv("metalearner_transform", "NONE")
    for i, bk in enumerate(base_keys):
        w.writekv(f"base_model{i}", bk)
    return w.finish(columns, domains)


def write_coxph_mojo(model) -> bytes:
    """CoxPH -> genmodel MOJO (CoxPHMojoWriter key set: coef +
    cat/num offsets + x_mean_cat/x_mean_num rectangular blobs of
    big-endian doubles with _size1/_size2 kv; no strata/interactions —
    this builder has neither)."""
    out = model.output
    spec = out["expansion_spec"]
    cat_names = list(spec["cat_names"])
    num_names = list(spec["num_names"])
    cards = list(spec["cat_cards"])
    uafl = bool(spec["use_all_factor_levels"])
    coef = np.asarray(out["coef"], np.float64)
    x_mean = np.asarray(out["x_mean"], np.float64)
    n_cat_coef = sum(c - (0 if uafl else 1) for c in cards)
    cat_offsets = [0]
    for c in cards:
        cat_offsets.append(cat_offsets[-1] + (c - (0 if uafl else 1)))
    num_offsets = [n_cat_coef + i for i in range(len(num_names))]
    x = cat_names + num_names
    resp = model.params.get("response_column") or "event"
    columns = x + [resp]
    cat_domains = list(spec.get("cat_domains") or [])
    domains: List[Optional[List[str]]] =         [(cat_domains[j] if j < len(cat_domains) else
          [str(i) for i in range(cards[j])]) for j in range(len(cat_names))]
    domains += [None] * (len(num_names) + 1)
    w = _ZipWriter()
    _common_info(w, "coxph", "Cox Proportional Hazards", "CoxPH",
                 model.model_id, True, len(x), 1, len(columns),
                 sum(d is not None for d in domains), "1.00")
    w.writekv("coef", [float(v) for v in coef])
    w.writekv("cats", len(cat_names))
    w.writekv("cat_offsets", cat_offsets)
    w.writekv("use_all_factor_levels", uafl)
    w.writekv("num_numerical_columns", len(num_names))
    w.writekv("num_offsets", num_offsets)
    w.writekv("strata_count", 0)
    # training rollup means for NA imputation (expand_for_scoring
    # contract; x_mean is the response-valid-row mean used for centering
    # and can differ when rows were dropped for invalid responses)
    w.writekv("num_means", [float(m) for m in spec["means"]])
    w.writekv("x_mean_cat_size1", 1)
    w.writekv("x_mean_cat_size2", n_cat_coef)
    w.writeblob("x_mean_cat",
                x_mean[:n_cat_coef].astype(">f8").tobytes())
    w.writekv("x_mean_num_size1", 1)
    w.writekv("x_mean_num_size2", len(num_names))
    w.writeblob("x_mean_num",
                x_mean[n_cat_coef:].astype(">f8").tobytes())
    return w.finish(columns, domains)


def write_glrm_mojo(model) -> bytes:
    """GLRM -> genmodel MOJO (GlrmMojoWriter key set: regularization /
    gamma / ncolX / norm sub-mul + archetypes blob).  Scoring is the
    fixed-Y X-fit (GlrmMojoModel's iterative solve); this writer also
    records the deterministic solve config (x_iters, loss, prox) and the
    expansion spec so the numpy scorer reproduces the cluster solve
    exactly (our solve starts from X0=0 — no RNG, unlike the
    reference's seeded random init)."""
    out = model.output
    spec = out["expansion_spec"]
    loss = str(out.get("loss", "Quadratic"))
    rx = str(out.get("regularization_x", "None"))
    if (loss.lower() not in ("quadratic", "absolute", "huber") or
            rx.lower() not in ("none", "quadratic", "l1",
                               "nonnegative", "non_negative")):
        raise NotImplementedError(
            f"GLRM MOJO export supports quadratic/absolute/huber loss "
            f"and none/quadratic/l1/nonnegative x-regularization; got "
            f"loss={loss!r} regularization_x={rx!r}")
    Y = np.asarray(out["archetypes"], np.float64)     # (k, P)
    cat_names = list(spec["cat_names"])
    num_names = list(spec["num_names"])
    x = cat_names + num_names
    cat_domains = list(spec.get("cat_domains") or [])
    domains: List[Optional[List[str]]] = (
        [(cat_domains[j] if j < len(cat_domains) else None)
         for j in range(len(cat_names))] + [None] * len(num_names))
    w = _ZipWriter()
    _common_info(w, "glrm", "Generalized Low Rank Modeling",
                 "DimReduction", model.model_id, False, len(x), 1,
                 len(x), sum(d is not None for d in domains), "1.10")
    w.writekv("initialization",
              str(model.params.get("init", "SVD")))
    w.writekv("regularizationX", rx)
    w.writekv("regularizationY", str(out.get("regularization_y", "None")))
    w.writekv("gammaX", float(out.get("gamma_x", 0.0)))
    w.writekv("gammaY", float(out.get("gamma_y", 0.0)))
    w.writekv("ncolX", int(Y.shape[0]))
    seed_p = model.params.get("seed")
    w.writekv("seed", int(-1 if seed_p is None else seed_p))
    w.writekv("transposed", False)
    w.writekv("num_categories", len(cat_names))
    w.writekv("num_numeric", len(num_names))
    w.writekv("norm_sub", [float(m) for m in spec["means"]])
    w.writekv("norm_mul",
              [float(1.0 / (s or 1.0)) for s in spec["sigmas"]])
    # deterministic-scoring extensions (this implementation's solve)
    w.writekv("loss", loss)
    from h2o_tpu_torch.models.glrm import GLRM_X_ITERS
    w.writekv("x_iters", GLRM_X_ITERS)
    w.writekv("standardize", bool(spec["standardize"]))
    w.writekv("use_all_factor_levels", bool(spec["use_all_factor_levels"]))
    w.writekv("cat_cards", [int(c) for c in spec["cat_cards"]])
    w.writekv("archetypes_size1", int(Y.shape[0]))
    w.writekv("archetypes_size2", int(Y.shape[1]))
    w.writeblob("archetypes", Y.astype(">f8").tobytes())
    return w.finish(x, domains)


def write_extiso_mojo(model) -> bytes:
    """ExtendedIsolationForest -> genmodel MOJO
    (ExtendedIsolationForestMojoModel byte format: per tree, int32
    sizeOfBranchingArrays then a level-ordered stream of
    [int32 node_number, byte 'N'|'L', NODE: n[] + p[] native-order
    doubles | LEAF: int32 num_rows]; anomaly = 2^(-pathLen/c(sample)))."""
    out = model.output
    if out.get("counts") is None:
        raise NotImplementedError(
            "this ExtendedIsolationForest model predates per-node row "
            "counts; retrain to export a MOJO")
    x = list(out["x"])
    nv = np.asarray(out["normals"], np.float64)    # (T, H, C)
    pv = np.asarray(out["points"], np.float64)
    sp = np.asarray(out["is_split"], bool)
    cnts = np.asarray(out["counts"], np.int64)
    T, H, C = nv.shape
    dom_map = out.get("domains") or {}
    domains: List[Optional[List[str]]] = [dom_map.get(c) for c in x]
    w = _ZipWriter()
    # genuine genmodel algo string (ExtendedIsolationForestMojoReader
    # is registered under "extendedisolationforest")
    _common_info(w, "extendedisolationforest", "Extended Isolation Forest",
                 "AnomalyDetection", model.model_id, False, len(x), 1,
                 len(x), sum(d is not None for d in domains), "1.00")
    w.writekv("ntrees", T)
    w.writekv("sample_size", int(out["sample_size"]))
    for t in range(T):
        buf = io.BytesIO()
        buf.write(struct.pack("<i", C))
        # only REACHABLE nodes (BFS stopping at leaves): the dense heap
        # is mostly zero-filled subtrees under early leaves, and the
        # stream format skips by node number anyway
        frontier = [0]
        while frontier:
            n = frontier.pop(0)
            buf.write(struct.pack("<i", n))
            if n < H and sp[t, n]:
                buf.write(b"N")
                buf.write(nv[t, n].astype("<f8").tobytes())
                buf.write(pv[t, n].astype("<f8").tobytes())
                frontier.append(2 * n + 1)
                frontier.append(2 * n + 2)
            else:
                buf.write(b"L")
                buf.write(struct.pack(
                    "<i", int(cnts[t, n]) if n < H else 0))
        w.writeblob(f"trees/t{t:02d}.bin", buf.getvalue())
    return w.finish(x, domains)


def write_genmodel_mojo(model) -> bytes:
    model = host_view(model)
    if model.output.get("preprocessing_te_key"):
        raise NotImplementedError(
            "model was trained with AutoML target-encoding "
            "preprocessing; the genmodel artifact cannot carry the "
            "encoder step — score through the cluster, or retrain "
            "without preprocessing for a standalone MOJO")
    if model.algo in ("gbm", "drf", "xgboost", "dt"):
        if model.algo == "xgboost" and \
                model.output.get("split_col") is None:
            # booster='gblinear' delegates to GLM: coefficient output
            return write_glm_mojo(model)
        return write_tree_mojo(model)
    if model.algo == "glm":
        return write_glm_mojo(model)
    if model.algo == "kmeans":
        return write_kmeans_mojo(model)
    if model.algo == "isolationforest":
        return write_isofor_mojo(model)
    if model.algo == "word2vec":
        return write_word2vec_mojo(model)
    if model.algo == "isotonicregression":
        return write_isotonic_mojo(model)
    if model.algo == "pca":
        return write_pca_mojo(model)
    if model.algo == "targetencoder":
        return write_target_encoder_mojo(model)
    if model.algo == "stackedensemble":
        return write_stackedensemble_mojo(model)
    if model.algo == "coxph":
        return write_coxph_mojo(model)
    if model.algo == "glrm":
        return write_glrm_mojo(model)
    if model.algo == "extendedisolationforest":
        return write_extiso_mojo(model)
    if model.algo == "deeplearning":
        return write_deeplearning_mojo(model)
    raise NotImplementedError(
        f"genmodel MOJO export not implemented for '{model.algo}'")


# ---------------------------------------------------------------------------
# reader (ModelMojoReader.parseModelInfo + scoreTree decode)
# ---------------------------------------------------------------------------

class _TreeDecoder:
    """genmodel tree bytecode -> flat node arrays."""

    def __init__(self, blob: bytes):
        self.b = blob
        self.pos = 0
        # node arrays (appended in parse order)
        self.col: List[int] = []
        self.thr: List[float] = []
        self.equal: List[int] = []
        self.na_dir: List[int] = []
        self.bit_off: List[int] = []
        self.bits: List[Optional[np.ndarray]] = []
        self.left: List[int] = []
        self.right: List[int] = []
        self.leaf_val: List[float] = []
        self.root = self._parse()

    def _u1(self):
        v = self.b[self.pos]
        self.pos += 1
        return v

    def _u2(self):
        v = struct.unpack_from("<H", self.b, self.pos)[0]
        self.pos += 2
        return v

    def _i4(self):
        v = struct.unpack_from("<i", self.b, self.pos)[0]
        self.pos += 4
        return v

    def _f4(self):
        v = struct.unpack_from("<f", self.b, self.pos)[0]
        self.pos += 4
        return v

    def _new_leaf(self, val: float) -> int:
        idx = len(self.col)
        self.col.append(-1)
        self.thr.append(0.0)
        self.equal.append(0)
        self.na_dir.append(0)
        self.bit_off.append(0)
        self.bits.append(None)
        self.left.append(-1)
        self.right.append(-1)
        self.leaf_val.append(val)
        return idx

    def _parse(self) -> int:
        node_type = self._u1()
        col = self._u2()
        if col == 65535:
            return self._new_leaf(self._f4())
        na_dir = self._u1()
        equal = node_type & 12
        thr = 0.0
        boff = 0
        bits = None
        if na_dir != NA_VS_REST:
            if equal == 0:
                thr = self._f4()
            elif equal == 8:
                raw = self.b[self.pos:self.pos + 4]
                self.pos += 4
                bits = np.unpackbits(np.frombuffer(raw, np.uint8),
                                     bitorder="little").astype(bool)
            elif equal == 12:
                boff = self._u2()
                nbits = self._i4()
                nb = ((nbits - 1) >> 3) + 1
                raw = self.b[self.pos:self.pos + nb]
                self.pos += nb
                bits = np.unpackbits(np.frombuffer(raw, np.uint8),
                                     bitorder="little")[:nbits].astype(bool)
            else:
                raise ValueError(f"unsupported equal bits {equal}")
        idx = len(self.col)
        self.col.append(col)
        self.thr.append(thr)
        self.equal.append(equal)
        self.na_dir.append(na_dir)
        self.bit_off.append(boff)
        self.bits.append(bits)
        self.left.append(-2)      # placeholders
        self.right.append(-2)
        self.leaf_val.append(0.0)

        left_leaf = (node_type & 48) == 48
        if not left_leaf:
            slen = node_type & 3
            self.pos += slen + 1          # skip-size field (unused here)
            self.left[idx] = self._parse()
        else:
            self.left[idx] = self._new_leaf(self._f4())
        right_leaf = (node_type & 0xC0) == 0xC0
        if right_leaf:
            self.right[idx] = self._new_leaf(self._f4())
        else:
            self.right[idx] = self._parse()
        return idx


def score_decoded_tree(tree: Dict, X: np.ndarray,
                       domain_lens: np.ndarray) -> np.ndarray:
    """Vectorized scoreTree (SharedTreeMojoModel.scoreTree semantics)."""
    n = X.shape[0]
    node = np.full(n, tree["root"], np.int64)
    col = tree["col"]
    out = np.zeros(n)
    active = col[node] >= 0
    out[~active] = tree["leaf_val"][node[~active]]
    max_depth = len(tree["col"]) + 1    # every step consumes a node
    for _ in range(max_depth):
        if not active.any():
            break
        nd = node[active]
        c = col[nd]
        d = X[active, c]
        nan = np.isnan(d)
        eq = tree["equal"][nd]
        # bitset out-of-range / domain overflow counts as NA-ish
        di = np.where(nan, 0, d).astype(np.int64)
        oob = np.zeros(len(nd), bool)
        has_bits = eq != 0
        if has_bits.any():
            for i in np.flatnonzero(has_bits):
                bits = tree["bits"][nd[i]]
                b = di[i] - tree["bit_off"][nd[i]]
                oob[i] = b < 0 or b >= len(bits)
        dom_over = (domain_lens[c] > 0) & (di >= domain_lens[c]) & ~nan
        na_ish = nan | (has_bits & oob) | dom_over
        na_dir = tree["na_dir"][nd]
        leftward = (na_dir == NA_LEFT) | (na_dir == DIR_LEFT)
        na_vs_rest = na_dir == NA_VS_REST
        test = np.zeros(len(nd), bool)
        num = (eq == 0) & ~na_vs_rest
        test[num] = d[num] >= tree["thr"][nd[num]]
        for i in np.flatnonzero(has_bits & ~na_vs_rest & ~oob):
            bits = tree["bits"][nd[i]]
            test[i] = bits[di[i] - tree["bit_off"][nd[i]]]
        go_right = np.where(na_ish, ~leftward, test)
        nxt = np.where(go_right, tree["right"][nd], tree["left"][nd])
        node[active] = nxt
        done = col[nxt] < 0
        idx = np.flatnonzero(active)
        out[idx[done]] = tree["leaf_val"][nxt[done]]
        active[idx[done]] = False
    if active.any():
        raise RuntimeError("MOJO tree traversal did not terminate "
                           "(corrupt tree bytecode?)")
    return out


def _parse_float_arr(info: Dict[str, str], key: str) -> np.ndarray:
    """'[a, b, c]' kv -> float64 array (shared by all algo readers)."""
    v = info.get(key, "[]").strip("[]")
    return np.asarray([float(s) for s in v.split(",") if s.strip()],
                      np.float64)


def read_genmodel_mojo(data) -> Dict:
    """Parse a genmodel MOJO zip (ours or a real H2O one) into a scoring
    dict: {'algo', 'columns', 'domains', 'info', trees/glm payload}."""
    if isinstance(data, (bytes, bytearray)):
        data = io.BytesIO(data)
    with zipfile.ZipFile(data) as z:
        names = set(z.namelist())
        ini = z.read("model.ini").decode().splitlines()
        info: Dict[str, str] = {}
        columns: List[str] = []
        domain_files: Dict[int, Tuple[int, str]] = {}
        section = 0
        for line in ini:
            line = line.strip()
            if not line:
                continue
            if line == "[info]":
                section = 1
            elif line == "[columns]":
                section = 2
            elif line == "[domains]":
                section = 3
            elif section == 1 and "=" in line:
                k, v = line.split("=", 1)
                info[k.strip()] = v.strip()
            elif section == 2:
                columns.append(line)
            elif section == 3:
                ci, rest = line.split(":", 1)
                cnt, fname = rest.strip().split(" ")
                domain_files[int(ci)] = (int(cnt), fname)
        domains: List[Optional[List[str]]] = [None] * len(columns)
        for ci, (cnt, fname) in domain_files.items():
            if ci >= len(columns):
                # genuine H2O artifacts (e.g. pruned-base-model SE
                # MOJOs) can declare domain indices from the original,
                # wider column set; the reference skips them
                # (ModelMojoReader.parseModelDomains: "col_index >=
                # n_columns continue")
                continue
            lines = z.read(f"domains/{fname}").decode().splitlines()
            domains[ci] = lines[:cnt]
        algo = info.get("algo", "").lower()
        if not algo:
            # mojo v1.0 artifacts (h2o < 3.12) predate the "algo" key;
            # map the display "algorithm" name instead
            algo = {
                "gradient boosting machine": "gbm",
                "gradient boosting method": "gbm",
                "distributed random forest": "drf",
                "generalized linear modeling": "glm",
                "generalized linear model": "glm",
                "isolation forest": "isolationforest",
                "k-means": "kmeans",
                "deep learning": "deeplearning",
                "word2vec": "word2vec",
            }.get(info.get("algorithm", "").lower(), "")
        if algo == "extendedisolationforest":   # genuine H2O algo string
            algo = "isoforextended"             # (internal alias)
        result = dict(info=info, columns=columns, domains=domains,
                      algo=algo)
        if algo in ("gbm", "drf", "isolationforest"):
            T = int(info["n_trees"])
            K = int(info.get("n_trees_per_class", 1))
            trees = []
            for t in range(T):
                group = []
                for k in range(K):
                    blob_name = f"trees/t{k:02d}_{t:03d}.bin"
                    if blob_name not in names:
                        group.append(None)
                        continue
                    dec = _TreeDecoder(z.read(blob_name))
                    group.append(dict(
                        root=dec.root,
                        col=np.asarray(dec.col, np.int64),
                        thr=np.asarray(dec.thr, np.float64),
                        equal=np.asarray(dec.equal, np.int64),
                        na_dir=np.asarray(dec.na_dir, np.int64),
                        bit_off=np.asarray(dec.bit_off, np.int64),
                        bits=dec.bits,
                        left=np.asarray(dec.left, np.int64),
                        right=np.asarray(dec.right, np.int64),
                        leaf_val=np.asarray(dec.leaf_val, np.float64)))
                trees.append(group)
            result["trees"] = trees
        elif algo == "glm":
            def arr(key, cast=float):
                v = info.get(key, "[]").strip("[]")
                return [cast(s) for s in v.split(",") if s.strip()] \
                    if v else []
            result["glm"] = dict(
                beta=np.asarray(arr("beta"), np.float64),
                cat_offsets=np.asarray(arr("cat_offsets", lambda s:
                                           int(float(s))), np.int64),
                cats=int(info.get("cats", 0)),
                nums=int(info.get("nums", 0)),
                num_means=np.asarray(arr("num_means"), np.float64),
                use_all_factor_levels=info.get(
                    "use_all_factor_levels", "false") == "true",
                mean_imputation=info.get(
                    "mean_imputation", "false") == "true",
                family=info.get("family", "gaussian"),
                link=info.get("link", "identity"),
                tweedie_link_power=float(
                    info.get("tweedie_link_power", 0.0)))
        elif algo == "word2vec":
            raw_vocab = z.read("vocabulary").decode().split("\n")
            if raw_vocab and raw_vocab[-1] == "":
                raw_vocab.pop()          # trailing writer newline
            vocab = [_unescape_newlines(s) for s in raw_vocab]
            vec_size = int(info.get("vec_size", 0))
            vecs = np.frombuffer(z.read("vectors"),
                                 dtype=">f4").astype(np.float32)
            result["word2vec"] = dict(
                words=vocab[: int(info.get("vocab_size", len(vocab)))],
                vectors=vecs.reshape(-1, vec_size) if vec_size else
                vecs.reshape(len(vocab), -1))
        elif algo == "stackedensemble":
            n_sub = int(info.get("submodel_count", 0))
            submodels: Dict[str, Dict] = {}
            for i in range(n_sub):
                key = info[f"submodel_key_{i}"]
                d = info[f"submodel_dir_{i}"]
                buf = io.BytesIO()
                with zipfile.ZipFile(buf, "w") as oz:
                    for entry in names:
                        if entry.startswith(d):
                            oz.writestr(entry[len(d):], z.read(entry))
                submodels[key] = buf.getvalue()
            # Positional, WITH None holes: the metalearner is fed a flat
            # basePreds vector indexed by base-model slot i; pruned
            # ("useless") models keep their slot and contribute 0.0
            # (StackedEnsembleMojoModel.java:34-58 skips null entries).
            base = [info.get(f"base_model{i}")
                    for i in range(int(info.get("base_models_num", 0)))]
            result["stackedensemble"] = dict(
                submodels=submodels, base_models=base,
                metalearner=info.get("metalearner"),
                metalearner_transform=info.get("metalearner_transform",
                                               "NONE"))
        elif algo == "isoforextended":
            T = int(info.get("ntrees", 0))
            trees_eif = []
            for t in range(T):
                blob = z.read(f"trees/t{t:02d}.bin")
                pos = 0
                C_b = struct.unpack_from("<i", blob, pos)[0]; pos += 4
                nodes = {}
                # genuine H2O blobs are AutoBuffer-backed and can carry
                # trailing padding past the last record; the reference
                # scorer never reads it (every descent breaks at a
                # leaf), so stop at the first non-record byte or when
                # a record would overrun the buffer
                while pos + 5 <= len(blob):
                    num = struct.unpack_from("<i", blob, pos)[0]
                    typ = blob[pos + 4: pos + 5]
                    if typ == b"N":
                        if pos + 5 + 16 * C_b > len(blob):
                            break
                        pos += 5
                        nvec = np.frombuffer(blob, "<f8", C_b, pos)
                        pos += 8 * C_b
                        pvec = np.frombuffer(blob, "<f8", C_b, pos)
                        pos += 8 * C_b
                        nodes[num] = ("N", nvec, pvec)
                    elif typ == b"L":
                        if pos + 5 + 4 > len(blob):
                            break
                        pos += 5
                        rows_ = struct.unpack_from("<i", blob, pos)[0]
                        pos += 4
                        nodes[num] = ("L", rows_)
                    else:
                        break
                trees_eif.append(nodes)
            result["isoforextended"] = dict(
                trees=trees_eif, ntrees=T,
                sample_size=int(info.get("sample_size", 0)))
        elif algo == "glrm":
            garr = lambda key: _parse_float_arr(info, key)  # noqa: E731
            if "archetypes_size1" in info:     # our writer's key set
                k = int(info["archetypes_size1"])
                P = int(info.get("archetypes_size2", 0))
                cat_cards = [int(v) for v in garr("cat_cards")]
                loss = info.get("loss", "Quadratic").lower()
                uafl = info.get("use_all_factor_levels",
                                "false") == "true"
                standardize = info.get("standardize", "false") == "true"
                permutation = None
            else:                 # genuine H2O GlrmMojoWriter v1.00/1.10
                k = int(info.get("nrowY", 0))
                P = int(info.get("ncolY", 0))
                ncats = int(info.get("num_categories", 0))
                cat_cards = [int(v) for v in
                             garr("num_levels_per_category")][:ncats]
                # per-column loss file; our scorer is single-loss —
                # accept a uniform numeric loss, refuse mixed ones
                # loudly rather than score with the wrong objective
                loss = "quadratic"
                if "losses" in names:
                    num_losses = {
                        ln.strip() for ln in
                        z.read("losses").decode().splitlines()
                        if ln.strip() and ln.strip() != "Categorical"}
                    if len(num_losses) > 1:
                        raise NotImplementedError(
                            "GLRM MOJO with mixed per-column losses "
                            f"{sorted(num_losses)} is not supported by "
                            "this reader (single-loss X solve)")
                    if num_losses:
                        loss = num_losses.pop().lower()
                uafl = True        # GLRM expands every factor level
                standardize = True  # normSub/normMul always applied
                permutation = [int(float(s)) for s in
                               info.get("cols_permutation", "[]")
                               .strip("[]").split(",") if s.strip()]
            result["glrm"] = dict(
                archetypes=np.frombuffer(z.read("archetypes"),
                                         dtype=">f8").astype(
                    np.float64).reshape(k, P),
                loss=loss,
                rx=info.get("regularizationX", "None").lower(),
                gamma_x=float(info.get("gammaX", 0.0)),
                x_iters=int(info.get(
                    "x_iters",
                    __import__("h2o_tpu_torch.models.glrm",
                               fromlist=["GLRM_X_ITERS"]).GLRM_X_ITERS)),
                standardize=standardize,
                uafl=uafl,
                permutation=permutation,
                cat_cards=cat_cards,
                norm_sub=garr("norm_sub"), norm_mul=garr("norm_mul"),
                cats=int(info.get("num_categories", 0)),
                nums=int(info.get("num_numeric", 0)))
        elif algo == "coxph":
            if int(info.get("strata_count", 0) or 0) != 0:
                raise NotImplementedError(
                    "CoxPH MOJO with strata is not supported by this "
                    "reader (per-stratum x_mean blocks)")
            carr = lambda key: _parse_float_arr(info, key)  # noqa: E731
            result["coxph"] = dict(
                coef=carr("coef"),
                cats=int(info.get("cats", 0)),
                cat_offsets=np.asarray(
                    [int(float(s)) for s in
                     info.get("cat_offsets", "[0]").strip("[]")
                     .split(",") if s.strip()], np.int64),
                use_all_factor_levels=info.get(
                    "use_all_factor_levels", "false") == "true",
                nums=int(info.get("num_numerical_columns", 0)),
                num_means=carr("num_means"),
                x_mean_cat=np.frombuffer(z.read("x_mean_cat"),
                                         dtype=">f8").astype(np.float64),
                x_mean_num=np.frombuffer(z.read("x_mean_num"),
                                         dtype=">f8").astype(np.float64))
        elif algo == "isotonicregression":
            iarr = lambda key: _parse_float_arr(info, key)  # noqa: E731
            result["isotonic"] = dict(
                min_x=float(info.get("min_x", 0)),
                max_x=float(info.get("max_x", 0)),
                out_of_bounds=info.get("out_of_bounds", "clip"),
                thresholds_x=iarr("thresholds_x"),
                thresholds_y=iarr("thresholds_y"))
        elif algo == "pca":
            parr = lambda key: _parse_float_arr(info, key)  # noqa: E731
            k = int(info.get("k", 0))
            raw = np.frombuffer(z.read("eigenvectors_raw"),
                                dtype=">f8").astype(np.float64)
            P = int(info.get("eigenvector_size", 0)) or                 (len(raw) // max(k, 1))
            result["pca"] = dict(
                k=k, norm_sub=parr("normSub"), norm_mul=parr("normMul"),
                num_means=parr("num_means"),
                eigenvectors=raw.reshape(P, k))
        elif algo == "targetencoder":
            ini_enc = z.read(
                "feature_engineering/target_encoding/encoding_map.ini"
            ).decode().splitlines()
            enc: Dict[str, Dict[int, Tuple[float, float]]] = {}
            cur = None
            for line in ini_enc:
                line = line.strip()
                if not line:
                    continue
                if line.startswith("[") and line.endswith("]"):
                    cur = line[1:-1]
                    enc[cur] = {}
                elif "=" in line and cur is not None:
                    lvl, rest = line.split("=", 1)
                    num, den = rest.split()
                    enc[cur][int(lvl)] = (float(num), float(den))
            result["targetencoder"] = dict(
                encoding_map=enc,
                prior=float(info.get("priorMean", 0.0)),
                with_blending=info.get("with_blending",
                                       "false") == "true",
                inflection_point=float(info.get("inflection_point",
                                                10.0)),
                smoothing=float(info.get("smoothing", 20.0)))
        elif algo == "kmeans":
            karr = lambda key: _parse_float_arr(info, key)  # noqa: E731
            k = int(info.get("center_num", 0))
            result["kmeans"] = dict(
                standardize=info.get("standardize", "false") == "true",
                means=karr("standardize_means"),
                mults=karr("standardize_mults"),
                centers=np.stack([karr(f"center_{i}")
                                  for i in range(k)]) if k else
                np.zeros((0, 0)))
        elif algo == "deeplearning":
            darr = lambda key: _parse_float_arr(info, key)  # noqa: E731
            units = [int(float(s)) for s in
                     info.get("neural_network_sizes", "[]")
                     .strip("[]").split(",") if s.strip()]
            layers = []
            for i in range(len(units) - 1):
                Wt = darr(f"weight_layer{i}").reshape(
                    units[i + 1], units[i])          # row-major out×in
                layers.append(dict(W=Wt.T, b=darr(f"bias_layer{i}")))
            result["deeplearning"] = dict(
                units=units, layers=layers,
                activation=info.get("activation", "Rectifier"),
                cats=int(info.get("cats", 0)),
                nums=int(info.get("nums", 0)),
                cat_offsets=np.asarray(
                    [int(float(s)) for s in
                     info.get("cat_offsets", "[0]").strip("[]")
                     .split(",") if s.strip()], np.int64),
                use_all_factor_levels=info.get(
                    "use_all_factor_levels", "false") == "true",
                norm_sub=darr("norm_sub"), norm_mul=darr("norm_mul"),
                distribution=info.get("distribution", "AUTO"))
        else:
            raise NotImplementedError(
                f"genmodel MOJO import for algo '{algo}'")
        return result


# ---------------------------------------------------------------------------
# standalone scoring of parsed genmodel MOJOs (GenModel.score0 semantics)
# ---------------------------------------------------------------------------

def _link_inv(name: str, x: np.ndarray, tweedie_link_power=0.0):
    if name in ("logit", "ologit"):
        return 1.0 / (1.0 + np.exp(-x))
    if name == "log":
        return np.exp(x)
    if name == "inverse":
        xx = np.where(x < 0, np.minimum(-1e-5, x), np.maximum(1e-5, x))
        return 1.0 / xx
    if name == "tweedie":
        p = 1.0 - tweedie_link_power
        return np.where(p == 0, np.exp(x), np.power(np.maximum(x, 1e-30),
                                                    1.0 / p)) \
            if tweedie_link_power != 0 else np.exp(x)
    return x  # identity


class GenmodelMojoModel:
    """A parsed genmodel MOJO with pure-numpy scoring — drop-in for the
    npz MojoModel in GenericModel (same .algo/.params/.meta/.arrays +
    score_matrix surface)."""

    def __init__(self, zip_bytes: bytes):
        self._zip = bytes(zip_bytes)
        p = read_genmodel_mojo(self._zip)
        self.parsed = p
        info = p["info"]
        self.source_algo = p["algo"]
        self.algo = "genmodel"
        self.params = {"response_column":
                       (p["columns"][-1]
                        if info.get("supervised") == "true" and p["columns"]
                        else None)}
        supervised = info.get("supervised") == "true"
        x = p["columns"][:-1] if supervised and len(p["columns"]) > 1 \
            else list(p["columns"])
        resp_dom = p["domains"][-1] if supervised and p["domains"] else None
        self.meta = {
            "x": x,
            "response_domain": resp_dom,
            "domains": {c: d for c, d in zip(p["columns"], p["domains"])
                        if d is not None},
            "source_algo": self.source_algo,
            "model_category": info.get("category"),
        }
        self.arrays = {"__genmodel_zip__":
                       np.frombuffer(self._zip, np.uint8)}

    # -- MojoModel-compatible surface --------------------------------------
    @property
    def columns(self) -> List[str]:
        return list(self.meta["x"])

    @property
    def response_domain(self):
        return self.meta.get("response_domain")

    @property
    def nclasses(self) -> int:
        d = self.response_domain
        return len(d) if d else 1

    def domain_of(self, col: str):
        return (self.meta.get("domains") or {}).get(col)

    def score_matrix(self, X: np.ndarray) -> np.ndarray:
        p = self.parsed
        info = p["info"]
        nclass = int(info.get("n_classes", 1))
        dom_lens = np.asarray(
            [len(d) if d is not None else 0
             for d in p["domains"][:X.shape[1]]], np.int64)
        if p["algo"] in ("gbm", "drf", "isolationforest"):
            T = int(info["n_trees"])
            K = int(info.get("n_trees_per_class", 1))
            preds = np.zeros((X.shape[0], K))
            for group in p["trees"]:
                for k, tree in enumerate(group):
                    if tree is not None:
                        preds[:, k] += score_decoded_tree(tree, X, dom_lens)
            if p["algo"] == "isolationforest":
                # total path length -> normalized anomaly score
                # (IsolationForestMojoModel.unifyPreds)
                lo = float(info.get("min_path_length", 0))
                hi = float(info.get("max_path_length", 1))
                total = preds[:, 0]
                score = (hi - total) / (hi - lo) if hi > lo else \
                    np.ones_like(total)
                return np.stack([score, total / max(T, 1)], axis=1)
            thr = float(info.get("default_threshold", 0.5))
            if p["algo"] == "gbm":
                init_f = float(info.get("init_f", 0.0))
                link = info.get("link_function")
                if link is None:
                    # pre-link_function MOJOs derive it from the
                    # distribution (ModelMojoReader.defaultLinkFunction)
                    dist = info.get("distribution", "gaussian")
                    link = ("logit" if dist in (
                        "bernoulli", "fractionalbinomial",
                        "quasibinomial", "modified_huber", "ordinal")
                        else "log" if dist in ("multinomial", "poisson",
                                               "gamma", "tweedie")
                        else "identity")
                if nclass == 2:
                    p1 = _link_inv(link, preds[:, 0] + init_f)
                    label = (p1 >= thr).astype(np.float64)
                    return np.stack([label, 1 - p1, p1], axis=1)
                if nclass > 2:
                    e = np.exp(preds)
                    P = e / np.maximum(e.sum(axis=1, keepdims=True), 1e-30)
                    label = np.argmax(P, axis=1).astype(np.float64)
                    return np.concatenate([label[:, None], P], axis=1)
                return _link_inv(link, preds[:, 0] + init_f)
            # drf
            if nclass == 2:
                p0 = preds[:, 0] / max(T, 1)
                p1 = 1.0 - p0
                label = (p1 >= thr).astype(np.float64)
                return np.stack([label, p0, p1], axis=1)
            if nclass > 2:
                s = np.maximum(preds.sum(axis=1, keepdims=True), 1e-30)
                P = preds / s
                label = np.argmax(P, axis=1).astype(np.float64)
                return np.concatenate([label[:, None], P], axis=1)
            return preds[:, 0] / max(T, 1)
        if p["algo"] == "glm":
            g = p["glm"]
            beta = g["beta"]
            cats = g["cats"]
            offs = g["cat_offsets"]
            uafl = g["use_all_factor_levels"]
            Xc = X.copy()
            if g["mean_imputation"]:
                for j in range(cats, Xc.shape[1]):
                    nm = g["num_means"]
                    if j - cats < len(nm):
                        Xc[np.isnan(Xc[:, j]), j] = nm[j - cats]
                Xc[:, :cats] = np.where(np.isnan(Xc[:, :cats]), 0.0,
                                        Xc[:, :cats])
            if g["family"] == "multinomial":
                # flat beta of K blocks [coefs..., intercept]
                # (GlmMultinomialMojoModel.java:38-52)
                K = nclass
                P = len(beta) // K
                noff = int(offs[cats] - cats) if cats else 0
                etas = np.zeros((X.shape[0], K))
                for c in range(K):
                    bc = beta[c * P: (c + 1) * P]
                    eta_c = np.zeros(X.shape[0])
                    for i in range(cats):
                        ival = Xc[:, i].astype(np.int64)
                        if not uafl:
                            ival = ival - 1
                        ival = ival + offs[i]
                        ok = (ival >= offs[i]) & (ival < offs[i + 1])
                        eta_c += np.where(
                            ok, bc[np.clip(ival, 0, P - 1)], 0.0)
                    for i in range(cats, cats + g["nums"]):
                        eta_c += bc[noff + i] * Xc[:, i]
                    eta_c += bc[P - 1]
                    etas[:, c] = eta_c
                e = np.exp(etas - etas.max(axis=1, keepdims=True))
                Pm = e / e.sum(axis=1, keepdims=True)
                label = np.argmax(Pm, axis=1).astype(np.float64)
                return np.concatenate([label[:, None], Pm], axis=1)
            eta = np.zeros(X.shape[0])
            for i in range(cats):
                ival = Xc[:, i].astype(np.int64)
                if not uafl:
                    ival = ival - 1
                ival = ival + offs[i]
                ok = (ival >= offs[i]) & (ival < offs[i + 1])
                eta += np.where(ok, beta[np.clip(ival, 0,
                                                 len(beta) - 1)], 0.0)
            noff = int(offs[cats] - cats) if cats else 0
            for i in range(cats, cats + g["nums"]):
                eta += beta[noff + i] * Xc[:, i]
            eta += beta[-1]
            mu = _link_inv(g["link"], eta, g["tweedie_link_power"])
            if g["family"] in ("binomial", "quasibinomial",
                              "fractionalbinomial"):
                thr = float(info.get("default_threshold", 0.5))
                label = (mu >= thr).astype(np.float64)
                return np.stack([label, 1 - mu, mu], axis=1)
            return mu
        if p["algo"] == "stackedensemble":
            se = p["stackedensemble"]
            cache = getattr(self, "_se_cache", None)
            if cache is None:
                cache = {k: GenmodelMojoModel(b)
                         for k, b in se["submodels"].items()}
                self._se_cache = cache
            parent_cols = list(self.meta["x"])
            col_idx = {c: i for i, c in enumerate(parent_cols)}

            def sub_score(key):
                sub = cache[key]
                sel = [col_idx[c] for c in sub.columns]
                return np.atleast_2d(
                    np.asarray(sub.score_matrix(X[:, sel])))

            # Positional basePreds, exactly score0's layout
            # (StackedEnsembleMojoModel.java:29-61): slot i for
            # binomial p1 / regression pred, slots i*K..i*K+K-1 for
            # multinomial probs; pruned (null) base models leave 0.0.
            R = X.shape[0]
            n_base = len(se["base_models"])
            if nclass > 2:
                Xm = np.zeros((R, n_base * nclass))
                for i, bk in enumerate(se["base_models"]):
                    if bk is None or bk not in cache:
                        continue
                    raw = sub_score(bk)
                    Xm[:, i * nclass: (i + 1) * nclass] = \
                        raw[:, 1: 1 + nclass]
            elif nclass == 2:
                Xm = np.zeros((R, n_base))
                for i, bk in enumerate(se["base_models"]):
                    if bk is None or bk not in cache:
                        continue
                    Xm[:, i] = sub_score(bk)[:, 2]
            else:
                Xm = np.zeros((R, n_base))
                for i, bk in enumerate(se["base_models"]):
                    if bk is None or bk not in cache:
                        continue
                    Xm[:, i] = sub_score(bk).reshape(R)
            if nclass >= 2 and se.get("metalearner_transform") == "Logit":
                q = np.clip(Xm, 1e-9, 1 - 1e-9)
                Xm = np.maximum(-19.0, np.log(q / (1.0 - q)))
            meta = cache[se["metalearner"]]
            return meta.score_matrix(Xm)
        if p["algo"] == "isoforextended":
            ei = p["isoforextended"]

            def c_n(n):
                if n > 2:
                    return 2.0 * (np.log(n - 1.0) + 0.5772156649015329) \
                        - 2.0 * (n - 1.0) / n
                return 1.0 if n == 2 else 0.0

            R = X.shape[0]
            # float32 projections: the builder and the native scorer
            # route in f32; f64 here could flip rows that sit within
            # rounding error of a hyperplane
            Xz = np.nan_to_num(X.astype(np.float32))
            C_b = X.shape[1]
            total = np.zeros(R)
            for nodes in ei["trees"]:
                # dense per-heap reconstruction -> vectorized descent
                # (the parsed dict is sparse; node numbers are heap ids)
                Ht = max(nodes) + 1
                nvs = np.zeros((Ht, C_b), np.float32)
                pvs = np.zeros((Ht, C_b), np.float32)
                split = np.zeros(Ht, bool)
                leafc = np.zeros(Ht, np.float64)
                for num, kind in nodes.items():
                    if kind[0] == "N":
                        split[num] = True
                        nvs[num] = kind[1]
                        pvs[num] = kind[2]
                    else:
                        leafc[num] = c_n(kind[1])
                depth = max(int(np.ceil(np.log2(Ht + 1))), 1)
                node = np.zeros(R, np.int64)
                height = np.zeros(R)
                for _ in range(depth):
                    is_n = split[node]
                    proj = np.einsum(
                        "rc,rc->r", Xz - pvs[node], nvs[node])
                    nxt = np.where(proj <= 0, 2 * node + 1,
                                   2 * node + 2)
                    node = np.where(is_n, nxt, node)
                    height += is_n
                total += height + leafc[node]
            mean_len = total / max(ei["ntrees"], 1)
            denom = max(c_n(ei["sample_size"]), 1e-12)
            score = np.power(2.0, -mean_len / denom)
            return np.stack([score, mean_len], axis=1)
        if p["algo"] == "glrm":
            gl = p["glrm"]
            Y = gl["archetypes"]
            if gl.get("permutation"):
                # genuine H2O MOJOs keep external column order; internal
                # col i reads external col permutation[i] (cats first)
                X = X[:, gl["permutation"]]
            cats, nums = gl["cats"], gl["nums"]
            lo = 0 if gl["uafl"] else 1
            blocks, masks = [], []
            for i, card in enumerate(gl["cat_cards"]):
                codes = X[:, i].astype(np.float64)
                ok = ~np.isnan(codes) & (codes >= 0)
                iv = np.where(ok, codes, 0).astype(np.int64)
                onehot = np.zeros((X.shape[0], card - lo))
                for lvl in range(lo, card):
                    onehot[:, lvl - lo] = (iv == lvl) & ok
                blocks.append(onehot)
                masks.append(np.repeat(ok[:, None], card - lo, axis=1))
            num_block = X[:, cats: cats + nums].astype(np.float64)
            num_ok = ~np.isnan(num_block)
            filled = np.where(num_ok, num_block,
                              gl["norm_sub"][None, :])
            if gl["standardize"]:
                filled = (filled - gl["norm_sub"][None, :]) * \
                    gl["norm_mul"][None, :]
            blocks.append(filled)
            masks.append(num_ok)
            A = np.concatenate(blocks, axis=1)
            mask = np.concatenate(masks, axis=1)
            # deterministic prox-gradient X solve (models/glrm.py
            # _x_solver: X0 = 0, alpha = 1/||Y||^2, x_iters steps)
            alpha = 1.0 / max(float((Y * Y).sum()), 1.0)
            Az = np.nan_to_num(A)
            Xs = np.zeros((A.shape[0], Y.shape[0]))
            loss, rx, gx = gl["loss"], gl["rx"], gl["gamma_x"]
            for _ in range(gl["x_iters"]):
                U = Xs @ Y
                if loss == "quadratic":
                    dU = 2.0 * (U - Az)
                elif loss == "absolute":
                    dU = np.sign(U - Az)
                else:                                  # huber
                    d = U - Az
                    dU = np.where(np.abs(d) <= 1.0, d, np.sign(d))
                g = (np.where(mask, dU, 0.0)) @ Y.T
                Xs = Xs - alpha * g
                sg = alpha * gx
                if rx == "quadratic":
                    Xs = Xs / (1.0 + 2.0 * sg)
                elif rx == "l1":
                    Xs = np.sign(Xs) * np.maximum(np.abs(Xs) - sg, 0.0)
                elif rx in ("nonnegative", "non_negative"):
                    Xs = np.maximum(Xs, 0.0)
            return Xs @ Y
        if p["algo"] == "coxph":
            cx = p["coxph"]
            coef = cx["coef"]
            cats, nums = cx["cats"], cx["nums"]
            offs = cx["cat_offsets"]
            uafl = cx["use_all_factor_levels"]
            x_mean = np.concatenate([cx["x_mean_cat"],
                                     cx["x_mean_num"]])
            lp_base = float(coef @ x_mean)
            lp = np.zeros(X.shape[0])
            for i in range(cats):
                ival = X[:, i].astype(np.float64)
                iv = np.where(np.isnan(ival), -1, ival).astype(np.int64)
                if not uafl:
                    iv = iv - 1
                iv = iv + offs[i]
                ok = (iv >= offs[i]) & (iv < offs[i + 1])
                lp += np.where(ok, coef[np.clip(iv, 0,
                                                len(coef) - 1)], 0.0)
            n_cat_coef = int(offs[cats]) if cats else 0
            num_block = X[:, cats: cats + nums].astype(np.float64)
            # impute_missing contract: NA numerics take the training
            # ROLLUP mean (expand_for_scoring), which differs from the
            # centering mean when response-invalid rows were dropped
            imp = cx["num_means"] if len(cx["num_means"]) == nums \
                else cx["x_mean_num"]
            num_block = np.where(np.isnan(num_block),
                                 imp[None, :], num_block)
            lp += num_block @ coef[n_cat_coef: n_cat_coef + nums]
            return lp - lp_base
        if p["algo"] == "isotonicregression":
            iso = p["isotonic"]
            tx, ty = iso["thresholds_x"], iso["thresholds_y"]
            raw_x = X[:, 0].astype(np.float64)
            x = np.clip(raw_x, iso["min_x"], iso["max_x"])
            y = np.interp(x, tx, ty)
            if iso.get("out_of_bounds", "clip").lower() == "na":
                y = np.where((raw_x < iso["min_x"]) |
                             (raw_x > iso["max_x"]), np.nan, y)
            return y
        if p["algo"] == "pca":
            pc = p["pca"]
            Xc = X.astype(np.float64).copy()
            if len(pc["num_means"]):
                # mean imputation (matches expand_for_scoring)
                Xc = np.where(np.isnan(Xc), pc["num_means"][None, :], Xc)
            else:
                Xc = np.nan_to_num(Xc)
            if len(pc["norm_sub"]):
                Xc = (Xc - pc["norm_sub"][None, :]) * \
                    pc["norm_mul"][None, :]
            return Xc @ pc["eigenvectors"]
        if p["algo"] == "targetencoder":
            te = p["targetencoder"]
            cols = [c for c in p["columns"][:-1]]
            out_cols = []
            for j, col in enumerate(cols):
                emap = te["encoding_map"].get(col, {})
                card = (max(emap) + 1) if emap else 0
                table = np.full(card + 1, te["prior"])
                for lvl, (num, den) in emap.items():
                    mean = num / den if den > 0 else te["prior"]
                    if te["with_blending"]:
                        lam = 1.0 / (1.0 + np.exp(
                            -(den - te["inflection_point"]) /
                            max(te["smoothing"], 1e-6)))
                        mean = lam * mean + (1 - lam) * te["prior"]
                    table[lvl] = mean
                codes = X[:, j].astype(np.float64)
                idx = np.where(np.isnan(codes) | (codes < 0) |
                               (codes >= card), card,
                               codes).astype(np.int64)
                out_cols.append(table[idx])
            return np.stack(out_cols, axis=1)
        if p["algo"] == "kmeans":
            km = p["kmeans"]
            Xc = X.astype(np.float64).copy()
            if km["standardize"] and len(km["means"]):
                Xc = (Xc - km["means"][None, :]) * km["mults"][None, :]
            Xc = np.nan_to_num(Xc)
            c = km["centers"]
            d2 = (Xc * Xc).sum(1, keepdims=True) - 2 * Xc @ c.T + \
                (c * c).sum(1)[None, :]
            return np.argmin(d2, axis=1).astype(np.float64)
        if p["algo"] == "deeplearning":
            dl = p["deeplearning"]
            cats, nums = dl["cats"], dl["nums"]
            offs = dl["cat_offsets"]
            uafl = dl["use_all_factor_levels"]
            n_in = dl["units"][0]
            R = X.shape[0]
            A = np.zeros((R, n_in))
            # one-hot expand cats (NA/out-of-range -> all-zero block)
            for i in range(cats):
                ival = X[:, i].astype(np.float64)
                iv = np.where(np.isnan(ival), -1, ival).astype(np.int64)
                if not uafl:
                    iv = iv - 1
                iv = iv + offs[i]
                ok = (iv >= offs[i]) & (iv < offs[i + 1])
                rows = np.flatnonzero(ok)
                A[rows, iv[rows]] = 1.0
            noff = int(offs[cats]) if cats else 0
            num_block = X[:, cats: cats + nums].astype(np.float64)
            if len(dl["norm_sub"]):
                # mean imputation == 0 in standardized space
                # (expand_for_scoring's adaptTestForTrain contract)
                num_block = np.where(np.isnan(num_block),
                                     dl["norm_sub"][None, :], num_block)
                num_block = (num_block - dl["norm_sub"][None, :]) * \
                    dl["norm_mul"][None, :]
            else:
                num_block = np.nan_to_num(num_block)
            A[:, noff: noff + nums] = num_block
            act = dl["activation"].lower()
            h = A
            for li, layer in enumerate(dl["layers"]):
                h = h @ layer["W"] + layer["b"][None, :]
                if li < len(dl["layers"]) - 1:
                    if "tanh" in act:
                        h = np.tanh(h)
                    elif "maxout" in act:
                        h = np.maximum(h, 0.0)   # maxout(k=1) degenerate
                    else:
                        h = np.maximum(h, 0.0)   # rectifier
            if nclass >= 2:
                e = np.exp(h - h.max(axis=1, keepdims=True))
                P = e / e.sum(axis=1, keepdims=True)
                if nclass == 2:
                    thr = float(info.get("default_threshold", 0.5))
                    label = (P[:, 1] >= thr).astype(np.float64)
                else:
                    label = np.argmax(P, axis=1).astype(np.float64)
                return np.concatenate([label[:, None], P], axis=1)
            return h[:, 0]
        raise NotImplementedError(p["algo"])
