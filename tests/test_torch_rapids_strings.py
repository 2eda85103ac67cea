"""``h2o_tpu_torch.rapids``' string, time, date, text, timezone and model
ops against ``h2o_tpu.rapids`` (ROADMAP P12c-ii-a).

The same seeded frames are published under one key in both packages'
DKVs, and the same expressions go through the reference's
``rapids_exec`` on the test mesh and the port's with ``device="cpu"``.
The cases are the expressions of ``tests/test_rapids_round3.py``,
``test_rapids_munge.py`` and ``test_rapids_extended.py`` that use these
ops, the ``setTimeZone`` case of ``test_time_precision.py`` and the
``tf-idf`` case of ``test_xgb_extras.py``, then edge cells: None and
empty strings, ``"ß"`` under ``toupper``, labels that collide, ``gsub``
with group references, negative epoch milliseconds, 2020-02-29,
2020-12-31 and 2021-01-01, and NaN times.

Held bitwise (names, types, domains, codes and values; NaN where NaN),
but the model ops, which score a reference model carried across by its
converter (``*_from_jax_output``) and published under one key in both
DKVs: their scores agree to float32 rounding, not bitwise, so
``PermutationVarImp``, ``fairnessMetrics`` and ``makeLeaderboard`` are
held within ``MODEL_TOL`` of the reference's numbers, relative to 1 or
|x| (the largest difference measured over these cases is 2.7e-7, a
leaderboard's logloss; labels, counts and orders come out equal), and
``predict_time_per_row_ms`` is only finite and above 0.  The converters
carry no metrics: a carried GBM or GLM gets its training metrics from
its own ``model_metrics`` on the training frame.  The host ops move no
byte to or from a device (``core.diag.TransferStats``).
"""

import numpy as np
import pytest

from h2o_tpu_torch.core import device as tdevice
from h2o_tpu_torch.core.diag import TransferStats
from h2o_tpu_torch.core.frame import T_CAT, T_NUM, T_STR, T_TIME
from h2o_tpu_torch.core.frame import Frame as TFrame
from h2o_tpu_torch.core.frame import Vec as TVec
from h2o_tpu_torch.core.store import dkv, unpublish_on_exit
from h2o_tpu_torch.rapids import interp as ti

from tests.test_torch_rapids_interp import (both, pair, publish, same,
                                            unpublish_ref)

MODEL_TOL = 1e-6


@pytest.fixture(autouse=True)
def _unpublish():
    """What a test publishes in the port's DKV is removed after it."""
    with unpublish_on_exit():
        yield


pytestmark = pytest.mark.shared_dkv

STRS = ["  Hello World ", "ß", None, "", "abc-def-ghi", "a", "A", "x1y2z3",
        "Straße", "a,b,,c", "   ", "aaa-b", "Hello", "hello", "naïve café",
        "12-34", "a-b-c-d-e", "Ee"]
# the last level is held by no row
LEVELS = ["a", "A", " b ", "ß", "c-d-e", "Ee", "hello", "x,y", "aa-a",
          "u-n-u-s-e-d-z"]
CODES = [0, 1, 2, 3, 4, 5, 6, 7, -1, 8, 0, 1, 3, -1, 6, 2, 4, 5]


def _ms(*stamps):
    return [np.nan if s is None else float(
        np.datetime64(s, "ms").astype("int64")) for s in stamps]


TIMES = _ms("2020-02-29T13:45:30.250", "2020-12-31T23:59:59.999",
            "2021-01-01T00:00:00", "1969-07-20T20:17:40", None,
            "1900-03-01T06:00:00", "2024-06-15T12:30:45", "1970-01-01",
            "1969-12-31T23:59:59.500", "2021-01-03T10:00:00",
            "2021-01-04T00:00:01", "1999-12-31T23:00:00")
DATES = ["2020-02-29", "2021-01-01", "2020-12-31", "bad", None,
         "2020-13-01", "1969-07-20", "2019-02-29", "", "1900-03-01"]


def _frames():
    rng = np.random.default_rng(3)
    times = np.asarray(TIMES + list(np.round(rng.uniform(-3e12, 3e12, 40))),
                       np.float64)
    nums = np.asarray([0.1, -0.0, 0.0, 1e10, np.nan, 3.0, -2.5, np.inf,
                       1.5e-8, 123456.789, -7.0, 0.30000001],
                      np.float32)
    dom = sorted({d for d in DATES if d is not None})
    return {
        "rs": {"s": (T_STR, STRS, None)},
        "rc": {"c": (T_CAT, CODES, LEVELS)},
        "rsc": {"s": (T_STR, STRS, None), "c": (T_CAT, CODES, LEVELS)},
        "rt": {"t": (T_TIME, times, None)},
        "rd": {"d": (T_STR, DATES, None)},
        "rdc": {"d": (T_CAT, [-1 if d is None else dom.index(d)
                              for d in DATES], dom)},
        "rdt": {"d": (T_STR, ["2020-02-29 13:45:30", "2021-01-01 00:00:00",
                              "2020-02-30 01:02:03", None], None)},
        "rn": {"n": (T_NUM, nums, None)},
        "rm": {"y": (T_NUM, [2020, 2021, 1969, np.nan, 2000], None),
               "m": (T_NUM, [1, 1, 6, 0, 11], None),
               "d": (T_NUM, [28, 28, 19, 0, 30], None)},
        "ra": {"a": (T_STR, ["kitten", "", None, "abc", "same", "flaw",
                             "", "ab"], None)},
        "rb": {"b": (T_STR, ["sitting", "x", "y", None, "same", "lawn",
                             "", "ba"], None)},
    }


@pytest.fixture(scope="module")
def frames(cl):
    keys = []
    for key, cols in _frames().items():
        publish(key, *pair(cols))
        keys.append(key)
    yield
    unpublish_ref(*keys)


@pytest.fixture()
def pub(frames):
    """The module's frames, in both DKVs."""


# ------------------------------------------------------------ string ops

STR_EXPRS = [
    "(toupper {f})", "(tolower {f})", "(trim {f})", "(nchar {f})",
    "(length {f})", "(lstrip {f})", "(rstrip {f})", "(lstrip {f} 'a ')",
    "(rstrip {f} 'e ')", "(substring {f} 1 3)", "(substring {f} 2)",
    "(replacefirst {f} 'a' 'Z')", "(sub {f} 'l+' '_')",
    "(replaceall {f} '[aeiou]' '')", r"(gsub {f} '(\w)-(\w)' '\2=\1')",
    "(gsub {f} 'e' '3')", "(countmatches {f} 'a')", "(strsplit {f} '-')",
    "(strsplit {f} ',')"]


@pytest.mark.parametrize("f", ["rs", "rc"])
@pytest.mark.parametrize("expr", STR_EXPRS)
def test_string_op(pub, expr, f):
    ref, port = both(expr.format(f=f))
    same(port, ref)


def test_string_ops_on_two_columns(pub):
    for expr in ("(toupper rsc)", "(nchar rsc)", "(countmatches rsc 'l')"):
        ref, port = both(expr)
        same(port, ref)


def test_colliding_labels_merge(pub):
    """``toupper`` maps 'a' and 'A' to one level (and 'ß' to 'SS'): the
    domain is the sorted new labels, the codes remapped."""
    ref, port = both("(toupper rc)")
    same(port, ref)
    v = port.vecs[0]
    assert v.domain.count("A") == 1 and "SS" in v.domain
    codes = v.to_numpy()
    assert codes[0] == codes[1] == v.domain.index("A")
    trim = ti.rapids_exec("(trim rc)", device="cpu").vecs[0]
    assert trim.to_numpy()[2] == trim.domain.index("b")


def test_string_op_on_numbers_raises(pub):
    for run in (lambda e: both(e)[0], lambda e: ti.rapids_exec(
            e, device="cpu")):
        with pytest.raises(TypeError, match="string op on a numeric"):
            run("(toupper rn)")


# ------------------------------------------------------------ time parts

TIME_OPS = ["year", "month", "day", "dayOfWeek", "hour", "minute", "second",
            "week"]


@pytest.mark.parametrize("op", TIME_OPS)
def test_time_part(pub, op):
    ref, port = both(f"({op} rt)")
    same(port, ref)


def test_week_is_the_reference_dispatch(pub):
    """``week`` is ``(day of year) // 7 + 1``: 1 on 2021-01-01, where
    the ISO week is 53; 2020-01-15 (test_rapids_round3) is week 3."""
    import datetime
    got = ti.rapids_exec("(week rt)", device="cpu").vecs[0].to_numpy()
    assert got[2] == 1.0
    assert datetime.date(2021, 1, 1).isocalendar()[1] == 53
    assert got[1] == 53.0 and got[0] == 9.0       # 2020-12-31, 2020-02-29
    assert np.isnan(got[4])
    dkv().put("r3k", TFrame(["t"], [TVec(np.asarray(
        _ms("2020-01-15"), np.float64), T_TIME)]))
    assert ti.rapids_exec("(week r3k)", device="cpu").vecs[0].to_numpy()[
        0] == 3.0


def test_time_parts_of_a_float32_payload(frames):
    """test_rapids_munge's case: a time column given as float32 ms."""
    ms = np.asarray(_ms("2021-03-04T05:06:07"), np.float32)
    ref, port = pair({"t": (T_TIME, ms, None)})
    publish("rD", ref, port)
    try:
        for op in ("year", "month", "day", "hour"):
            r, p = both(f"({op} rD)")
            same(p, r)
        assert p.vecs[0].to_numpy()[0] == 5
    finally:
        unpublish_ref("rD")


# ----------------------------------------------------------------- dates

DATE_EXPRS = [
    "(as.Date rd 'yyyy-MM-dd')", "(as.Date rdc 'yyyy-MM-dd')",
    "(as.Date rt 'yyyy-MM-dd')", "(as.Date rn 'yyyy-MM-dd')",
    "(as.Date rdt 'yyyy-MM-dd HH:mm:ss')", "(as.Date rd 'dd/MM/yy')",
    "(year (as.Date rdc 'yyyy-MM-dd'))",
    "(mktime 2020 0 0 0 0 0 0)", "(mktime 2020 1 28 12 30 15 250)",
    "(mktime 2021 1 28 0 0 0 0)", "(mktime 1969 6 19 20 17 40 0)",
    "(moment 2020 1 1 0 0 0 0)", "(moment 2020 2 29 0 0 0 0)",
    "(moment 2021 2 29 0 0 0 0)", "(moment 1969 7 20 20 17 40 0)",
    "(mktime (cols rm 'y') (cols rm 'm') (cols rm 'd') 0 0 0 0)",
    "(moment (cols rm 'y') 3 (cols rm 'd') 1 2 3 4)"]


@pytest.mark.parametrize("expr", DATE_EXPRS)
def test_dates(pub, expr):
    ref, port = both(expr)
    same(port, ref)
    v = port.vecs[0]
    if "as.Date" in expr and not expr.startswith("(year"):
        assert v.type == T_TIME and v.host_f64 is not None


def test_date_values(pub):
    """test_rapids_extended's claims: mktime's month and day 0-based,
    moment's 1-based; a bad or out-of-range date is NaN."""
    for expr in ("(mktime 2020 0 0 0 0 0 0)", "(moment 2020 1 1 0 0 0 0)"):
        v = ti.rapids_exec(expr, device="cpu").vecs[0].to_numpy()
        assert v[0] == 1577836800000.0
    d = ti.rapids_exec("(as.Date rd 'yyyy-MM-dd')",
                       device="cpu").vecs[0].to_numpy()
    assert d[0] == _ms("2020-02-29")[0] and d[6] < 0
    assert np.isnan(d[[3, 4, 5, 7, 8]]).all()


# ------------------------------------------------------- grep and friends

GREP_EXPRS = ["(grep {f} 'a' 0 0 0)", "(grep {f} 'a' 1 0 0)",
              "(grep {f} 'a' 0 1 1)", "(grep {f} '^h' 1 0 1)",
              "(grep {f} 'item_[0-3]' 0 0 1)"]


@pytest.mark.parametrize("f", ["rs", "rc"])
@pytest.mark.parametrize("expr", GREP_EXPRS)
def test_grep(pub, expr, f):
    ref, port = both(expr.format(f=f))
    same(port, ref)


@pytest.mark.parametrize("expr", [
    "(strlen rs)", "(strlen rc)", "(strlen rsc)", "(as.character rs)",
    "(as.character rc)", "(as.character rn)", "(as.character rt)",
    "(as.character rm)", "(is.character rsc)", "(is.character rn)"])
def test_text_ops(pub, expr):
    ref, port = both(expr)
    same(port, ref)


def test_as_character_of_float32_cells(pub):
    """A float32 cell goes through ``float()``: 0.1 is
    '0.10000000149011612', -0.0 is '0', NaN is None."""
    got = ti.rapids_exec("(as.character rn)", device="cpu").vecs[0]
    assert got.type == T_STR
    assert got.host_data[:5] == ["0.10000000149011612", "0", "0",
                                 "10000000000", None]
    assert got.host_data[7] == "inf"


@pytest.mark.parametrize("measure", ["lv", "lcs", "jaccard", "levenshtein"])
@pytest.mark.parametrize("empty", ["True", "False"])
def test_str_distance(pub, measure, empty):
    ref, port = both(f'(strDistance ra rb "{measure}" {empty})')
    same(port, ref)


def test_str_distance_refuses_a_measure(pub):
    for run in (lambda e: both(e)[0], lambda e: ti.rapids_exec(
            e, device="cpu")):
        with pytest.raises(ValueError, match="not supported"):
            run('(strDistance ra rb "cosine" True)')


@pytest.mark.parametrize("expr", ["(tokenize rsc ' ')", "(tokenize rs '-')",
                                  "(tokenize rc 'a')", "(tokenize ra 'a')"])
def test_tokenize(pub, expr):
    ref, port = both(expr)
    same(port, ref)
    words = port.vecs[0].host_data
    assert words.count(None) == ti._as_frame(dkv().get(
        expr.split()[1])).nrows


def test_round3_text_cases(frames):
    """test_rapids_round3's strDistance, tokenize and as.character
    cases on its own frames."""
    keys = {"r3e": {"s": (T_STR, ["aaaa", "abab", None], None)},
            "r3f": {"t": (T_STR, ["aaba", "abab", "x"], None)},
            "r3b": {"g": (T_CAT, [0, 1, 0], ["lo", "hi"])}}
    for k, cols in keys.items():
        publish(k, *pair(cols))
    try:
        for expr in ('(strDistance r3e r3f "lv" False)', '(tokenize r3e "a")',
                     "(as.character r3b)"):
            ref, port = both(expr)
            same(port, ref)
        assert both("(is.character r3b)")[1] == [0.0]
    finally:
        unpublish_ref(*keys)


def test_num_valid_substrings(pub, tmp_path):
    words = tmp_path / "words.txt"
    words.write_text("cat\nat\na\n\nHello\n b \n")
    for f in ("rs", "rc", "rsc"):
        ref, port = both(f'(num_valid_substrings {f} "{words}")')
        same(port, ref)
    publish("r3l", *pair({"s": (T_STR, ["cat"], None)}))
    try:
        got = ti.rapids_exec(f'(num_valid_substrings r3l "{words}")',
                             device="cpu")
        assert got.vecs[0].to_numpy()[0] == 3.0     # a, at and cat
    finally:
        unpublish_ref("r3l")


@pytest.mark.parametrize("flags", ["True True", "True False", "False True",
                                   "False False"])
def test_tf_idf(frames, flags):
    """test_xgb_extras's documents, and a second set with case, repeats,
    an empty and an NA text."""
    publish("tfidf_in", *pair({
        "doc": (T_NUM, [0, 1, 2], None),
        "text": (T_STR, ["cat dog cat", "dog fish", "cat"], None)}))
    publish("tfidf_2", *pair({
        "doc": (T_NUM, [3, 1, 3, 2, 1, 5], None),
        "text": (T_STR, ["The cat the", "", "CAT Dog", None, "dog  dog",
                         "the"], None)}))
    try:
        for key in ("tfidf_in", "tfidf_2"):
            ref, port = both(f"(tf-idf {key} 0 1 {flags})")
            same(port, ref)
        assert port.names == ["DocID", "Word", "TF", "IDF", "TF_IDF"]
    finally:
        unpublish_ref("tfidf_in", "tfidf_2")


# -------------------------------------------------------------- timezones


def test_timezone_ops(cl, monkeypatch):
    """test_time_precision's case: getTimeZone is "UTC" until set,
    setTimeZone sets and returns the zone, an unknown zone raises the
    reference's message; listTimeZones equal."""
    from h2o_tpu.core.cloud import cloud
    from h2o_tpu.rapids.interp import Session, rapids_exec
    monkeypatch.setattr(tdevice, "_timezone", None)
    old = getattr(cloud(), "timezone", None)
    cloud().timezone = None
    rs, ps = Session("tz_r"), ti.Session("tz_p", device="cpu")
    try:
        assert rapids_exec("(getTimeZone)", rs) == "UTC" == \
            ti.rapids_exec("(getTimeZone)", ps)
        for run, s in ((rapids_exec, rs), (ti.rapids_exec, ps)):
            assert run('(setTimeZone "America/New_York")', s) == \
                "America/New_York"
            assert run("(getTimeZone)", s) == "America/New_York"
            with pytest.raises(ValueError, match="Unacceptable timezone "
                               "Mars/Olympus given.  For a list of "
                               "acceptable names, use listTimezone()"):
                run('(setTimeZone "Mars/Olympus")', s)
        assert tdevice.timezone() == "America/New_York"
        same(ti.rapids_exec("(listTimeZones)", ps),
             rapids_exec("(listTimeZones)", rs))
    finally:
        cloud().timezone = old


def test_host_ops_move_nothing(pub, tmp_path):
    """The string, time, date and text ops run on the host."""
    words = tmp_path / "w.txt"
    words.write_text("a\n")
    exprs = [e.format(f="rsc" if "{f}" in e and "strsplit" not in e
                      else "rs") for e in STR_EXPRS] + \
        [f"({op} rt)" for op in TIME_OPS] + DATE_EXPRS + \
        ["(grep rc 'a' 0 0 0)", "(strlen rsc)", "(as.character rn)",
         "(is.character rsc)", '(strDistance ra rb "lv" True)',
         "(tokenize rsc ' ')", f'(num_valid_substrings rs "{words}")',
         "(listTimeZones)", "(getTimeZone)"]
    TransferStats.reset()
    for e in exprs:
        ti.rapids_exec(e, device="cpu")
    moved = TransferStats.snapshot()
    assert moved["to_device"] == 0 and moved["to_host"] == 0, moved


def test_the_later_ops_and_the_op_names():
    """P12c-ii-a's 45 ops and P12c-ii-b's 44 are dispatched; none is
    refused any more."""
    ported = set(ti._STROPS) | set(ti._TIME_PARTS) | set(ti._EXTRA_OPS)
    assert len(ported) == 45 + 44 and not hasattr(ti, "_LATER")
    assert ported <= set(ti.op_names())


# -------------------------------------------------------------- model ops


def _np(out):
    return {k: (np.asarray(v) if hasattr(v, "shape") else v)
            for k, v in out.items()}


def _carry(jm, conv):
    """The port's model of reference model ``jm`` under its key, with
    its training time."""
    pm = conv(_np(jm.output), dict(jm.params, model_id=str(jm.key)),
              device="cpu")
    pm.run_time_ms = getattr(jm, "run_time_ms", 0)
    return pm


def _model_frames(seed=5, n=600):
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 3, n).astype(np.int32)
    g[rng.uniform(size=n) < 0.03] = -1
    x1 = rng.normal(size=n).astype(np.float32)
    x2 = rng.normal(size=n).astype(np.float32)
    x1[rng.uniform(size=n) < 0.05] = np.nan
    logit = np.nan_to_num(x1) + (g == 1) * 0.8 - 0.3 * x2
    y = (logit + rng.normal(size=n) * 0.7 > 0.3).astype(np.int32)
    return pair({"x1": (T_NUM, x1, None), "x2": (T_NUM, x2, None),
                 "grp": (T_CAT, g, ["g0", "g1", "g2"]),
                 "y": (T_CAT, y, ["no", "yes"])})


@pytest.fixture(scope="module")
def models(cl):
    """Reference GBM, GLM, RuleFit and Word2Vec models, each carried to
    the port by its converter; the frames they read; segment model
    collections built alike in both packages."""
    from h2o_tpu.models.glm import GLM as JGLM
    from h2o_tpu.models.rulefit import RuleFit as JRuleFit
    from h2o_tpu.models.segment import SegmentModels as JSegmentModels
    from h2o_tpu.models.tree.gbm import GBM as JGBM
    from h2o_tpu.models.word2vec import Word2Vec as JWord2Vec
    from h2o_tpu_torch.models.glm import glm_from_jax_output
    from h2o_tpu_torch.models.rulefit import rulefit_from_jax_output
    from h2o_tpu_torch.models.segment import SegmentModels
    from h2o_tpu_torch.models.tree.convert import gbm_from_jax_output
    from h2o_tpu_torch.models.word2vec import word2vec_from_jax_output
    jf, pf = _model_frames()
    gbm = JGBM(ntrees=8, max_depth=3, seed=1, model_id="rs_gbm").train(
        y="y", training_frame=jf)
    glm = JGLM(family="binomial", model_id="rs_glm").train(
        x=["x2", "grp"], y="y", training_frame=jf)
    rf = JRuleFit(max_num_rules=8, seed=1, model_id="rs_rulefit").train(
        y="y", training_frame=jf)
    toks = (["apple", "pie", None, "cherry", "pie", "apple", None] * 20)
    w2v = JWord2Vec(vec_size=4, epochs=1, min_word_freq=1,
                    model_id="rs_w2v").train(
        training_frame=pair({"txt": (T_STR, toks, None)})[0])
    carried = {"rs_gbm": _carry(gbm, gbm_from_jax_output),
               "rs_glm": _carry(glm, glm_from_jax_output),
               "rs_rulefit": _carry(rf, rulefit_from_jax_output),
               "rs_w2v": _carry(w2v, word2vec_from_jax_output)}
    for k in ("rs_gbm", "rs_glm"):
        # the converters carry no metrics: the training metrics the
        # leaderboard ranks by, scored by the carried model
        carried[k].output["training_metrics"] = \
            carried[k].model_metrics(pf)
    segs = []
    for cls in (JSegmentModels, SegmentModels):
        sm = cls("rs_segments", ["grp"])
        sm.rows = [{"segment": {"grp": lv}, "model_id": mid,
                    "status": st, "errors": err, "warnings": ""}
                   for lv, mid, st, err in (
                       ("g0", "m_g0", "SUCCEEDED", ""),
                       ("g2", None, "FAILED", "empty segment"),
                       ("g1", "m_g1", "SUCCEEDED", ""))]
        segs.append(sm)
    refs = {"rs_gbm": gbm, "rs_glm": glm, "rs_rulefit": rf, "rs_w2v": w2v}
    jpred = gbm.predict(jf)
    ppred = TFrame(list(jpred.names), [
        TVec(np.asarray(v.to_numpy())[: jf.nrows].astype(
            np.int32 if v.is_categorical else np.float32), v.type,
             domain=v.domain) for v in jpred.vecs])
    return dict(jf=jf, pf=pf, refs=refs, carried=carried, segs=segs,
                jpred=jpred, ppred=ppred)


@pytest.fixture()
def mpub(models):
    """The models and frames under one key in both DKVs."""
    from h2o_tpu.core.cloud import cloud
    m = models
    for k in m["refs"]:
        cloud().dkv.put(k, m["refs"][k])
        dkv().put(k, m["carried"][k])
    cloud().dkv.put("rs_segments", m["segs"][0])
    dkv().put("rs_segments", m["segs"][1])
    publish("rsm", m["jf"], m["pf"])
    publish("rsm_pred", m["jpred"], m["ppred"])
    yield m
    unpublish_ref("rsm", "rsm_pred", "rs_segments", *m["refs"])


def close(port, ref, tol=MODEL_TOL, skip=()):
    """Frames with equal names, types, domains and codes, and numeric
    columns within ``tol`` of the reference's (relative to 1 or |x|)."""
    assert port.names == ref.names and port.nrows == ref.nrows
    worst = 0.0
    for n, vp, vr in zip(port.names, port.vecs, ref.vecs):
        assert vp.type == vr.type and (vp.domain or None) == \
            (vr.domain or None), n
        if n in skip:
            continue
        p = np.asarray(vp.to_numpy(), np.float64)
        r = np.asarray(vr.to_numpy(), np.float64)[: ref.nrows]
        if vp.is_categorical:
            assert np.array_equal(p, r), n
            continue
        assert np.array_equal(np.isnan(p), np.isnan(r)), n
        ok = ~np.isnan(r)
        d = np.abs(p[ok] - r[ok]) / np.maximum(1.0, np.abs(r[ok]))
        worst = max(worst, float(d.max()) if d.size else 0.0)
        assert (d <= tol).all(), (n, p[ok], r[ok])
    return worst


def test_reset_threshold(mpub):
    """The old threshold back, the new one in each model (and restored);
    the carried GBM's labels move with it as the reference's do."""
    jm, pm = mpub["refs"]["rs_gbm"], mpub["carried"]["rs_gbm"]
    try:
        ref, port = both("(model.reset.threshold rs_gbm 0.9)")
        same(port, ref)
        assert pm.output["default_threshold"] == 0.9 == \
            jm.output["default_threshold"]
        lab = pm.predict_raw(mpub["pf"])[:, 0].numpy()
        jlab = np.asarray(jm.predict_raw(mpub["jf"]))[: len(lab), 0]
        assert np.array_equal(lab, jlab)
        for run in (lambda e: both(e)[0], lambda e: ti.rapids_exec(
                e, device="cpu")):
            with pytest.raises(ValueError, match="threshold must be in"):
                run("(model.reset.threshold rs_gbm 1.5)")
    finally:
        pm.output["default_threshold"] = 0.5
        jm.output["default_threshold"] = 0.5


def test_model_lookup_refuses_a_missing_key(mpub):
    for run in (lambda e: both(e)[0], lambda e: ti.rapids_exec(
            e, device="cpu")):
        with pytest.raises(ValueError, match="model 'nope' not found"):
            run("(model.reset.threshold nope 0.4)")


@pytest.mark.parametrize("expr", [
    "(word2vec.to.frame rs_w2v)", "(segment_models_as_frame rs_segments)",
    "(predicted.vs.actual.by.var rs_gbm rsm 'grp' rsm_pred)",
    "(isax (cols rsm [0 1]) 2 4 False)"])
def test_model_frames_bitwise(mpub, expr):
    ref, port = both(expr)
    same(port, ref)


def test_isax(frames):
    """test_rapids_round3's two shape families, and NaN cells."""
    rng = np.random.default_rng(1)
    n, C = 20, 32
    base = np.sin(np.linspace(0, 4 * np.pi, C))
    X = np.stack([base + rng.normal(size=C) * 0.05 for _ in range(n)] +
                 [-base + rng.normal(size=C) * 0.05 for _ in range(n)])
    X[3, 5] = np.nan
    publish("r3s", *pair({f"c{j}": (T_NUM, X[:, j], None)
                          for j in range(C)}))
    try:
        for expr in ("(isax r3s 4 8 False)", "(isax r3s 7 3 False)"):
            ref, port = both(expr)
            same(port, ref)
        for run in (lambda e: both(e)[0], lambda e: ti.rapids_exec(
                e, device="cpu")):
            with pytest.raises(NotImplementedError, match="optimize_card"):
                run("(isax r3s 4 8 True)")
    finally:
        unpublish_ref("r3s")


def test_rulefit_predict_rules(mpub):
    rows = mpub["refs"]["rs_rulefit"].output["rule_importance"]
    ids = [str(r[0]) for r in rows if not str(r[0]).startswith("linear")]
    assert ids
    ref, port = both("(rulefit.predict.rules rs_rulefit rsm [{}])".format(
        ", ".join(f'"{i}"' for i in ids)))
    same(port, ref)
    vals = port.vecs[0].to_numpy()
    assert set(np.unique(vals)) <= {0.0, 1.0}
    with pytest.raises(ValueError, match="unknown rule id"):
        ti.rapids_exec('(rulefit.predict.rules rs_rulefit rsm ["zz"])',
                       device="cpu")


@pytest.mark.parametrize("expr", [
    '(fairnessMetrics rs_gbm rsm ["grp"] ["g0"] "yes")',
    '(fairnessMetrics rs_gbm rsm ["grp"] ["g1"] "no")',
    '(fairnessMetrics rs_glm rsm ["grp"] [] "yes")'])
def test_fairness_metrics(mpub, expr):
    """Counts equal; rates within ``MODEL_TOL``; the reference group's
    AIR is 1."""
    ref, port = both(expr)
    close(port, ref)
    for k in ("total", "tp", "fp", "fn", "tn"):
        assert np.array_equal(port.vec(k).to_numpy(),
                              np.asarray(ref.vec(k).to_numpy())), k


@pytest.mark.parametrize("expr", [
    '(PermutationVarImp rs_gbm rsm "AUTO" -1 1 None 42)',
    '(PermutationVarImp rs_gbm rsm "logloss" 300 1 ["x1", "grp"] 7)',
    '(PermutationVarImp rs_glm rsm "AUC" -1 3 None 3)'])
def test_permutation_varimp(mpub, expr):
    ref, port = both(expr)
    close(port, ref)
    if "-1 1" in expr:
        dom = port.vecs[0].domain
        rel = port.vec("Relative Importance").to_numpy()
        assert rel[dom.index("x1")] > rel[dom.index("x2")]


@pytest.mark.parametrize("tail", ['"rsm" "AUTO" "ALL" "AUTO"',
                                  '"rsm" "logloss" [] "AUTO"',
                                  '"" "AUTO" ["algo"] "train"'])
def test_make_leaderboard(mpub, tail):
    ref, port = both(f'(makeLeaderboard ["rs_gbm", "rs_glm"] {tail})')
    close(port, ref, skip=("predict_time_per_row_ms",))
    if "ALL" in tail:
        t = port.vec("predict_time_per_row_ms").to_numpy()
        assert np.isfinite(t).all() and (t > 0).all()
        same(port.subframe(["training_time_ms"]),
             ref.subframe(["training_time_ms"]))


@pytest.mark.parametrize("src", ["[1, 2:4, 'a', \"b c\"]", "[0.5 -2]",
                                 "'solo'", "[]", "[3:2]"])
def test_list_helpers(src):
    """``_mixed_list`` and ``_numlist_vals`` read a bracket list as the
    reference's do (a span ``lo:hi`` inclusive there)."""
    from h2o_tpu.rapids import interp as ri
    node = ti.parse(src)
    assert ti._mixed_list(node, None) == ri._mixed_list(node, None)
    nums = [x for x in ri._mixed_list(node, None)
            if not isinstance(x, str)]
    if len(nums) == len(ri._mixed_list(node, None)):
        assert ti._numlist_vals(node, None) == ri._numlist_vals(node, None)
