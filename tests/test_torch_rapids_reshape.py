"""``h2o_tpu_torch.rapids``' reshaping, row, level and domain ops against
``h2o_tpu.rapids`` (ROADMAP P12c-ii-b): ``fillna``, ``dropdup``,
``distance``, ``melt``, ``pivot``, ``rank_within_groupby``, ``difflag1``,
``t``, ``rep_len``, ``getrow``, ``flatten``, ``setLevel``, ``relevel``,
``cut``, ``setDomain``, ``appendLevels``, ``relevel.by.freq``, ``match``,
``any.factor``, ``any.na``, ``columnsByType``, ``filterNACols`` and
``ls``.

The frames and the harness are ``tests/test_torch_rapids_stats.py``'s
(the edge frame's +-inf, +-1e30, +-0, keys of 0, -0, NaN and inf, the
all-NaN and constant columns, the one-row frame and the empty filter
result), with the wire forms of ``tests/test_rapids_extended.py`` and
``test_rapids_round3.py`` on their own frames.  Every answer is held
bitwise, and every op moves no byte to or from a device.  The
reference's ``rank_within_groupby`` sorts its answer through its device
take, whose mesh collective returns -0.0 as 0.0, so that one case is
compared without the sign of zero.

``fillna``, ``dropdup``, ``pivot``, ``rank_within_groupby`` and
``match`` are whole-array steps in the port where the reference loops
over rows: the cases include runs of NAs longer and shorter than
``maxlen`` on both axes and in both directions, repeated (index, column)
pairs, and ties.
"""

import numpy as np
import pytest

from h2o_tpu_torch.core.frame import T_CAT, T_NUM, T_STR, T_TIME
from h2o_tpu_torch.core.store import dkv, unpublish_on_exit
from h2o_tpu_torch.rapids import interp as ti

from tests.test_torch_rapids_interp import pair, publish, unpublish_ref
from tests.test_torch_rapids_stats import (EMPTY, check, frames,  # noqa: F401
                                           host)

NAN, INF = np.nan, np.inf

pytestmark = pytest.mark.shared_dkv


@pytest.fixture(autouse=True)
def _unpublish():
    """What a test publishes in the port's DKV is removed after it."""
    with unpublish_on_exit():
        yield


def runs_cols(seed: int = 17, n: int = 400) -> dict:
    """Columns with runs of NAs of every length up to 7 between values,
    a leading and a trailing run, +-inf and -0.0 among the values, and a
    categorical whose NA code -1 is a value to ``fillna``."""
    rng = np.random.default_rng(seed)
    out = {}
    for j in range(4):
        x = rng.normal(size=n).astype(np.float32)
        x[rng.integers(0, n, 12)] = [INF, -INF, -0.0, 0.0] * 3
        k = 0
        while k < n:
            run = int(rng.integers(0, 8))
            x[k: k + run] = NAN
            k += run + int(rng.integers(1, 4))
        x[:3] = NAN
        out[f"r{j}"] = (T_NUM, x, None)
    out["rc"] = (T_CAT, rng.integers(-1, 3, n), ["p", "q", "r"])
    return out


LOCAL = {
    # test_rapids_extended's frames
    "hfill": {"x": (T_NUM, [1.0, NAN, NAN, 4.0, NAN], None)},
    "hdd": {"a": (T_NUM, [1, 1, 2, 2, 3], None),
            "b": (T_NUM, [9, 9, 8, 7, 6], None)},
    "hx": {"c1": (T_NUM, [0.0, 1.0], None), "c2": (T_NUM, [0.0, 0.0], None)},
    "hy": {"c1": (T_NUM, [0.0, 3.0], None), "c2": (T_NUM, [0.0, 4.0], None)},
    "hmp": {"id": (T_NUM, [1, 2], None), "p": (T_NUM, [10.0, 20.0], None),
            "q": (T_NUM, [30.0, 40.0], None)},
    "hrk": {"g": (T_NUM, [0, 0, 0, 1, 1], None),
            "v": (T_NUM, [3.0, 1.0, 2.0, 5.0, 4.0], None)},
    # test_rapids_round3's frames
    "h3c": {"g": (T_CAT, [0, 1, 2, -1], ["a", "b", "c"])},
    "h3d": {"v": (T_NUM, [0.5, 1.5, 2.5, NAN], None)},
    "h3g": {"a": (T_NUM, [1, 2], None), "b": (T_NUM, [3, 4], None)},
    "h3h": {"g": (T_CAT, [0, 1, 1, 1], ["x", "y"])},
    "h3i": {"n": (T_NUM, [1.0, NAN], None),
            "g": (T_CAT, [0, 1], ["u", "v"])},
    "h3j": {"z": (T_NUM, [42.0], None)},
    # NA runs; repeated pivot cells; ties and NA keys for ranks; weights
    "hruns": runs_cols(),
    "hpv": {"i": (T_NUM, [1, 2, 1, 1, NAN, 2, 3, 1, -0.0, 0.0, 2, 3],
                  None),
            "c": (T_CAT, [0, 1, 0, 2, 1, -1, 0, 1, 2, 2, 1, 0],
                  ["u", "v", "w"]),
            "n": (T_NUM, [5, 7, 5, 5, 7, NAN, 1e30, 7, -0.0, INF, 7, 5],
                  None),
            "val": (T_NUM, [1.5, 2.5, -3.0, 4.0, 5.0, 6.0, 7.0, 8.0, 9.0,
                            -0.0, INF, NAN], None)},
    "hw": {"g": (T_CAT, [0, 1, 2, 1, -1, 2, 2, 3, 1, 0],
                 ["a", "b", "c", "d"]),
           "w": (T_NUM, [0.5, 2.0, 0.25, 1.5, 9.0, 0.125, 0.5, 4.0, 0.75,
                         1.0], None),
           "h": (T_CAT, [0, 0, 0, 1, 1, 1, 1, 1, 1, 0], ["m", "n"])},
    "htime": {"t": (T_TIME, [1.6e12, 1.6e12 + 1, NAN, 1.7e12, -5.0],
                    None),
              "x": (T_NUM, [1, 2, 3, 4, 5], None)},
}


@pytest.fixture(scope="module")
def local(frames):
    from h2o_tpu.rapids.interp import Session, rapids_exec
    for key, cols in LOCAL.items():
        publish(key, *pair(cols))
    derived = {"hmelt": "(melt hmp ['id'] ['p', 'q'] 'variable' 'value' "
                        "False)",
               "hmelt_all": "(melt hpv ['i', 'c'] [] 'var' 'val' True)"}
    for key, expr in derived.items():
        rapids_exec(f"(tmp= {key} {expr})", Session("_ref"))
        ti.rapids_exec(f"(tmp= {key} {expr})", device="cpu")
    yield
    unpublish_ref(*LOCAL, *derived)
    for key in (*LOCAL, *derived):
        dkv().remove(key, force=True)


# ------------------------------------------------------------- fill and rows

FILLS = [f"({op} {f} {m} {axis} {n})"
         for op in ("h2o.fillna",)
         for f in ("hruns", "se", "sn")
         for m in ("'forward'", "'backward'")
         for axis in (0, 1)
         for n in (0, 1, 3, 100)] + [
    "(fillna hruns \"forward\" 0 2)", "(fillna hruns \"Backward\" 1 1)",
    "(h2o.fillna hfill 'forward' 0 1)", "(h2o.fillna s1 'forward' 0 1)",
    f"(h2o.fillna {EMPTY} 'forward' 0 1)", "(h2o.fillna sx 'forward' 0 1)",
    "(h2o.fillna (cols sx [0 1 2 3 4 5]) 'forward' 0 3)",
    "(h2o.fillna hruns 'forward' 0 -1)"]


@pytest.mark.parametrize("expr", FILLS)
def test_fillna(local, expr):
    host(expr)


def test_fillna_extended_claim(local):
    """test_rapids_extended: a run of one NA is filled at maxlen 1, a run
    of two is left."""
    vals = host("(h2o.fillna hfill 'forward' 0 1)").vecs[0].to_numpy()
    assert vals[1] == 1.0 and np.isnan(vals[2]) and vals[3] == 4.0


ROWS = [
    "(dropdup hdd ['a'] 'first')", "(dropdup hdd ['a'] 'last')",
    "(dropdup hdd [0 1] 'first')", "(dropdup hdd [1] ' Last ')",
    "(dropdup se ['k'] 'first')", "(dropdup se ['k'] 'last')",
    "(dropdup se [1 5] 'first')", "(dropdup se ['c', 'k'] 'last')",
    "(dropdup sx [3 4] 'first')", "(dropdup sx ['t'] 'last')",
    "(dropdup sext ['grp'] 'first')", "(dropdup s1 [0] 'first')",
    f"(dropdup {EMPTY} [0] 'first')", "(dropdup hpv ['i', 'c'] 'last')",
    "(distance hx hy 'l2')", "(distance hx hy 'euclidean')",
    "(distance hx hy 'l1')", "(distance hy hx 'manhattan')",
    "(distance hx hy 'cosine')", "(distance hx hy 'cosine_sq')",
    "(distance (cols sx [0 1 2]) (cols sx [2 3 0]) 'l2')",
    "(distance (cols sx [0 2]) (cols sext ['num', 'pos']) 'l1')",
    "(distance (cols sn [2 3]) (cols sn [2 3]) 'cosine')",
    "(distance (cols se ['v', 'g']) (cols se ['g', 'const']) 'l2')",
    "(distance (cols se ['g', 'const']) (cols s1 ['g', 'const']) 'cosine')",
    "(distance hx hy 'chebyshev')",
    "(difflag1 sn)", "(difflag1 se)", "(difflag1 s1)", "(difflag1 htime)",
    f"(difflag1 {EMPTY})", "(t sn)", "(t se)", "(t s1)", "(t h3g)",
    "(t htime)", "(rep_len h3g 5)", "(rep_len (cols sx 'c') 7)",
    "(rep_len (cols htime 't') 12)", "(rep_len 3.5 4)", "(rep_len s1 3)",
    "(rep_len sn 0)", "(rep_len -0 2)",
    "(getrow s1)", "(getrow h3j)", "(getrow sn)", "(flatten h3j)",
    "(flatten s1)", "(flatten 3)", "(flatten (cols sstr 's'))",
    "(flatten (cols sstr 'f'))", "(flatten (cols h3c 'g'))",
    "(flatten (rows_py h3c 3))",
]


@pytest.mark.parametrize("expr", ROWS)
def test_rows_and_matrices(local, expr):
    """``flatten`` of ``(rows_py h3c 3)`` reads a categorical NA; the
    row selection runs before the op, so only the answer is held."""
    if "rows_py" in expr:
        check(expr)
    else:
        host(expr)


def test_extended_and_round3_claims(local):
    """test_rapids_extended's dropdup, distance, melt/pivot and rank
    claims, and test_rapids_round3's t/rep_len/getrow/flatten ones."""
    assert host("(dropdup hdd ['a'] 'first')").nrows == 3
    d = host("(distance hx hy 'l2')")
    assert d.vecs[0].to_numpy()[0] == 0.0 and d.vecs[1].to_numpy()[0] == 5.0
    m = dkv().get("hmelt")
    assert m.nrows == 4 and set(m.vec("variable").domain) == {"p", "q"}
    p = host("(pivot hmelt ['id'] ['variable'] ['value'])")
    assert p.names == ["id", "p", "q"] and p.nrows == 2
    assert list(p.vec("p").to_numpy()) == [10.0, 20.0]
    assert list(p.vec("q").to_numpy()) == [30.0, 40.0]
    r = host("(rank_within_groupby hrk ['g'] ['v'] [1] 'rk' 0)")
    assert list(r.vec("rk").to_numpy()) == [3, 1, 2, 2, 1]
    t = host("(t h3g)")
    assert t.nrows == 2 and t.vecs[0].to_numpy()[1] == 3.0
    assert list(host("(rep_len h3g 5)").vecs[0].to_numpy()) == [1, 2, 1, 2,
                                                                 1]
    assert host("(getrow h3j)") == [42.0] and host("(flatten h3j)") == 42.0


RESHAPE = [
    "(melt hmp ['id'] ['p', 'q'] 'variable' 'value' False)",
    "(melt hmp ['id'] [] 'variable' 'value' False)",
    "(melt hmp [0] [1 2] 'k' 'v' True)",
    "(melt hpv ['i', 'c'] [] 'var' 'val' True)",
    "(melt hpv ['c'] ['n', 'val'] 'var' 'val' False)",
    "(melt se ['c'] ['v', 'k', 'allnan'] 'variable' 'value' True)",
    "(melt htime ['t'] ['x'] 'variable' 'value' False)",
    "(melt s1 ['c'] [] 'variable' 'value' True)",
    "(pivot hmelt ['id'] ['variable'] ['value'])",
    "(pivot hmelt 'id' 'variable' 'value')",
    "(pivot hpv ['i'] ['c'] ['val'])", "(pivot hpv ['c'] ['i'] ['val'])",
    "(pivot hpv ['i'] ['n'] ['val'])", "(pivot hpv [2] [0] [3])",
    "(pivot hmelt_all ['i'] ['var'] ['val'])",
    "(pivot se ['c'] ['k'] ['g'])",
    "(rank_within_groupby hrk ['g'] ['v'] [1] 'rk' 0)",
    "(rank_within_groupby hrk ['g'] ['v'] [0] 'rk' 0)",
    "(rank_within_groupby hpv ['c'] ['n', 'val'] [1 0] 'rank' 0)",
    "(rank_within_groupby hpv ['i', 'c'] ['val'] [0] 'r' 0)",
    "(rank_within_groupby se ['k'] ['g'] [1] 'rank' 0)",
    "(rank_within_groupby se ['c'] ['v'] [0] 'rank' 0)",
    "(rank_within_groupby sx [3] [0 1] [1 1] 'rank' 0)",
    "(rank_within_groupby s1 ['c'] ['g'] [1] 'rank' 0)",
]


@pytest.mark.parametrize("expr", RESHAPE)
def test_melt_pivot_rank(local, expr):
    host(expr)


@pytest.mark.parametrize("expr", [
    "(rank_within_groupby hrk ['g'] ['v'] [1] 'rk' 1)",
    "(rank_within_groupby hpv ['c'] ['n', 'val'] [1 0] 'rank' 1)",
    "(rank_within_groupby se ['k'] ['g'] [1] 'rank' 1)"])
def test_rank_final_sort(local, expr):
    """The reference sorts through its device take (-0.0 comes back 0.0
    there); the port gathers on the host."""
    port, moved = check(expr, zero_sign=False)
    assert moved == {"to_device": 0, "to_host": 0}


# ------------------------------------------------------- levels and domains

LEVELS = [
    "(setLevel (cols sext 'grp') 'b')", "(setLevel h3c 'c')",
    "(setLevel (cols se 'c') 'a')", "(setLevel s1 'a')",
    "(relevel (cols sext 'grp') 'c')", "(relevel h3c 'b')",
    "(relevel (cols se 'c') 'c')", "(relevel (cols hw 'g') 'd')",
    "(cut h3d [0, 1, 2, 3] [] True True 3)",
    "(cut h3d [0, 1, 2, 3] [] False True 3)",
    "(cut h3d [0, 1, 2, 3] [] True False 3)",
    "(cut h3d [0, 1, 2, 3] [] False False 2)",
    "(cut h3d [0, 1, 2, 3] ['lo', 'mid', 'hi'] True True 3)",
    "(cut (cols sx 'x') [-5 -2.5 0 0.333333 2.5 5] [] True True 3)",
    "(cut (cols sx 'x') [-5 -2.5 0 0.333333 2.5 5] [] False True 6)",
    "(cut (cols se 'v') [-1e30 -1 0 1 1e30] [] True True 3)",
    "(cut (cols se 'v') [-1e30 -1 -0 1 1e30] [] False False 3)",
    "(cut (cols se 'k') [0 1 2 3] [a b c] True True 3)",
    "(cut (cols htime 't') [0 1.65e12 2e12] [] True True 4)",
    f"(cut (cols {EMPTY} 'g') [0 1 2] [] True True 3)",
    "(setDomain h3h False ['XX', 'YY'])",
    "(setDomain h3h True ['XX', 'YY', 'ZZ'])",
    "(setDomain (cols se 'c') False ['A', 'B', 'C'])",
    "(appendLevels h3h False ['z'])", "(appendLevels h3h False ['y', 'z'])",
    "(appendLevels (cols se 'c') False ['c', 'd', 'a'])",
    "(relevel.by.freq h3h None -1)", "(relevel.by.freq hw None -1)",
    "(relevel.by.freq hw 'w' -1)", "(relevel.by.freq hw 'w' 1)",
    "(relevel.by.freq hw None 2)", "(relevel.by.freq hw 'w' 0)",
    "(relevel.by.freq hw 'w' 9)", "(relevel.by.freq se None 1)",
    "(relevel.by.freq sext None -1)",
    "(match h3c ['b', 'c'] NaN None)", "(match h3c ['c', 'b', 'c'] 0 None)",
    "(match (cols sstr 's') ['aaaa', '', 'ß', 'aaaa'] -1 None)",
    "(match (cols sstr 'f') ['', 'xyz'] NaN None)",
    "(match (cols se 'k') [0 2 0 1] NaN None)",
    "(match (cols se 'k') [-0 3 1] -5 None)",
    "(match (cols se 'v') [1e30 -1e30 1.5] NaN None)",
    "(match (cols sx 'k') [3 1 4 1 5 9] 0 None)",
    "(match (cols htime 't') [1.6e12 -5] NaN None)",
    f"(match (cols {EMPTY} 'k') [0] NaN None)",
]


@pytest.mark.parametrize("expr", LEVELS)
def test_levels_and_domains(local, expr):
    host(expr)


INTROSPECTION = [
    "(any.factor sx)", "(any.factor sn)", "(any.factor se)",
    "(any.factor h3g)", "(any.factor s1)", f"(any.factor {EMPTY})",
    "(any.na sx)", "(any.na sn)", "(any.na se)", "(any.na h3g)",
    "(any.na s1)", "(any.na (cols sstr 's'))", "(any.na (cols sstr 'f'))",
    f"(any.na {EMPTY})", "(any.na hw)",
] + [f"(columnsByType sx '{t}')" for t in (
    "numeric", "categorical", "string", "time", "uuid", "bad", "other")] + [
    "(columnsByType h3i 'numeric')", "(columnsByType h3i 'categorical')",
    "(columnsByType htime 'Time')",
] + [f"(filterNACols {f} {x})" for f in ("sx", "se", "h3i")
     for x in (0, 0.05, 0.4, 1)] + [f"(filterNACols {EMPTY} 0.5)"]


@pytest.mark.parametrize("expr", INTROSPECTION)
def test_introspection(local, expr):
    host(expr)


def test_round3_level_claims(local):
    """test_rapids_round3's domain, match, cut and introspection
    claims."""
    assert host("(setDomain h3h False ['XX', 'YY'])").vecs[0].domain == \
        ["XX", "YY"]
    assert host("(appendLevels h3h False ['z'])").vecs[0].domain == \
        ["x", "y", "z"]
    out = host("(relevel.by.freq h3h None -1)").vecs[0]
    assert out.domain[0] == "y" and list(out.to_numpy()) == [1, 0, 0, 0]
    got = host("(match h3c ['b', 'c'] NaN None)").vecs[0].to_numpy()
    assert np.isnan(got[0]) and got[1] == 1 and got[2] == 2
    v = host("(cut h3d [0, 1, 2, 3] [] True True 3)").vecs[0]
    assert v.is_categorical and len(v.domain) == 3
    assert list(v.to_numpy()) == [0, 1, 2, -1]
    assert host("(columnsByType h3i 'numeric')") == [0.0]
    assert host("(columnsByType h3i 'categorical')") == [1.0]
    assert host("(filterNACols h3i 0.4)") == [2.0]
    assert host("(relevel (cols sext 'grp') 'c')").vecs[0].domain[0] == "c"
    lv = host("(setLevel (cols sext 'grp') 'b')").vecs[0]
    assert set(lv.to_numpy()) == {1}


def test_ls_lists_each_store(local):
    """``ls`` is the sorted keys of the port's own DKV."""
    from h2o_tpu.rapids.interp import Session, rapids_exec
    ref = rapids_exec("(ls)", Session("_ref"))
    port = host_answer("(ls)")
    assert port.names == ref.names == ["key"]
    assert port.vecs[0].domain == sorted(str(k) for k in dkv().keys())
    assert list(port.vecs[0].to_numpy()) == list(range(len(dkv().keys())))
    assert {"h3i", "hw"} <= set(port.vecs[0].domain) & set(
        ref.vecs[0].domain)


def host_answer(expr: str):
    """The port's answer, and it moved nothing."""
    from h2o_tpu_torch.core.diag import TransferStats
    TransferStats.reset()
    out = ti.rapids_exec(expr, device="cpu")
    assert TransferStats.snapshot() == {"to_device": 0, "to_host": 0}
    return out


MALFORMED = [
    "(getrow sn)", "(setLevel (cols sx 'x') 'a')", "(setLevel h3c 'zz')",
    "(relevel h3c 'zz')", "(relevel (cols sx 'x') 'a')",
    "(cut h3d [0, 1, 2, 3] ['a', 'b'] True True 3)",
    "(setDomain h3h False ['XX'])", "(setDomain (cols sx 'x') False ['a'])",
    "(appendLevels (cols sx 'x') False ['a'])",
    "(distance hx hy 'chebyshev')", "(pivot hmelt ['nosuch'] [1] [2])",
    "(melt hmp ['nosuch'] [] 'v' 'w' False)",
    "(match (cols sx 'x') ['a'] NaN None)", "(h2o.fillna sx 'forward' 0 1)",
    "(dropdup sstr ['zz'] 'first')", "(flatten (rows sn [0:0]))",
]


@pytest.mark.parametrize("expr", MALFORMED)
def test_malformed_calls_raise_alike(local, expr):
    port, _moved = check(expr)
    assert port is None, f"{expr} did not raise"


def test_any_na_reads_strings_and_codes(local):
    """``any.na`` counts a None string and a -1 code as NA."""
    for key, cols, want in (
            ("hna1", {"s": (T_STR, ["a", None], None)}, 1.0),
            ("hna2", {"s": (T_STR, ["a", "b"], None)}, 0.0),
            ("hna3", {"c": (T_CAT, [0, -1], ["a"])}, 1.0)):
        publish(key, *pair(cols))
        try:
            assert host(f"(any.na {key})") == want
        finally:
            unpublish_ref(key)


@pytest.mark.parametrize("key,cols", [
    ("se", [1]), ("se", [5]), ("sx", [3]), ("sx", [4]), ("hpv", [0]),
    ("sempty", [1]), ("se", [1, 5]), ("se", [5, 1, 0]), ("sx", [3, 4]),
    ("hpv", [0, 1, 2]), ("hpv", [2, 0]), ("hruns", [4, 0]),
    ("sx", [5, 3])])
def test_group_codes_are_key_codes(local, key, cols):
    """The 1-d factorizations combined give ``_key_codes``' codes: keys
    of 0, -0, NaN, +-inf, categorical NA codes and times."""
    fr = dkv().get(key)
    assert np.array_equal(ti._group_codes(fr, cols),
                          ti._key_codes(fr, cols)[1])
