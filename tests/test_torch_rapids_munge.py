"""The Rapids munge ops of ``h2o_tpu_torch.rapids`` against
``h2o_tpu.rapids`` on both of their routes: sort, merge, group-by,
table, ``:=``, ``h2o.impute``, row selection and ``na.omit``.

``H2O_TPU_DEVICE_MUNGE`` is set for both packages at once: ``1`` sends
a frame the device verbs take to them (the reference's on its test
mesh, the port's ``core/munge.py`` on the CPU), ``0`` sends every frame
to the host routes.  A frame with a time or string column, a key pair
of mixed kinds, ``mode`` of a numeric column and negative row indices
take the host routes under either setting.  The cases are the
expressions of ``tests/test_rapids_munge.py`` and more, over seeded
frames with NaNs and categorical NAs.

Held: names, types, domains, row order, codes, keys and counts
bitwise; every group aggregate bitwise on values of a 1/8 grid (sums
exact in any order); min, max, median and mode bitwise on any values.
The reference's device verbs move rows through mesh collectives that
turn -0.0 into 0.0, so zeros are compared without their sign here.
Then: the route is chosen before a verb is called (the host routes
call no device verb; a device verb's error reaches the caller), and a
frame the device verbs refuse still raises by name when a verb is
called directly.
"""

import numpy as np
import pytest

from h2o_tpu_torch.core import munge as tm
from h2o_tpu_torch.core.diag import TransferStats
from h2o_tpu_torch.core.frame import T_CAT, T_NUM, T_STR, T_TIME
from h2o_tpu_torch.core.store import unpublish_on_exit
from h2o_tpu_torch.rapids import interp as ti
from tests.test_torch_rapids_interp import (both, mixed_cols, pair, publish,
                                            same, unpublish_ref)

ROUTES = ("device", "host")


@pytest.fixture(autouse=True)
def _unpublish():
    """What a test publishes in the port's DKV is removed after it."""
    with unpublish_on_exit():
        yield


@pytest.fixture()
def route(request, monkeypatch):
    monkeypatch.setenv("H2O_TPU_DEVICE_MUNGE",
                       "1" if request.param == "device" else "0")
    return request.param


def merge_cols(seed=11):
    """A left and a right frame: a categorical key whose domains differ
    in order and levels, a numeric key with NaN and repeats, payloads,
    a clashing name, and a categorical whose labels read as the numeric
    key's values."""
    rng = np.random.default_rng(seed)
    nl, nr = 120, 60
    lk = rng.integers(-1, 4, nl)
    ln = rng.integers(0, 12, nl).astype(np.float32)
    ln[rng.uniform(size=nl) < 0.1] = np.nan
    rk = rng.integers(-1, 4, nr)
    rn = rng.integers(3, 16, nr).astype(np.float32)
    rn[rng.uniform(size=nr) < 0.1] = np.nan
    left = {"kc": (T_CAT, lk, ["a", "b", "c", "d"]),
            "kn": (T_NUM, ln, None),
            "x": (T_NUM, (rng.integers(-16, 17, nl) / 8), None),
            "lid": (T_NUM, np.arange(nl), None)}
    right = {"kc": (T_CAT, rk, ["d", "zz", "b", "a"]),
             "kn": (T_NUM, rn, None),
             "rc": (T_CAT, rng.integers(-1, 3, nr), ["3.0", "5.0", "7.0"]),
             "x": (T_NUM, (rng.integers(-16, 17, nr) / 8), None),
             "rid": (T_NUM, np.arange(nr), None)}
    return left, right


@pytest.fixture()
def mframes(cl):
    """``mn`` (numeric and categorical: device-eligible), ``mt`` (with
    time and string columns), ``L``/``R`` to join and ``LT`` (``L`` with
    a time column) in both DKVs."""
    cols = mixed_cols(seed=3)
    rng = np.random.default_rng(5)
    cols["c2"] = (T_CAT, rng.integers(-1, 3, len(cols["x"][1])),
                  ["p", "q", "r"])
    num = {n: cols[n] for n in ("k", "g", "x", "y", "c", "c2")}
    publish("mn", *pair(num))
    publish("mt", *pair({n: cols[n] for n in ("k", "g", "x", "c", "s",
                                              "t")}))
    left, right = merge_cols()
    publish("L", *pair(left))
    publish("R", *pair(right))
    lt = dict(left)
    lt["t"] = (T_TIME, 1.6e12 + 6e4 * np.arange(len(left["lid"][1])), None)
    publish("LT", *pair(lt))
    yield
    unpublish_ref("mn", "mt", "L", "R", "LT")


def check(expr):
    ref, port = both(expr)
    same(port, ref, zero_sign=False)
    return port


SORTS = ["(sort mn [0] [1])", "(sort mn [0] [0])", "(sort mn [4 2] [1 0])",
         "(sort mn ['c' 'x'] [0 1])", "(sort mn [5 3])",
         "(sort mt [5] [1])", "(sort mt [5 0] [0 1])", "(sort mt [3] [0])"]


@pytest.mark.parametrize("route", ROUTES, indirect=True)
@pytest.mark.parametrize("expr", SORTS)
def test_sort(mframes, route, expr):
    check(expr)


MERGES = ["(merge L R 0 0 [0] [0] 'auto')", "(merge L R 1 0 [0] [0] 'auto')",
          "(merge L R 0 1 [0] [0] 'auto')", "(merge L R 1 1 [0] [0] 'auto')",
          "(merge L R 1 0 [1] [1] 'auto')", "(merge L R 1 1 [1] [1] 'auto')",
          "(merge L R 0 0 [0 1] [0 1] 'auto')",
          "(merge L R 1 0 [] [] 'auto')",
          "(merge L R 1 1 [1] [2] 'auto')",
          "(merge LT R 1 0 [0] [0] 'auto')"]


@pytest.mark.parametrize("route", ROUTES, indirect=True)
@pytest.mark.parametrize("expr", MERGES)
def test_merge(mframes, route, expr):
    check(expr)


GROUPBYS = [
    "(GB mn [0] nrow 1 'all' count 1 'all' mean 1 'all' sum 1 'all' "
    "sd 1 'all' var 1 'all' min 2 'all' max 2 'all' median 2 'all')",
    "(GB mn [4] mean 1 'all' median 3 'all' mode 5 'all')",
    "(GB mn [0 4] sum 'g' 'all' nrow 'g' 'all' max 'x' 'all')",
    "(GB mn [5 4] mode 4 'all' min 2 'all')",
    "(GB mn [4] mode 0 'all' mean 1 'all')",
    "(GB mt [5] mean 1 'all' nrow 1 'all')",
    "(GB mt [3] median 2 'all' sum 1 'all')",
]


@pytest.mark.parametrize("route", ROUTES, indirect=True)
@pytest.mark.parametrize("expr", GROUPBYS)
def test_groupby(mframes, route, expr):
    check(expr)


TABLES = ["(table (cols mn [4]))", "(table (cols mn [0]))",
          "(table (cols mn [4 5]))", "(table (cols mn [4]) (cols mn [5]) 0)",
          "(table (cols mn [0 4]) 1)", "(table (cols mn [4]) 'FALSE')"]


@pytest.mark.parametrize("route", ROUTES, indirect=True)
@pytest.mark.parametrize("expr", TABLES)
def test_table(mframes, route, expr):
    check(expr)


UPDATES = ["(:= mn 7 [1] 'all')", "(:= mn 0 [4] 'all')",
           "(:= mn -1 [1] (> (cols mn [2]) 0))",
           "(:= mn (cols mn [2]) [1] [1 3 5])",
           "(:= mn (rows (cols mn [2]) [1 3]) [1] [1 3])",
           "(:= mn (ifelse (is.na (cols mn [2])) 0 (cols mn [2])) [2] [])",
           "(:= mn 2 [4 5] [0:4])", "(:= mn (cols mn [2 3]) [0 1] 'all')",
           "(:= mt 5 [0] 7)"]


@pytest.mark.parametrize("route", ROUTES, indirect=True)
@pytest.mark.parametrize("expr", UPDATES)
def test_update(mframes, route, expr):
    check(expr)


IMPUTES = ["(h2o.impute mn 2 'mean')", "(h2o.impute mn 2 'median')",
           "(h2o.impute mn 0 'mode')", "(h2o.impute mn 4 'mode')",
           "(h2o.impute mn 1 'mean' 'interpolate' [] _ _)",
           "(h2o.impute mt 5 'median')"]


@pytest.mark.parametrize("route", ROUTES, indirect=True)
@pytest.mark.parametrize("expr", IMPUTES)
def test_impute(mframes, route, expr):
    check(expr)


ROWS = ["(rows mn (> (cols mn [2]) 0))", "(rows mn (cols mn [4]))",
        "(rows mn [5 1 1 0])", "(rows mn [-1 -3])", "(rows mn [0:9])",
        "(rows mt (< (cols mt [2]) 0))", "(rows mt [3 2 1])",
        "(na.omit mn)", "(na.omit mt)", "(na.omit (cols mn [1 4]))"]


@pytest.mark.parametrize("route", ROUTES, indirect=True)
@pytest.mark.parametrize("expr", ROWS)
def test_rows(mframes, route, expr):
    check(expr)


# ---------------------------------------------- tests/test_rapids_munge.py


def _small(key, cols):
    publish(key, *pair(cols))
    return key


REF_CASES = {
    "sort": ({"fs": {"a": (T_NUM, [3., 1., 2.], None),
                     "b": (T_NUM, [10., 20., 30.], None)}},
             ["(sort fs [0] [1])", "(sort fs [0] [0])"]),
    "merge": ({"Lm": {"k": (T_CAT, [0, 1, 2], ["a", "b", "c"]),
                      "x": (T_NUM, [1., 2., 3.], None)},
               "Rm": {"k": (T_CAT, [0, 1], ["b", "c"]),
                      "y": (T_NUM, [20., 30.], None)}},
              ["(merge Lm Rm 0 0 [0] [0] 'auto')",
               "(merge Lm Rm 1 0 [0] [0] 'auto')"]),
    "groupby": ({"G": {"g": (T_CAT, [0, 0, 1, 1, 1], ["u", "v"]),
                       "x": (T_NUM, [1., 2., 3., 4., 5.], None)}},
                ["(GB G [0] mean 1 'all' sum 1 'all' nrow 1 'all')"]),
    "cumsum_table": ({"C": {"x": (T_NUM, [1., 2., 3.], None)},
                      "T": {"c": (T_CAT, [0, 1, 0, 0], ["p", "q"])}},
                     ["(cumsum C)", "(table T)"]),
    "update_impute": ({"U": {"x": (T_NUM, [1., np.nan, 3.], None),
                             "y": (T_NUM, [9., 9., 9.], None)}},
                      ["(h2o.impute U 0 'mean')", "(:= U 7 [1] 'all')"]),
    "na_omit_which": ({"N": {"x": (T_NUM, [1., np.nan, 0., 2.], None)}},
                      ["(na.omit N)", "(which N)"]),
    "cumprod": ({"CP": {"x": (T_NUM, [2., np.nan, 3.], None)}},
                ["(cumprod CP)"]),
    "groupby_cat_na_mode": ({"GN": {"g": (T_CAT, [0, 0, 1], ["u", "v"]),
                                    "c": (T_CAT, [1, -1, 0], ["p", "q"])}},
                            ["(GB GN [0] mode 1 'all')"]),
    "update_scatter": ({"SC": {"x": (T_NUM, [0., 0., 0., 0.], None)},
                        "VALS": {"v": (T_NUM, [10., 20.], None)}},
                       ["(:= SC VALS [0] [1 3])"]),
    "update_keeps_categorical": ({"KC": {"c": (T_CAT, [0, 1], ["a", "b"])}},
                                 ["(:= KC 0 [0] 'all')"]),
}


@pytest.mark.parametrize("route", ROUTES, indirect=True)
@pytest.mark.parametrize("case", sorted(REF_CASES))
def test_reference_munge_cases(cl, route, case):
    frames, exprs = REF_CASES[case]
    for key, cols in frames.items():
        _small(key, cols)
    try:
        for expr in exprs:
            check(expr)
    finally:
        unpublish_ref(*frames)


# ------------------------------------------------------------------ routes


def test_device_munge_setting(monkeypatch):
    from h2o_tpu.core.munge import device_munge_enabled
    for val in ("0", "false", "off", "OFF", "False", "1", "true", "", "on"):
        monkeypatch.setenv("H2O_TPU_DEVICE_MUNGE", val)
        assert tm.device_munge_enabled() == device_munge_enabled(), val
    monkeypatch.delenv("H2O_TPU_DEVICE_MUNGE")
    assert tm.device_munge_enabled() and device_munge_enabled()


EVERY_MUNGE_OP = ["(sort mn [0] [1])", "(merge L R 1 0 [0] [0] 'auto')",
                  "(GB mn [0] mean 1 'all' mode 4 'all')",
                  "(rows mn (cols mn [3]))", "(rows mn [1 2])",
                  "(na.omit mn)"]
VERBS = ("sort_frame", "merge_frames", "groupby_frame", "filter_rows",
         "take_rows")


@pytest.mark.parametrize("expr", EVERY_MUNGE_OP)
def test_host_route_calls_no_device_verb(mframes, monkeypatch, expr):
    monkeypatch.setenv("H2O_TPU_DEVICE_MUNGE", "0")

    def refuse(*a, **k):
        raise AssertionError("a device verb was called on the host route")

    for name in VERBS:
        monkeypatch.setattr(ti, name, refuse)
    TransferStats.reset()
    check(expr)
    assert TransferStats.snapshot() == {"to_device": 0, "to_host": 0}


@pytest.mark.parametrize("expr", EVERY_MUNGE_OP)
def test_device_route_errors_reach_the_caller(mframes, monkeypatch, expr):
    """No error sends a frame to a host route: a verb that fails on the
    device raises."""
    monkeypatch.setenv("H2O_TPU_DEVICE_MUNGE", "1")
    seen = []

    def fail(*a, device=None, **k):
        seen.append(device)
        raise RuntimeError("the device verb failed")

    for name in VERBS:
        monkeypatch.setattr(ti, name, fail)
    with pytest.raises(RuntimeError, match="the device verb failed"):
        ti.rapids_exec(expr, device="cpu")
    assert [str(d) for d in seen] == ["cpu"]


def test_refused_frames_raise_by_name_when_a_verb_is_called(mframes):
    """The device verbs refuse a time column by name, pointing at the
    interpreter's host route; rapids_exec takes the same frame there."""
    from h2o_tpu_torch.core.store import dkv
    mt = dkv().get("mt")
    calls = {"sort": lambda: tm.sort_frame(mt, [0], [True], device="cpu"),
             "filter": lambda: tm.filter_rows(mt, np.ones(mt.nrows),
                                              device="cpu"),
             "take": lambda: tm.take_rows(mt, [0, 1], device="cpu"),
             "groupby": lambda: tm.groupby_frame(
                 mt, [0], [("sum", 1, "all")], device="cpu"),
             "merge": lambda: tm.merge_frames(mt, mt, False, False, [0],
                                              [0], device="cpu")}
    for verb, call in calls.items():
        with pytest.raises(ValueError, match=r"t \(time\).*rapids_exec "
                           r"takes such a frame on its host route"):
            call()
    for expr in ("(sort mt [0] [1])", "(rows mt [0 1])",
                 "(GB mt [0] sum 1 'all')", "(merge LT L 1 0 [1] [1] 'x')",
                 "(rows mt (> (cols mt [1]) 0))"):
        check(expr)


def test_route_bytes(mframes, monkeypatch):
    """The device route moves the frame once each way; the host route
    moves nothing."""
    monkeypatch.setenv("H2O_TPU_DEVICE_MUNGE", "1")
    TransferStats.reset()
    out = ti.rapids_exec("(sort mn [0] [1])", device="cpu")
    n, c = out.nrows, out.ncols
    assert TransferStats.snapshot() == {"to_device": n * c * 4,
                                        "to_host": n * c * 4}
    assert T_STR not in out.types()
