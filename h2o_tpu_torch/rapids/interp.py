"""Rapids — the dataframe expression language behind ``POST /3/Rapids``:
a port of ``h2o_tpu/rapids/interp.py`` but its long tail of prims.

Clients (h2o-py's ``expr.py``, R) send Lisp-style strings such as
``(tmp= t1 (mean (cols frame 'x')))``; the interpreter parses them and
evaluates each prim over frames, with a ``Session`` that names its
temporaries in the DKV.  Reference map: the parser ``_TOKEN`` ..
``parse`` :35-98; ``Session`` :106-130 and ``_Env`` :356-359;
``_as_frame`` :132-137, ``_string_compare`` :152-186, ``_elementwise``
:193-255, ``_reduce_all`` :257-267, ``_col_indices`` / ``_lit``
:270-287, ``_row_select`` and its host routes :297-348; the op tables
:362-404; ``_offer_plan`` :406-413; ``_eval`` :415-735; the cumulative
ops :745-748; sort, merge, group-by and table :751-1099; the string ops
and time parts
:1101-1232; ``_update`` and ``_impute`` :1234-1320; ``_labels_of``
:1353-1363; ``as.Date``, ``mktime`` and ``moment`` :1473-1537;
``grep`` and ``strlen`` :1592-1619; ``_numlist_vals`` / ``_mixed_list``
:1953-1977; ``as.character`` and ``is.character`` :1994-2013;
``strDistance``, ``tokenize`` and the timezone ops :2271-2369;
``num_valid_substrings`` .. ``tf-idf`` :2449-2584; ``_model_arg`` and
the model ops :2587-2916; ``op_names`` :2994-3014;
``_normalize_numpy_reprs`` and ``rapids_exec`` :3017-3063.

Frames stay on the host (``core/frame.py``).  An elementwise op, ``ifelse``
and a cumulative op upload the columns they read once, as one float32
matrix (categorical NA codes as NaN), compute on the session's device
and bring their result back once; ``core.diag.TransferStats`` counts the
bytes.  ``exp``, ``log``, ``log1p``, ``cumsum`` and ``cumprod`` are XLA's
CPU arithmetic (``ops/xlamath.py``), so they give the reference's bits on
every device; the other transcendental ops are PyTorch's, a few units in
the last place from XLA's.  ``sign`` keeps NaN and the sign of zero, as
``jnp.sign`` does (``torch.sign`` maps NaN to 0).  A binary op that
touches a time column computes on the exact float64 host copies, as the
reference does.  Reductions read the host rollups (``Vec.rollups``);
``median`` and ``quantile`` refine on the device (``core/quantile.py``).

Sort, merge, group-by, the row selections and ``na.omit`` have a device
route (the verbs of ``core/munge.py``) and a host route (numpy, the
reference's parity oracle).  The route is chosen before anything is
launched, by the reference's own predicates: ``device_munge_enabled()``
(``H2O_TPU_DEVICE_MUNGE``), ``frame_device_ok``, ``merge_device_ok``,
``DEVICE_AGGS`` with ``mode_device_eligible``, and non-negative indices.
Each device verb runs under the OOM ladder (``core/oom.py``; sites
``munge.filter``, ``munge.take``, ``munge.sort``, ``munge.merge``,
``munge.groupby``): a device OOM sweeps and retries, then runs the
verb's host route (rung (c)); every other error of a device verb
reaches the caller.  Before its eager handler runs, ``rows``,
``sort``, ``GB`` and ``na.omit`` offer their node to the planner
(``rapids/plan.py``, ``_offer_plan``), which runs a chain of filter and
``na.omit`` stages with its sort, group-by or last filter as one region
(``core/fuse.py``): one upload and one download, bitwise the eager
chain's frame.  ``table``, ``:=``,
``h2o.impute``, ``asfactor``, ``which`` and the binds compute on the host,
as in the reference.  The reference's ``_dense`` repacks a frame whose
rows are spread over shards as ragged prefixes; one device holds no such
frame, so it has no counterpart here.

The string ops, the time parts, the date and text ops and the timezone
ops run on the host, in numpy and Python, as the reference runs them:
they move nothing to or from the device.  A categorical is worked on
once a level where the answer is a function of the label (its domain
rewritten, merging labels that collide, or a per-level value gathered
by code), and a string column once a distinct string.  ``week`` is the
reference's dispatch: ``(day of year) // 7 + 1``, not the ISO week of
its ``_op_week``, which its ``_eval`` never reaches.  The model ops read
models from ``core.store.dkv()`` and score on each model's own device
through ``predict_raw`` and ``model_metrics``; their bookkeeping is on
the host, with dicts where the reference looks codes up with
``list.index`` (the same codes).

The frame and statistics ops (reference :1328-1472, :1539-1591,
:1622-1993, :2016-2270, :2372-2435) run where the reference runs them.
``scale`` and ``not`` compute on the session's device (one upload of the
columns read, one download), and ``apply`` binds each column, or the
transposed rows, in ``_Env.locals`` and evaluates its lambda's body
through ``_eval``, so a device op there runs on the session's device.
The rest are numpy on the host and move nothing: ``hist``, the fold
columns and ``h2o.runif`` (numpy's ``default_rng(seed)`` in the
reference's call order), ``which.max``/``which.min``, ``topn``, the
moments, ``prod``, ``any``/``all``, ``cor``, ``sumaxis``, ``entropy``,
the reshaping and row ops and the level and domain ops.  Where the
reference loops over rows only to copy or count values (``fillna``,
``dropdup``, ``pivot``, ``rank_within_groupby``, ``match``,
``relevel.by.freq``'s tail, ``cor``'s tie ranks), the port does it in
whole-array steps with the same answers; ``entropy`` is computed once a
distinct label.

Where the port's answer differs from the reference's: a binary op on two
numbers gives a Python float (the reference returns a jax scalar, and its
comparisons of two numbers raise ``AttributeError``); frames of unequal
row counts raise ``ValueError`` (an ``AssertionError`` there).
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from h2o_tpu_torch.core.device import (DeviceLike, cloud, set_timezone,
                                       timezone)
from h2o_tpu_torch.core.diag import TransferStats
from h2o_tpu_torch.core.frame import (T_CAT, T_NUM, T_STR, T_TIME, Frame,
                                      Vec, frame_device_ok)
from h2o_tpu_torch.core.munge import (DEVICE_AGGS, device_munge_enabled,
                                      filter_rows, groupby_frame,
                                      merge_device_ok, merge_frames,
                                      mode_device_eligible, sort_frame,
                                      take_rows)
from h2o_tpu_torch.core.oom import oom_ladder
from h2o_tpu_torch.core.quantile import quantile, quantile_vec
from h2o_tpu_torch.core.store import Key, dkv
from h2o_tpu_torch.ops import xlamath

# ---------------------------------------------------------------------------
# parser (Rapids.java grammar: ( fun args... ), [num list], 'str', ids)
# ---------------------------------------------------------------------------

_TOKEN = re.compile(r"""\s*(,|\(|\)|\[|\]|"[^"]*"|'[^']*'|[^\s(),\[\]]+)""")
_SPAN = re.compile(r"^(-?\d+(?:\.\d+)?):(\d+(?:\.\d+)?)"
                   r"(?::(-?\d+(?:\.\d+)?))?$")


def _expand_numlist(lst) -> List[int]:
    """Flatten numlist entries (plain numbers and spans) to int indices."""
    out: List[int] = []
    for x in lst:
        if isinstance(x, tuple) and x[0] == "span":
            _, lo, cnt, stride = x
            out.extend(int(lo + i * stride) for i in range(int(cnt)))
        else:
            out.append(int(x if isinstance(x, float) else _lit(x)))
    return out


def _tokenize(s: str) -> List[str]:
    out, i = [], 0
    while i < len(s):
        m = _TOKEN.match(s, i)
        if not m:
            break
        out.append(m.group(1))
        i = m.end()
    return out


def _parse(tokens: List[str], pos: int = 0):
    t = tokens[pos]
    if t == "(":
        lst = []
        pos += 1
        while tokens[pos] != ")":
            node, pos = _parse(tokens, pos)
            lst.append(node)
        return lst, pos + 1
    if t == "[":
        lst = []
        pos += 1
        while tokens[pos] != "]":
            if tokens[pos] == ",":
                pos += 1
                continue
            node, pos = _parse(tokens, pos)
            lst.append(node)
        return ("numlist", lst), pos + 1
    if t[0] in "\"'":
        return ("str", t[1:-1]), pos + 1
    m = _SPAN.match(t)
    if m:
        # a span `lo:cnt[:stride]` (head() sends [0:5]): cnt entries
        # lo, lo + stride, ...
        lo, cnt, stride = (float(m.group(1)), float(m.group(2)),
                           float(m.group(3) or 1))
        return ("span", lo, cnt, stride), pos + 1
    try:
        return float(t), pos + 1
    except ValueError:
        return ("id", t), pos + 1


def parse(expr: str):
    """The AST of one expression: lists for calls, floats, and
    ``("str", s)``, ``("id", name)``, ``("numlist", [...])`` and
    ``("span", lo, cnt, stride)`` tuples."""
    ast, _ = _parse(_tokenize(expr))
    return ast


# ---------------------------------------------------------------------------
# session & evaluation
# ---------------------------------------------------------------------------

class Session:
    """Temporary frames by name (water/rapids/Session.java), and the
    device the session's ops compute on (``None``: ``cloud(None)``, the
    card)."""

    def __init__(self, session_id: str = "_default",
                 device: DeviceLike = None):
        self.id = session_id
        self.device = device
        self.temps: Dict[str, Frame] = {}

    def lookup(self, name: str) -> Any:
        if name in self.temps:
            return self.temps[name]
        v = dkv().get(name)
        if v is None:
            raise KeyError(f"rapids: unknown id {name!r}")
        return v

    def assign(self, name: str, fr: Frame) -> Frame:
        fr.key = Key(name)
        self.temps[name] = fr
        dkv().put(name, fr)
        return fr

    def remove(self, name: str) -> None:
        self.temps.pop(name, None)
        dkv().remove(name)


class _Env:
    def __init__(self, session: Session, device: torch.device):
        self.s = session
        self.dev = device
        self.locals: Dict[str, Any] = {}    # apply's lambda arguments


def _as_frame(v) -> Frame:
    if isinstance(v, Frame):
        return v
    if isinstance(v, (int, float)):
        raise TypeError("expected frame, got number")
    raise TypeError(f"expected frame, got {type(v)}")


def _lit(node):
    if isinstance(node, tuple) and node[0] in ("str", "id"):
        return node[1]
    return node


def _col_indices(fr: Frame, sel, names_first: bool = False) -> List[int]:
    """Column indices of a selector: a bracket list, a name or a number.
    A bracket list is read as numbers (spans, strings that parse as
    numbers), else as names; with ``names_first`` (the frame ops that
    take column lists: dropdup, melt, pivot, rank_within_groupby) a list
    whose first entry is a string is read as names."""
    if isinstance(sel, tuple) and sel[0] == "numlist":
        items = sel[1]
        if names_first:
            if items and isinstance(items[0], tuple) and \
                    items[0][0] == "str":
                return [fr.names.index(_lit(x)) for x in items]
            return _expand_numlist(items)
        try:
            return _expand_numlist(items)
        except (TypeError, ValueError):
            # string names in the list
            return [fr.names.index(_lit(x)) for x in items]
    if isinstance(sel, tuple) and sel[0] == "str":
        return [fr.names.index(sel[1])]
    if isinstance(sel, float):
        return [int(sel)]
    raise TypeError(f"bad column selector {sel}")


# ---------------------------------------------------------------------------
# transport: one upload of the columns an op reads, one download
# ---------------------------------------------------------------------------


def _upload(fr: Frame, dev, cols=None) -> torch.Tensor:
    """(rows, len(cols)) float32 of the columns' ``as_float`` on ``dev``
    (every column when ``cols`` is None)."""
    vecs = fr.vecs if cols is None else [fr.vecs[j] for j in cols]
    m = np.stack([v.as_float() for v in vecs], axis=1) if vecs else \
        np.zeros((fr.nrows, 0), np.float32)
    m = np.ascontiguousarray(m, np.float32)
    TransferStats.note("to_device", m.nbytes)
    return torch.from_numpy(m).to(dev)


def _download(t: torch.Tensor) -> np.ndarray:
    out = t.cpu().numpy()
    TransferStats.note("to_host", out.nbytes)
    return out


def _numeric_frame(names, out: np.ndarray) -> Frame:
    """A frame of float32 columns from a (rows, cols) host result."""
    return Frame(list(names), [Vec(np.ascontiguousarray(out[:, j]))
                               for j in range(out.shape[1])])


def _full(like: torch.Tensor, s) -> torch.Tensor:
    """The number ``s`` as float32, the shape of ``like`` (a tensor
    operand: on the card a division by a Python number multiplies by its
    float32 reciprocal)."""
    return torch.full_like(like, float(np.float32(s)))


# ---------------------------------------------------------------------------
# elementwise ops
# ---------------------------------------------------------------------------


def _string_compare(op, a, b):
    """``==``/``!=`` against a string literal over string and
    categorical columns: level names are compared, not codes.  None
    when this is not a string comparison.  The codes are on the host,
    so the comparison is made there."""
    lit = None
    fr = None
    if isinstance(a, Frame) and isinstance(b, str):
        fr, lit = a, b
    elif isinstance(b, Frame) and isinstance(a, str):
        fr, lit = b, a
    elif isinstance(a, Frame) and any(v.type == T_STR for v in a.vecs) \
            and isinstance(b, (int, float)):
        fr, lit = a, str(b)
    if fr is None or not any(v.type in (T_STR, T_CAT) for v in fr.vecs):
        return None
    vecs = []
    for v in fr.vecs:
        if v.type == T_STR:
            eq = np.array([x == lit for x in v.host_data], np.float32)
        elif v.type == T_CAT:
            dom = v.domain or []
            code = dom.index(lit) if lit in dom else -2
            eq = (np.asarray(v.to_numpy()) == code).astype(np.float32)
        else:
            eq = np.zeros(v.nrows, np.float32)
        vecs.append(Vec(eq if op == "==" else 1.0 - eq))
    return Frame(list(fr.names), vecs)


def _has_time(x) -> bool:
    return isinstance(x, Frame) and any(v.type == T_TIME for v in x.vecs)


def _scalar_op(op, a, b) -> float:
    """A binary op on two numbers, in float32."""
    return float(op(torch.tensor(np.float32(a)), torch.tensor(np.float32(b))))


def _elementwise(op, dev, a, b=None, name=None):
    """Apply a tensor op over frames and numbers, broadcasting a
    one-column frame over the other's columns.  Binary ops that involve
    a time column run on the exact float64 host copies instead of the
    float32 payload (epoch milliseconds, see ``_NP_BINOPS``)."""
    if b is not None and name in _NP_BINOPS and \
            (_has_time(a) or _has_time(b)):
        npop = _NP_BINOPS[name]

        def col(x, i):
            if not isinstance(x, Frame):
                return x
            v = x.vecs[i if x.ncols > 1 else 0]
            return np.asarray(v.to_numpy(), np.float64)

        def is_time(x, i):
            return isinstance(x, Frame) and \
                x.vecs[i if x.ncols > 1 else 0].type == T_TIME

        af, bf = isinstance(a, Frame), isinstance(b, Frame)
        base = a if (af and (not bf or a.ncols >= b.ncols)) else b
        vecs = []
        for i in range(base.ncols):
            res = npop(col(a, i), col(b, i))
            # time +- number stays a time (epoch-scale values keep the
            # exact float64 copy); time - time is a duration
            keep_time = name in ("+", "-") and \
                (is_time(a, i) != is_time(b, i))
            vecs.append(Vec(res, T_TIME) if keep_time else Vec(res))
        return Frame(list(base.names), vecs)
    if b is None:
        fr = _as_frame(a)
        return _numeric_frame(fr.names, _download(op(_upload(fr, dev))))
    af, bf = isinstance(a, Frame), isinstance(b, Frame)
    if af and bf:
        if a.nrows != b.nrows:
            raise ValueError(f"frame row mismatch: {a.nrows} and "
                             f"{b.nrows} rows")
        ma = _upload(a, dev)
        mb = ma if b is a else _upload(b, dev)
        n = max(a.ncols, b.ncols)
        out = torch.stack([op(ma[:, i if a.ncols > 1 else 0],
                              mb[:, i if b.ncols > 1 else 0])
                           for i in range(n)], dim=1) if n else ma
        names = (a if a.ncols >= b.ncols else b).names
        return _numeric_frame(names, _download(out))
    if af:
        m = _upload(a, dev)
        return _numeric_frame(a.names, _download(op(m, _full(m, b))))
    if bf:
        m = _upload(b, dev)
        return _numeric_frame(b.names, _download(op(_full(m, a), m)))
    return _scalar_op(op, a, b)


def _cmp(fn):
    return lambda a, b: fn(a, b).to(torch.float32)


def _sign(x: torch.Tensor) -> torch.Tensor:
    """``jnp.sign``: NaN stays NaN and a zero keeps its sign."""
    return torch.where((x == 0) | torch.isnan(x), x,
                       torch.copysign(torch.ones_like(x), x))


def _remainder(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.mod``: C's ``fmod``, moved by ``b`` where the two signs
    differ (the divisor's sign, as ``torch.remainder``)."""
    mod = torch.fmod(a, b)
    return torch.where((mod != 0) & ((mod < 0) != (b < 0)), mod + b, mod)


def _round_away(x: torch.Tensor) -> torch.Tensor:
    """``lax.round``'s default: halves away from zero, a zero keeping
    its sign (C's ``roundf``)."""
    t = torch.trunc(x)
    return torch.where((x - t).abs() >= 0.5, t + _sign(x), t)


def _floor_divide(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.floor_divide`` on floats (CPython's ``float_divmod``): NaN
    for a zero divisor, where ``torch.floor_divide`` gives an infinity,
    and a zero quotient signed as ``(a - mod) / b``."""
    mod = torch.fmod(a, b)
    div = (a - mod) / b
    ind = (mod != 0) & (_sign(b) != _sign(mod))
    return _round_away(torch.where(ind, div - 1, div))


_BINOPS = {
    "+": torch.add, "-": torch.sub, "*": torch.mul, "/": torch.div,
    "^": torch.pow, "%": _remainder, "%%": _remainder,
    "intDiv": _floor_divide,
    "<": _cmp(torch.lt), "<=": _cmp(torch.le), ">": _cmp(torch.gt),
    ">=": _cmp(torch.ge), "==": _cmp(torch.eq), "!=": _cmp(torch.ne),
    "&": lambda a, b: ((a != 0) & (b != 0)).to(torch.float32),
    "|": lambda a, b: ((a != 0) | (b != 0)).to(torch.float32),
}

# numpy twins for the exact float64 host path: epoch milliseconds exceed
# float32's precision (~4 min apart at today's dates), so arithmetic and
# comparisons that touch a time column run on the exact host copy
_NP_BINOPS = {
    "+": np.add, "-": np.subtract, "*": np.multiply, "/": np.divide,
    "^": np.power, "%": np.mod, "%%": np.mod,
    "intDiv": np.floor_divide,
    "<": lambda a, b: (a < b).astype(np.float64),
    "<=": lambda a, b: (a <= b).astype(np.float64),
    ">": lambda a, b: (a > b).astype(np.float64),
    ">=": lambda a, b: (a >= b).astype(np.float64),
    "==": lambda a, b: (a == b).astype(np.float64),
    "!=": lambda a, b: (a != b).astype(np.float64),
    "&": lambda a, b: ((a != 0) & (b != 0)).astype(np.float64),
    "|": lambda a, b: ((a != 0) | (b != 0)).astype(np.float64),
}

_UNOPS = {
    "abs": torch.abs, "exp": xlamath.exp, "log": xlamath.log,
    "log10": torch.log10, "log2": torch.log2, "log1p": xlamath.log1p,
    "sqrt": torch.sqrt, "floor": torch.floor, "ceiling": torch.ceil,
    "round": torch.round, "trunc": torch.trunc, "sin": torch.sin,
    "cos": torch.cos, "tan": torch.tan, "sinh": torch.sinh,
    "cosh": torch.cosh, "tanh": torch.tanh, "asin": torch.asin,
    "acos": torch.acos, "atan": torch.atan, "sign": _sign,
    "signif": torch.round,
    "!": lambda a: (a == 0).to(torch.float32),
    "is.na": lambda a: torch.isnan(a).to(torch.float32),
}


def _total_order(x: torch.Tensor) -> torch.Tensor:
    """float32 as int32 keys in IEEE 754-2019's order (-0.0 below 0.0);
    the map is its own inverse."""
    i = x.view(torch.int32)
    return torch.where(i < 0, i ^ 0x7FFFFFFF, i)


def _cum_extreme(x: torch.Tensor, fn) -> torch.Tensor:
    """A running min or max down the rows as XLA's CPU ``minimum`` and
    ``maximum`` take it: -0.0 orders below 0.0."""
    return _total_order(fn(_total_order(x), dim=0).values).view(
        torch.float32)


# the cumulative ops along the rows of a (rows, cols) matrix; NA rows
# take the op's identity
_CUMOPS = {"cumsum": lambda x: xlamath.cumsum(x.T).T,
           "cumprod": lambda x: xlamath.cumprod(x.T).T,
           "cummin": lambda x: _cum_extreme(x, torch.cummin),
           "cummax": lambda x: _cum_extreme(x, torch.cummax)}
_CUM_IDENT = {"cumsum": 0.0, "cumprod": 1.0, "cummin": math.inf,
              "cummax": -math.inf}


# ---------------------------------------------------------------------------
# reductions, row selection
# ---------------------------------------------------------------------------


def _reduce_all(red, fr: Frame):
    """Reduce every numeric and categorical column: one value, or a list
    of one a column."""
    fr = _as_frame(fr)
    vals = [red(v) for v in fr.vecs if v.is_numeric or v.is_categorical]
    if len(vals) == 1:
        return vals[0]
    return vals


def _row_select(fr: Frame, sel, dev) -> Frame:
    if isinstance(sel, Frame):                      # a mask frame
        mv = sel.vecs[0]
        if device_munge_enabled() and frame_device_ok(fr) and \
                mv.data is not None:
            # the rows compact on the device (core/munge.filter_rows);
            # out of device memory the ladder ends in the host route
            return oom_ladder(
                "munge.filter", lambda: filter_rows(fr, mv.data, device=dev),
                host_fallback=lambda: _row_select_mask_host(fr, mv))
        return _row_select_mask_host(fr, mv)
    if isinstance(sel, tuple) and sel[0] == "numlist":
        idx = np.asarray(_expand_numlist(sel[1]), np.int64)
    elif isinstance(sel, tuple) and sel[0] == "span":
        idx = np.asarray(_expand_numlist([sel]), np.int64)
    else:
        idx = np.asarray([int(sel)], np.int64)
    if device_munge_enabled() and frame_device_ok(fr) and \
            np.all(idx >= 0):
        # an index list gathers on the device (core/munge.take_rows)
        return oom_ladder(
            "munge.take", lambda: take_rows(fr, idx, device=dev),
            host_fallback=lambda: _row_select_host(fr, idx))
    return _row_select_host(fr, idx)


def _row_select_mask_host(fr: Frame, mask_vec: Vec) -> Frame:
    """The host route of a mask selection."""
    mask = np.asarray(mask_vec.to_numpy(), np.float64) > 0
    return _row_select_host(fr, np.nonzero(mask)[0])


def _row_select_host(fr: Frame, idx: np.ndarray) -> Frame:
    """The host gather: index lists the device verbs refuse (negative
    indices), frames they do not take, and every selection with the
    device routes off."""
    vecs = []
    for v in fr.vecs:
        data = v.to_numpy()[idx]
        vecs.append(Vec(data, v.type, domain=v.domain)
                    if v.type != T_CAT else
                    Vec(data.astype(np.int32), T_CAT, domain=v.domain))
    return Frame(list(fr.names), vecs)


# ---------------------------------------------------------------------------
# the evaluator
# ---------------------------------------------------------------------------

_REDUCERS = ("mean", "sum", "min", "max", "sd", "var", "median")

_STROPS = ("toupper", "tolower", "trim", "nchar", "length", "substring",
           "replacefirst", "replaceall", "sub", "gsub", "strsplit",
           "countmatches", "lstrip", "rstrip")
_TIME_PARTS = ("year", "month", "day", "dayOfWeek", "hour", "minute",
               "second", "week")

# every op name _eval dispatches besides the op tables
_NAMED_OPS = (
    "tmp=", "rm", "rm_fr", "cols", "cols_py", "rows", "rows_py", "nrow",
    "ncol", "colnames", "colnames=", "cbind", "rbind", "sumNA", "minNA",
    "maxNA", "meanNA", "medianNA", "sdNA", "varNA") + _REDUCERS + (
    "quantile", "ifelse", "asfactor", "as.factor", "asnumeric",
    "as.numeric", "levels", "unique", ":", "assign", "sort", "merge", "GB",
    "groupby", "table", "na.omit", "naCnt", "which", "is.factor",
    "anyfactor", "is.numeric", ":=", "append", "h2o.impute")


def _offer_plan(op, node, env):
    """Offer a fusable terminal verb to the planner (``rapids/plan.py``)
    before the eager handler runs: the fused region's frame, or None
    (the eager path, also the planner's parity oracle, then runs).  The
    planner is imported here, not at the top: it imports this module."""
    from h2o_tpu_torch.rapids.plan import try_plan
    return try_plan(op, node, env, _eval)


def _eval(node, env: _Env):
    s = env.s
    if isinstance(node, float):
        return node
    if isinstance(node, tuple):
        tag = node[0]
        if tag == "str":
            return node
        if tag == "id":
            name = node[1]
            # Rapids' boolean and NA literals (the client serializes
            # Python bools as bare True/False ids)
            if name in ("TRUE", "True", "true"):
                return 1.0
            if name in ("FALSE", "False", "false"):
                return 0.0
            if name in ("NA", "NaN", "nan"):
                return float("nan")
            if name in env.locals:
                return env.locals[name]
            return s.lookup(name)
        if tag == "numlist":
            return node
    if not isinstance(node, list):
        raise TypeError(f"bad node {node}")
    head = node[0]
    op = head[1] if isinstance(head, tuple) else head

    if op == "tmp=":
        name = _lit(node[1])
        val = _eval(node[2], env)
        return s.assign(name, _as_frame(val))
    if op in ("rm", "rm_fr"):
        s.remove(_lit(node[1]))
        return None
    if op in ("cols", "cols_py"):
        fr = _as_frame(_eval(node[1], env))
        sel = node[2] if isinstance(node[2], tuple) else _eval(node[2], env)
        idxs = _col_indices(fr, sel)
        return fr.subframe([fr.names[i] for i in idxs])
    if op in ("rows", "rows_py"):
        fused = _offer_plan(op, node, env)
        if fused is not None:
            return fused
        fr = _as_frame(_eval(node[1], env))
        sel = node[2]
        if isinstance(sel, list):
            sel = _eval(sel, env)
        return _row_select(fr, sel, env.dev)
    if op == "nrow":
        return float(_as_frame(_eval(node[1], env)).nrows)
    if op == "ncol":
        return float(_as_frame(_eval(node[1], env)).ncols)
    if op == "colnames":
        return [("str", n) for n in _as_frame(_eval(node[1], env)).names]
    if op == "colnames=":
        fr = _as_frame(_eval(node[1], env))
        names = [_lit(x) for x in node[3][1]] if isinstance(node[3], tuple) \
            else [_lit(node[3])]
        fr.names = list(names)
        return fr
    if op == "cbind":
        frames = [_as_frame(_eval(a, env)) for a in node[1:]]
        out = frames[0]
        for f2 in frames[1:]:
            out = out.cbind(f2)
        return out
    if op == "rbind":
        frames = [_as_frame(_eval(a, env)) for a in node[1:]]
        names = frames[0].names
        vecs = []
        for j in range(len(names)):
            parts = [f.vecs[j].to_numpy() for f in frames]
            v0 = frames[0].vecs[j]
            data = np.concatenate(parts)
            vecs.append(Vec(data if v0.type != T_CAT else
                            data.astype(np.int32), v0.type,
                            domain=v0.domain))
        return Frame(list(names), vecs)
    if op in _BINOPS:
        a = _eval(node[1], env)
        b = _eval(node[2], env)
        if op in ("==", "!="):
            sc = _string_compare(op,
                                 a[1] if isinstance(a, tuple) and
                                 a[0] == "str" else a,
                                 b[1] if isinstance(b, tuple) and
                                 b[0] == "str" else b)
            if sc is not None:
                return sc
        return _elementwise(_BINOPS[op], env.dev, a, b, name=op)
    if op in _UNOPS:
        return _elementwise(_UNOPS[op], env.dev, _eval(node[1], env))
    if op in ("sumNA", "minNA", "maxNA", "meanNA", "medianNA", "sdNA",
              "varNA"):
        op = op[:-2]    # the NA-skipping forms: rollups skip NAs anyway
    if op in _REDUCERS:
        return _reduce(op, node, env)
    if op == "quantile":
        fr = _as_frame(_eval(node[1], env))
        probs = [float(x) for x in node[2][1]]
        q = quantile(fr, probs, device=env.dev)
        cols = {"Probs": np.asarray(probs, np.float32)}
        for c, vals in q.items():
            cols[f"{c}Quantiles"] = np.asarray(vals, np.float32)
        return Frame.from_dict(cols)
    if op == "ifelse":
        return _ifelse(_eval(node[1], env), _eval(node[2], env),
                       _eval(node[3], env), env.dev)
    if op in ("asfactor", "as.factor"):
        fr = _as_frame(_eval(node[1], env))
        return Frame(list(fr.names), [_asfactor(v) for v in fr.vecs])
    if op in ("asnumeric", "as.numeric"):
        fr = _as_frame(_eval(node[1], env))
        out = []
        for v in fr.vecs:
            if v.is_categorical:
                # numeric-looking domains convert by value, else by code
                codes = v.to_numpy()
                try:
                    dom = np.asarray([float(d) for d in v.domain],
                                     np.float32)
                    vals = np.where(codes < 0, np.nan,
                                    dom[np.clip(codes, 0, None)])
                except ValueError:
                    vals = np.where(codes < 0, np.nan,
                                    codes.astype(np.float32))
                out.append(Vec(vals.astype(np.float32), T_NUM))
            else:
                out.append(v)
        return Frame(list(fr.names), out)
    if op == "levels":
        # a frame: one column a column, its rows the level labels,
        # NA-padded (the client's frame.py levels() zips the columns)
        fr = _as_frame(_eval(node[1], env))
        doms = [list(v.domain or []) for v in fr.vecs]
        width = max((len(d) for d in doms), default=0) or 1
        vecs = []
        for d in doms:
            codes = np.asarray(list(range(len(d))) +
                               [-1] * (width - len(d)), np.int32)
            vecs.append(Vec(codes, T_CAT, domain=d or ["_"]))
        return Frame(list(fr.names), vecs)
    if op == "unique":
        fr = _as_frame(_eval(node[1], env))
        u = np.unique(fr.vecs[0].to_numpy())
        u = u[~np.isnan(u)] if u.dtype.kind == "f" else u
        return Frame(["unique"], [Vec(u.astype(np.float32))])
    if op == ":":  # the inclusive range start:end as a numlist
        a = int(_eval(node[1], env))
        b = int(_eval(node[2], env))
        return ("numlist", [float(i) for i in range(a, b + 1)])
    if op == "assign":
        return s.assign(_lit(node[1]), _as_frame(_eval(node[2], env)))
    if op == "sort":
        fused = _offer_plan(op, node, env)
        return fused if fused is not None else _sort(node, env)
    if op == "merge":
        return _merge(node, env)
    if op in ("GB", "groupby"):
        fused = _offer_plan(op, node, env)
        return fused if fused is not None else _groupby(node, env)
    if op == "table":
        return _table(node, env)
    if op in _CUMOPS:
        fr = _as_frame(_eval(node[1], env))
        m = _upload(fr, env.dev)
        x = torch.where(torch.isnan(m),
                        torch.full_like(m, _CUM_IDENT[op]), m)
        return _numeric_frame(fr.names, _download(_CUMOPS[op](x)))
    if op in _STROPS:
        return _string_op(op, node, env)
    if op in _TIME_PARTS:
        return _time_part(op, node, env)
    if op == "na.omit":
        fused = _offer_plan(op, node, env)
        if fused is not None:
            return fused
        return _na_omit(_as_frame(_eval(node[1], env)), env.dev)
    if op == "naCnt":
        fr = _as_frame(_eval(node[1], env))
        return [float(_na_count(v)) for v in fr.vecs]
    if op == "which":
        fr = _as_frame(_eval(node[1], env))
        d = np.asarray(fr.vecs[0].to_numpy())
        hits = np.flatnonzero((d != 0) & ~np.isnan(d))
        return Frame(["which"], [Vec(hits.astype(np.float64))])
    if op in ("is.factor", "anyfactor"):
        fr = _as_frame(_eval(node[1], env))
        flags = [v.is_categorical for v in fr.vecs]
        if op == "anyfactor":
            return float(any(flags))
        return [float(f) for f in flags]
    if op == "is.numeric":
        fr = _as_frame(_eval(node[1], env))
        return [float(v.is_numeric) for v in fr.vecs]
    if op == ":=":
        return _update(node, env)
    if op == "append":
        fr = _as_frame(_eval(node[1], env))
        col = _as_frame(_eval(node[2], env))
        out = Frame(list(fr.names), list(fr.vecs))
        out.add(_lit(node[3]), col.vecs[0])
        return out
    if op == "h2o.impute":
        return _impute(node, env)
    if op in _EXTRA_OPS:
        return _EXTRA_OPS[op](node, env)
    raise NotImplementedError(f"rapids op {op!r}")


def _reduce(op, node, env):
    """(op fr) over every column, or the axis forms (op fr na_rm axis):
    AstMean.java's one-row frame (axis 0) and row-wise frame (axis 1)."""
    fr = _as_frame(_eval(node[1], env))
    axis_form = len(node) > 2
    na_rm = bool(_eval(node[2], env)) if axis_form else True
    axis = int(_eval(node[3], env)) if len(node) > 3 else 0

    def red(v):
        r = v.rollups
        if op == "mean":
            return float(r.mean)
        if op == "sum":
            return float(r.mean * r.cnt)
        if op == "min":
            return float(r.min)
        if op == "max":
            return float(r.max)
        if op == "sd":
            return float(r.sigma)
        if op == "var":
            return float(r.sigma ** 2)
        return float(quantile_vec(v, 0.5, device=env.dev))

    if axis_form and axis == 1:
        mats = [np.asarray(v.to_numpy(), np.float64)[: fr.nrows]
                for v in fr.vecs if not v.is_categorical]
        M = np.stack(mats, axis=1) if mats else np.zeros((fr.nrows, 0))
        if op == "mean":
            vals = np.nanmean(M, axis=1) if na_rm else M.mean(axis=1)
        elif op == "sum":
            vals = np.nansum(M, axis=1) if na_rm else M.sum(axis=1)
        elif op == "min":
            vals = np.nanmin(M, axis=1) if na_rm else M.min(axis=1)
        elif op == "max":
            vals = np.nanmax(M, axis=1) if na_rm else M.max(axis=1)
        elif op == "median":
            vals = np.nanmedian(M, axis=1) if na_rm else \
                np.median(M, axis=1)
        else:
            ddof_fn = np.nanstd if na_rm else np.std
            vals = ddof_fn(M, axis=1, ddof=1)
            if op == "var":
                vals = vals ** 2
        return Frame([op], [Vec(vals.astype(np.float32))])
    if axis_form:
        # one row of per-column values; without na_rm a column holding
        # an NA gives NA (AstMean.java:68)
        def col_val(v):
            if v.is_categorical:
                return np.nan
            if not na_rm and float(v.rollups.nacnt) > 0:
                return np.nan
            return red(v)
        return Frame(list(fr.names),
                     [Vec(np.array([col_val(v)], np.float32))
                      for v in fr.vecs])
    return _reduce_all(red, fr)


def _ifelse(cond, a, b, dev) -> Frame:
    """(ifelse cond yes no) on the device: the first column of each
    frame operand, uploaded once."""
    cf = _as_frame(cond)
    seen: Dict[int, torch.Tensor] = {}

    def first_col(x):
        if id(x) not in seen:
            seen[id(x)] = _upload(x, dev, [0])[:, 0]
        return seen[id(x)]

    cv = first_col(cf)
    av = first_col(a) if isinstance(a, Frame) else _full(cv, a)
    bv = first_col(b) if isinstance(b, Frame) else _full(cv, b)
    out = torch.where(cv != 0, av, bv)
    return _numeric_frame(["ifelse"], _download(out[:, None]))


def _asfactor(v: Vec) -> Vec:
    """A numeric column as a categorical: its distinct values sorted,
    labelled by ``str`` of the column's float (``"3"`` for a whole
    number)."""
    if v.is_categorical:
        return v
    data = v.to_numpy()
    na = np.isnan(data)
    vals = np.unique(data[~na])
    # every non-NA value is one of vals: its position there is its code
    codes = np.where(na, -1, np.searchsorted(vals, data)).astype(np.int32)
    dom = [str(int(x)) if x == int(x) else str(x) for x in vals]
    return Vec(codes, T_CAT, domain=dom)


def _na_omit(fr: Frame, dev) -> Frame:
    """The rows without an NA in any column."""
    if device_munge_enabled() and frame_device_ok(fr):
        # categorical NA codes are NaN in as_float; the rows compact on
        # the device
        keep = ~np.isnan(np.stack([v.as_float() for v in fr.vecs],
                                  axis=1)).any(axis=1)
        return filter_rows(fr, keep, device=dev)
    keep = np.ones(fr.nrows, bool)
    for v in fr.vecs:
        if v.data is None:
            continue
        d = v.to_numpy()
        keep &= (d >= 0) if v.is_categorical else ~np.isnan(d)
    return _row_select_host(fr, np.flatnonzero(keep))


# ---------------------------------------------------------------------------
# sort / merge / group-by / table (reference: rapids/Merge.java,
# RadixOrder.java, ast/prims/mungers/AstGroup.java)
# ---------------------------------------------------------------------------


def _sort_keys(fr: Frame, idxs, ascending) -> np.ndarray:
    keys = []
    for j, asc in zip(reversed(idxs), reversed(ascending)):
        v = fr.vecs[j]
        k = np.asarray(v.to_numpy(), np.float64)
        na = np.isnan(k)
        if v.type == T_CAT:
            na = na | (k < 0)       # the categorical NA code is -1
        k = k if asc else -k
        # NAs first in both directions (RadixOrder's NA placement)
        keys.append(np.where(na, -np.inf, k))
    return np.lexsort(keys)


def _sort(node, env):
    """(sort fr [cols] [ascending]) — RadixOrder.java.  Columns by index
    or by name (the client sends names: frame.sort(by=['y']))."""
    fr = _as_frame(_eval(node[1], env))
    idxs = [fr.names.index(x[1]) if isinstance(x, tuple) and
            x[0] == "str" else int(x) for x in node[2][1]]
    asc = [bool(int(x)) for x in node[3][1]] if len(node) > 3 \
        else [True] * len(idxs)
    if device_munge_enabled() and frame_device_ok(fr):
        return oom_ladder(
            "munge.sort", lambda: sort_frame(fr, idxs, asc, device=env.dev),
            host_fallback=lambda: _sort_host(fr, idxs, asc))
    return _sort_host(fr, idxs, asc)


def _sort_host(fr: Frame, idxs, asc) -> Frame:
    """The host route: numpy's lexsort over the key columns."""
    return _row_select_host(fr, _sort_keys(fr, idxs, asc))


def _key_codes(fr: Frame, cols: List[int]):
    """Rows -> dense group codes over the key columns.  Numeric NaN keys
    become a -inf sentinel, so all NA rows form one group that sorts
    first; the categorical NA code -1 is already one first group."""
    mats = []
    for j in cols:
        v = fr.vecs[j]
        d = np.asarray(v.to_numpy(), np.float64)
        if not v.is_categorical:
            d = np.where(np.isnan(d), -np.inf, d)
        mats.append(d)
    stacked = np.stack(mats, axis=1)
    uniq, inv = np.unique(stacked, axis=0, return_inverse=True)
    return uniq, inv.ravel()


def _merge(node, env):
    """(merge left right all_x all_y [by_x] [by_y] method) — the radix
    join (rapids/Merge.java, BinaryMerge.java)."""
    L = _as_frame(_eval(node[1], env))
    R = _as_frame(_eval(node[2], env))
    all_x = bool(int(_eval(node[3], env)))
    all_y = bool(int(_eval(node[4], env)))
    by_x = [int(x) for x in node[5][1]] if len(node) > 5 and node[5][1] \
        else None
    by_y = [int(x) for x in node[6][1]] if len(node) > 6 and node[6][1] \
        else None
    if by_x is None:
        common = [n for n in L.names if n in R.names]
        by_x = [L.names.index(n) for n in common]
        by_y = [R.names.index(n) for n in common]
    if device_munge_enabled() and merge_device_ok(L, R, by_x, by_y):
        return oom_ladder(
            "munge.merge",
            lambda: merge_frames(L, R, all_x, all_y, by_x, by_y,
                                 device=env.dev),
            host_fallback=lambda: _merge_host(L, R, all_x, all_y, by_x,
                                              by_y))
    return _merge_host(L, R, all_x, all_y, by_x, by_y)


def _merge_host(L: Frame, R: Frame, all_x: bool, all_y: bool,
                by_x: List[int], by_y: List[int]) -> Frame:
    """The host route: a sort-merge over dense codes of the joined key
    strings (categorical keys match by label, numeric by value)."""
    def key_matrix(fr, cols):
        out = []
        for j in cols:
            v = fr.vecs[j]
            if v.is_categorical:
                out.append(np.asarray(
                    [v.domain[c] if c >= 0 else "\0NA" for c in
                     v.to_numpy()], object))
            else:
                out.append(np.asarray(v.to_numpy(), object))
        return np.stack(out, axis=1)

    lk = key_matrix(L, by_x)
    rk = key_matrix(R, by_y)
    both = np.concatenate([lk, rk])
    flat = np.asarray(["\1".join(map(str, row)) for row in both])
    uniq, inv = np.unique(flat, return_inverse=True)
    lcode, rcode = inv[: len(lk)], inv[len(lk):]
    # the right side's rows by code
    r_order = np.argsort(rcode, kind="stable")
    r_sorted = rcode[r_order]
    starts = np.searchsorted(r_sorted, np.arange(len(uniq)), side="left")
    ends = np.searchsorted(r_sorted, np.arange(len(uniq)), side="right")
    li, ri = [], []
    matched_r = np.zeros(len(rk), bool)
    for i, c in enumerate(lcode):
        lo, hi = starts[c], ends[c]
        if hi > lo:
            for r in r_order[lo:hi]:
                li.append(i)
                ri.append(r)
                matched_r[r] = True
        elif all_x:                      # left outer: keep unmatched left
            li.append(i)
            ri.append(-1)
    if all_y:
        for r in np.flatnonzero(~matched_r):
            li.append(-1)
            ri.append(int(r))
    li = np.asarray(li, np.int64)
    ri = np.asarray(ri, np.int64)

    names, vecs = [], []
    r_by = set(by_y)
    for j, n in enumerate(L.names):
        v = L.vecs[j]
        d = v.to_numpy()
        take = np.where(li >= 0, li, 0)
        out = d[take]
        if v.is_categorical:
            out = np.where(li >= 0, out, -1).astype(np.int32)
            dom = list(v.domain)
            # right-only rows take their keys from the right frame; the
            # domain is the union, so unseen right labels survive
            if j in by_x and (li < 0).any():
                jr = by_y[by_x.index(j)]
                rv = R.vecs[jr]
                rd = rv.to_numpy()
                dom = dom + [x for x in rv.domain if x not in set(dom)]
                remap = _domain_remap(rv.domain, dom)
                out = np.where(li >= 0, out,
                               remap[np.clip(rd[np.where(ri >= 0, ri, 0)],
                                             -1, None)]).astype(np.int32)
            vecs.append(Vec(out, T_CAT, domain=dom))
        else:
            out = np.where(li >= 0, out, np.nan)
            if j in by_x and (li < 0).any():
                jr = by_y[by_x.index(j)]
                rd = np.asarray(R.vecs[jr].to_numpy(), np.float64)
                out = np.where(li >= 0, out,
                               rd[np.where(ri >= 0, ri, 0)])
            vecs.append(Vec(out.astype(np.float32), v.type))
        names.append(n)
    for j, n in enumerate(R.names):
        if j in r_by:
            continue
        v = R.vecs[j]
        d = v.to_numpy()
        take = np.where(ri >= 0, ri, 0)
        out = d[take]
        if v.is_categorical:
            out = np.where(ri >= 0, out, -1).astype(np.int32)
            vecs.append(Vec(out, T_CAT, domain=list(v.domain)))
        else:
            out = np.where(ri >= 0, out, np.nan)
            vecs.append(Vec(out.astype(np.float32), v.type))
        names.append(n if n not in names else f"{n}_y")
    return Frame(names, vecs)


def _domain_remap(src_dom, dst_dom):
    """Map ``src_dom``'s codes into ``dst_dom`` (-1 for unseen); index -1
    (NA) maps to -1 through the last slot."""
    lut = {d: i for i, d in enumerate(dst_dom)}
    remap = np.full(len(src_dom) + 1, -1, np.int32)
    for i, d in enumerate(src_dom):
        remap[i] = lut.get(d, -1)
    return remap


_GB_AGGS = ("min", "max", "mean", "sum", "sd", "var", "nrow", "count",
            "median", "mode")


def _groupby(node, env):
    """(GB fr [group_idxs] agg col na_method ...) — AstGroup.java.
    ``mode`` of a numeric column, and frames the device verbs do not
    take, go to the host route."""
    fr = _as_frame(_eval(node[1], env))
    gcols = [int(x) for x in node[2][1]]
    aggs = []
    i = 3
    while i < len(node):
        a = _lit(node[i])
        if a not in _GB_AGGS:
            break
        if i + 1 >= len(node):
            raise ValueError(f"groupby agg {a!r} is missing its column")
        col = node[i + 1]
        col_i = int(col) if isinstance(col, float) else \
            fr.names.index(_lit(col))
        na = _lit(node[i + 2]) if i + 2 < len(node) else "all"
        aggs.append((a, col_i, na))
        i += 3
    if device_munge_enabled() and frame_device_ok(fr) and \
            all(a in DEVICE_AGGS for a, _c, _n in aggs) and \
            mode_device_eligible(fr, aggs):
        return oom_ladder(
            "munge.groupby",
            lambda: groupby_frame(fr, gcols, aggs, device=env.dev),
            host_fallback=lambda: _groupby_host(fr, gcols, aggs))
    return _groupby_host(fr, gcols, aggs)


def _groupby_host(fr: Frame, gcols: List[int], aggs) -> Frame:
    """The host route: bincounts over numpy's group codes."""
    uniq, inv = _key_codes(fr, gcols)
    G = len(uniq)
    names, vecs = [], []
    for k, j in enumerate(gcols):
        v = fr.vecs[j]
        col = uniq[:, k]
        if v.is_categorical:
            vecs.append(Vec(col.astype(np.int32), T_CAT,
                            domain=list(v.domain)))
        else:
            # the -inf NA-group sentinel reads back as NaN
            col = np.where(np.isneginf(col), np.nan, col)
            vecs.append(Vec(col.astype(np.float32), v.type))
        names.append(fr.names[j])
    counts = np.bincount(inv, minlength=G)
    for a, col_i, _na in aggs:
        v_agg = fr.vecs[col_i]
        d = np.asarray(v_agg.to_numpy(), np.float64)
        ok = (d >= 0) if v_agg.is_categorical else ~np.isnan(d)
        di = np.where(ok, d, 0.0)
        cnt_ok = np.bincount(inv, weights=ok.astype(np.float64),
                             minlength=G)
        if a in ("nrow", "count"):
            out = counts.astype(np.float64)
        elif a == "sum":
            out = np.bincount(inv, weights=di, minlength=G)
        elif a == "mean":
            out = np.bincount(inv, weights=di, minlength=G) / \
                np.maximum(cnt_ok, 1)
        elif a in ("sd", "var"):
            m = np.bincount(inv, weights=di, minlength=G) / \
                np.maximum(cnt_ok, 1)
            ss = np.bincount(inv, weights=di * di, minlength=G)
            var = ss / np.maximum(cnt_ok, 1) - m * m
            var = var * cnt_ok / np.maximum(cnt_ok - 1, 1)
            out = np.sqrt(np.maximum(var, 0)) if a == "sd" else \
                np.maximum(var, 0)
        elif a in ("min", "max"):
            out = np.full(G, np.inf if a == "min" else -np.inf)
            ufunc = np.minimum if a == "min" else np.maximum
            ufunc.at(out, inv[ok], d[ok])
            out[~np.isfinite(out)] = np.nan
        else:                                       # median, mode
            out = np.full(G, np.nan)
            dd = np.where(ok, d, np.nan)      # NA codes filter out too
            order = np.argsort(inv, kind="stable")
            bounds = np.searchsorted(inv[order], np.arange(G + 1))
            for g in range(G):
                seg = dd[order[bounds[g]: bounds[g + 1]]]
                seg = seg[~np.isnan(seg)]
                if len(seg):
                    out[g] = np.median(seg) if a == "median" else \
                        np.bincount(seg.astype(np.int64)).argmax()
        names.append(f"{a}_{fr.names[col_i]}")
        vecs.append(Vec(out.astype(np.float32)))
    return Frame(names, vecs)


def _table(node, env):
    """(table fr [fr2] [dense]) — level cross-tabulation (AstTable; the
    client always appends the dense flag: frame.py table())."""
    args = [_eval(a, env) for a in node[1:]]
    dense = True
    if args and not isinstance(args[-1], Frame):
        try:
            dense = bool(float(args[-1]))
        except (TypeError, ValueError):
            dense = bool(args[-1])
        args.pop()
    fr = _as_frame(args[0])
    v1 = fr.vecs[0]
    d1 = v1.to_numpy()
    if fr.ncols == 1 and len(args) == 1:
        vals, cnts = np.unique(d1[d1 >= 0] if v1.is_categorical else
                               d1[~np.isnan(d1)], return_counts=True)
        if v1.is_categorical:
            c1 = Vec(vals.astype(np.int32), T_CAT, domain=list(v1.domain))
        else:
            c1 = Vec(vals.astype(np.float32))
        return Frame([fr.names[0], "Count"],
                     [c1, Vec(cnts.astype(np.float32))])
    v2 = fr.vecs[1] if fr.ncols > 1 else _as_frame(args[1]).vecs[0]
    d2 = v2.to_numpy()
    ok = ((d1 >= 0) if v1.is_categorical else ~np.isnan(d1)) & \
        ((d2 >= 0) if v2.is_categorical else ~np.isnan(d2))
    pairs = np.stack([d1[ok], d2[ok]], axis=1)
    uniq, cnts = np.unique(pairs, axis=0, return_counts=True)
    if not dense and v1.is_categorical and v2.is_categorical:
        # sparse=FALSE: every level pair, zero counts included
        full = np.array([(a, b) for a in range(len(v1.domain))
                         for b in range(len(v2.domain))], np.float64)
        cmap = {(a, b): c for (a, b), c in
                zip(map(tuple, uniq), cnts)}
        uniq = full
        cnts = np.array([cmap.get(tuple(p), 0) for p in full])
    c1 = Vec(uniq[:, 0].astype(np.int32), T_CAT,
             domain=list(v1.domain)) if v1.is_categorical else \
        Vec(uniq[:, 0].astype(np.float32))
    c2 = Vec(uniq[:, 1].astype(np.int32), T_CAT,
             domain=list(v2.domain)) if v2.is_categorical else \
        Vec(uniq[:, 1].astype(np.float32))
    return Frame([fr.names[0], "col2", "Counts"],
                 [c1, c2, Vec(cnts.astype(np.float32))])


# ---------------------------------------------------------------------------
# update and impute
# ---------------------------------------------------------------------------


def _update(node, env):
    """(:= fr rhs col_idxs row_sel) — a column or cell update into a new
    frame that shares the untouched columns."""
    fr = _as_frame(_eval(node[1], env))
    rhs = _eval(node[2], env)
    cols = _col_indices(fr, node[3] if isinstance(node[3], tuple)
                        else _eval(node[3], env))
    row_sel = node[4] if len(node) > 4 else None
    out = Frame(list(fr.names), list(fr.vecs))
    for k, j in enumerate(cols):
        old_vec = out.vecs[j]
        if isinstance(rhs, Frame):
            newv = rhs.vecs[k if rhs.ncols > 1 else 0]
        elif old_vec.is_categorical:
            newv = Vec(np.full(fr.nrows, int(rhs), np.int32), T_CAT,
                       domain=list(old_vec.domain))
        else:
            newv = Vec(np.full(fr.nrows, float(rhs), np.float32))
        all_rows = row_sel is None or (
            isinstance(row_sel, tuple) and
            (row_sel[1] == "all" or row_sel[1] == []))  # [] = every row
        if not all_rows:
            sel = _eval(row_sel, env) if isinstance(row_sel, list) \
                else row_sel
            old = old_vec.to_numpy().astype(np.float64)
            if isinstance(sel, Frame):
                mask = np.asarray(sel.vecs[0].data)[: fr.nrows] > 0
            else:
                if isinstance(sel, tuple):
                    idx = _expand_numlist(
                        sel[1] if sel[0] == "numlist" else [sel])
                else:
                    idx = [int(sel)]
                mask = np.zeros(fr.nrows, bool)
                mask[idx] = True
            nv = np.asarray(newv.to_numpy(), np.float64)
            merged = old.copy()
            n_sel = int(mask.sum())
            if len(nv) == fr.nrows:
                merged[mask] = nv[mask]
            elif len(nv) == n_sel:
                # a right side sized to the selection: in selection order
                merged[np.flatnonzero(mask)] = nv
            else:
                merged[mask] = nv[0] if len(nv) else np.nan
            if old_vec.is_categorical:
                newv = Vec(merged.astype(np.int32), T_CAT,
                           domain=list(old_vec.domain))
            else:
                newv = Vec(merged.astype(np.float32), old_vec.type)
        out.vecs[j] = newv
    return out


def _impute(node, env):
    """(h2o.impute fr col method ...) — mean, median or mode imputation
    of one column (ast/prims/advmath/AstImpute)."""
    fr = _as_frame(_eval(node[1], env))
    col = int(_eval(node[2], env))
    method = _lit(node[3]) if len(node) > 3 else "mean"
    v = fr.vecs[col]
    d = np.asarray(v.to_numpy(), np.float64)
    if v.is_categorical:
        vals = d[d >= 0]
        fill = float(np.bincount(vals.astype(np.int64)).argmax()) \
            if len(vals) else -1
        filled = np.where(d < 0, fill, d)
        newv = Vec(filled.astype(np.int32), T_CAT, domain=list(v.domain))
    else:
        vals = d[~np.isnan(d)]
        if method == "median":
            fill = float(np.median(vals)) if len(vals) else np.nan
        elif method == "mode":
            if len(vals):
                uq, cn = np.unique(vals, return_counts=True)
                fill = float(uq[cn.argmax()])
            else:
                fill = np.nan
        else:
            fill = float(vals.mean()) if len(vals) else np.nan
        filled = np.where(np.isnan(d), fill, d)
        newv = Vec(filled.astype(np.float32), v.type)
    out = Frame(list(fr.names), list(fr.vecs))
    out.vecs[col] = newv
    return out


# ---------------------------------------------------------------------------
# shared helpers of the string, time and model ops
# ---------------------------------------------------------------------------


def _labels_of(v: Vec) -> List[Optional[str]]:
    """The label string of each row of a string or categorical column
    (None for NA)."""
    if v.type == T_STR:
        return [None if x is None else str(x) for x in v.host_data]
    if v.is_categorical:
        dom = list(v.domain or [])
        codes = np.asarray(v.to_numpy())[: v.nrows]
        lut = np.asarray(dom + [None], dtype=object)
        return lut[np.where(codes >= 0, codes, len(dom))].tolist()
    raise TypeError("expected a string/categorical column")


def _numlist_vals(node, env):
    """A bracket list's numbers (``cut`` reads its breaks so)."""
    return [float(x) for x in _mixed_list(node, env)]


def _mixed_list(node, env):
    """A bracket list as Python values, strings kept as strings (a span
    ``lo:hi`` gives lo..hi inclusive, as the reference reads it)."""
    if isinstance(node, tuple) and node[0] == "numlist":
        out = []
        for item in node[1]:
            if isinstance(item, tuple) and item[0] == "span":
                lo, hi = item[1], item[2]
                out.extend(float(x) for x in range(int(lo), int(hi) + 1))
            elif isinstance(item, tuple):
                out.append(item[1])
            else:
                out.append(item)
        return out
    if isinstance(node, tuple) and node[0] == "str":
        return [node[1]]
    ev = _eval(node, env)
    if ev is None:
        return []
    if isinstance(ev, (int, float, str)):
        return [ev]
    return list(ev)


def _model_arg(node, env):
    """The model a node names, from the DKV."""
    mid = str(_lit(node))
    m = dkv().get(mid)
    if m is None:
        raise ValueError(f"model {mid!r} not found")
    return m


def _distinct_labels(v: Vec):
    """(the distinct labels of a string or categorical column, None for
    NA among them; each row's index into them).  The ops below compute a
    function of the label once a distinct label and gather it to the
    rows: the reference's per-row answers, as the functions are pure."""
    if v.is_categorical:
        dom = list(v.domain or [])
        codes = np.asarray(v.to_numpy())[: v.nrows]
        return dom + [None], np.where(codes >= 0, codes, len(dom))
    if v.type != T_STR:
        raise TypeError("expected a string/categorical column")
    index: Dict[Any, int] = {}
    inv = np.fromiter((index.setdefault(x, len(index))
                       for x in v.host_data), np.int64, count=v.nrows)
    return [None if x is None else str(x) for x in index], inv


def _label_floats(v: Vec, fn) -> Vec:
    """A float32 column of ``fn`` of each row's label, NaN for NA."""
    labels, inv = _distinct_labels(v)
    return Vec(np.asarray([np.nan if s is None else fn(s) for s in labels],
                          np.float32)[inv])


# ---------------------------------------------------------------------------
# string ops (ast/prims/string/*), on the host
# ---------------------------------------------------------------------------


def _map_strings(v: Vec, fn) -> Vec:
    """A str -> str function over a column: a string column maps its
    cells, a categorical its domain (the reference's in-place domain
    rewrite); labels that collide merge, their codes remapped to the
    sorted new domain."""
    if v.type == T_STR:
        labels, inv = _distinct_labels(v)
        return Vec(np.asarray([None if s is None else fn(s) for s in labels],
                              object)[inv].tolist(), T_STR)
    if v.is_categorical:
        new_dom = [fn(d) for d in v.domain]
        uniq = sorted(set(new_dom))
        lut = {d: i for i, d in enumerate(uniq)}
        remap = np.asarray([lut[d] for d in new_dom], np.int32)
        codes = v.to_numpy()
        new_codes = np.where(codes >= 0, remap[np.clip(codes, 0, None)], -1)
        return Vec(new_codes.astype(np.int32), T_CAT, domain=uniq)
    raise TypeError("string op on a numeric column")


def _string_op(op, node, env):
    fr = _as_frame(_eval(node[1], env))
    args = [_lit(x) if isinstance(x, tuple) else x for x in node[2:]]
    if op in ("nchar", "length"):
        return Frame(list(fr.names), [_label_floats(v, len)
                                      for v in fr.vecs])
    if op == "countmatches":
        pat = str(args[0])
        return Frame(list(fr.names),
                     [_label_floats(v, lambda s: s.count(pat))
                      for v in fr.vecs])
    if op == "strsplit":
        return _strsplit(fr.vecs[0], str(args[0]))
    if op == "substring":
        lo = int(args[0])
        hi = int(args[1]) if len(args) > 1 and args[1] is not None else None

        def fn(s):
            return s[lo:hi]
    elif op in ("replacefirst", "sub"):
        pat, rep = str(args[0]), str(args[1])

        def fn(s):
            return re.sub(pat, rep, s, count=1)
    elif op in ("replaceall", "gsub"):
        pat, rep = str(args[0]), str(args[1])

        def fn(s):
            return re.sub(pat, rep, s)
    elif op == "trim":
        fn = str.strip
    elif op in ("lstrip", "rstrip"):
        chars = str(args[0]) if args else None
        strip = str.lstrip if op == "lstrip" else str.rstrip

        def fn(s):
            return strip(s, chars)
    elif op == "toupper":
        fn = str.upper
    else:                                               # tolower
        fn = str.lower
    return Frame(list(fr.names), [_map_strings(v, fn) for v in fr.vecs])


def _strsplit(v: Vec, pat: str) -> Frame:
    """One categorical column a part, as wide as the row with the most
    parts; each column's domain its sorted parts."""
    labels, inv = _distinct_labels(v)
    # only the labels that rows hold count: a level no row holds adds
    # neither parts nor width
    held, inv = np.unique(inv, return_inverse=True)
    vals = [None if labels[i] is None else re.split(pat, labels[i])
            for i in held]
    width = max((len(x) for x in vals if x), default=1)
    cols = []
    for j in range(width):
        col = [x[j] if x and j < len(x) else None for x in vals]
        dom = sorted({c for c in col if c is not None})
        lut = {d: i for i, d in enumerate(dom)}
        codes = np.asarray([lut.get(c, -1) if c is not None else -1
                            for c in col], np.int32)
        cols.append(Vec(codes[inv], T_CAT, domain=dom))
    return Frame([f"C{j + 1}" for j in range(width)], cols)


# ---------------------------------------------------------------------------
# time parts and dates, on the host over the exact float64 milliseconds
# ---------------------------------------------------------------------------


def _time_part(op, node, env):
    """A calendar part of each cell's epoch milliseconds (UTC).  ``week``
    is ``(day of year) // 7 + 1``, as the reference's dispatch computes
    it: its ISO-week op is never reached."""
    fr = _as_frame(_eval(node[1], env))
    out = []
    for v in fr.vecs:
        ms = np.asarray(v.to_numpy(), np.float64)
        ok = ~np.isnan(ms)
        dt = np.full(len(ms), np.datetime64("NaT"), "datetime64[ms]")
        dt[ok] = np.asarray(ms[ok], "int64").view("datetime64[ms]")
        Y = dt.astype("datetime64[Y]")
        M = dt.astype("datetime64[M]")
        D = dt.astype("datetime64[D]")
        if op == "year":
            vals = Y.astype(int) + 1970
        elif op == "month":
            vals = (M - Y).astype(int) + 1
        elif op == "day":
            vals = (D - M).astype(int) + 1
        elif op == "dayOfWeek":
            vals = (D.astype(int) + 3) % 7          # 1970-01-01: Thursday
        elif op == "hour":
            vals = (dt - D).astype("timedelta64[h]").astype(int)
        elif op == "minute":
            vals = (dt - D).astype("timedelta64[m]").astype(int) % 60
        elif op == "second":
            vals = (dt - D).astype("timedelta64[s]").astype(int) % 60
        else:                                       # week
            vals = (D - Y).astype(int) // 7 + 1
        out.append(Vec(np.where(ok, vals, np.nan).astype(np.float32)))
    return Frame(list(fr.names), out)


def _op_as_date(node, env):
    """(as.Date fr format): string and categorical columns parsed to
    epoch milliseconds (SimpleDateFormat's letters mapped to strptime's;
    NaN where a label does not parse), numeric and time columns cut to
    the day."""
    import datetime as _dt
    fr = _as_frame(_eval(node[1], env))
    fmt = _lit(node[2])
    py_fmt = (str(fmt).replace("yyyy", "%Y").replace("yy", "%y")
              .replace("MM", "%m").replace("dd", "%d")
              .replace("HH", "%H").replace("mm", "%M").replace("ss", "%S"))

    def parse_ms(s):
        try:
            dt = _dt.datetime.strptime(s, py_fmt)
            return dt.replace(tzinfo=_dt.timezone.utc).timestamp() * 1000.0
        except ValueError:
            return np.nan

    out = []
    for v in fr.vecs:
        if v.type == T_TIME or (v.is_numeric and not v.is_categorical):
            ms = np.asarray(v.to_numpy(), np.float64)[: fr.nrows]
            day = np.floor(ms / 86400000.0) * 86400000.0
            out.append(Vec(np.where(np.isnan(ms), np.nan, day), T_TIME))
        else:
            labels, inv = _distinct_labels(v)
            out.append(Vec(np.asarray([np.nan if s is None else parse_ms(s)
                                       for s in labels], np.float64)[inv],
                           T_TIME))
    return Frame(list(fr.names), out)


def _mktime_like(node, env, zero_based: bool):
    """(mktime y M d H m s ms) and (moment ...): numbers or one-column
    frames to epoch milliseconds (UTC); mktime's month and day are
    0-based (AstMktime.java), moment's 1-based.  NaN where a cell makes
    no date."""
    import datetime as _dt
    args = [_eval(a, env) for a in node[1:8]]
    while len(args) < 7:
        args.append(0.0)
    nrows = max([a.nrows for a in args if isinstance(a, Frame)], default=1)

    def col(a):
        if isinstance(a, Frame):
            return np.asarray(a.vecs[0].to_numpy(), np.float64)[:nrows]
        return np.full(nrows, float(a) if a is not None else 0.0)

    y, mo, d, h, mi, s, ms = (col(a) for a in args)
    off = 1 if zero_based else 0
    out = np.full(nrows, np.nan)
    for i in range(nrows):
        try:
            dt = _dt.datetime(int(y[i]), int(mo[i]) + off, int(d[i]) + off,
                              int(h[i]), int(mi[i]), int(s[i]),
                              tzinfo=_dt.timezone.utc)
            out[i] = dt.timestamp() * 1000.0 + float(ms[i])
        except (ValueError, OverflowError):
            out[i] = np.nan
    return Frame(["mktime"], [Vec(out, T_TIME)])


# ---------------------------------------------------------------------------
# grep, strlen, characters, distances, tokens, tf-idf, timezones
# ---------------------------------------------------------------------------


def _op_grep(node, env):
    """(grep fr regex ignore_case invert output_logical): the rows whose
    label matches, as indices or as a 0/1 column."""
    fr = _as_frame(_eval(node[1], env))
    pat = _lit(node[2])
    icase = bool(int(_eval(node[3], env))) if len(node) > 3 else False
    invert = bool(int(_eval(node[4], env))) if len(node) > 4 else False
    logical = bool(int(_eval(node[5], env))) if len(node) > 5 else False
    rx = re.compile(str(pat), re.IGNORECASE if icase else 0)
    labels, inv = _distinct_labels(fr.vecs[0])
    hit = np.asarray([s is not None and bool(rx.search(s))
                      for s in labels], bool)[inv]
    if invert:
        hit = ~hit
    if logical:
        return Frame([fr.names[0]], [Vec(hit.astype(np.float32))])
    return Frame([fr.names[0]],
                 [Vec(np.flatnonzero(hit).astype(np.float64))])


def _op_strlen(node, env):
    fr = _as_frame(_eval(node[1], env))
    return Frame(list(fr.names), [_label_floats(v, len) for v in fr.vecs])


def _op_as_character(node, env):
    """(as.character fr): labels of a categorical; a number by
    ``str(int(x))`` when whole, else ``repr`` of its float64 value (a
    float32 0.1 is '0.10000000149011612')."""
    fr = _as_frame(_eval(node[1], env))
    vecs = []
    for v in fr.vecs:
        if v.type == T_STR:
            vecs.append(v)
        elif v.is_categorical:
            vecs.append(Vec(_labels_of(v), T_STR))
        else:
            x = np.asarray(v.to_numpy(), np.float64)
            whole = (np.isfinite(x) & (x == np.floor(x))).tolist()
            vecs.append(Vec([None if c != c else
                             (str(int(c)) if w else repr(c))
                             for c, w in zip(x.tolist(), whole)], T_STR))
    return Frame(list(fr.names), vecs)


def _op_is_character(node, env):
    fr = _as_frame(_eval(node[1], env))
    return [float(v.type == T_STR) for v in fr.vecs]


def _levenshtein(a: str, b: str) -> float:
    if a == b:
        return 0.0
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return float(prev[-1])


def _lcs_len(a: str, b: str) -> int:
    prev = [0] * (len(b) + 1)
    for ca in a:
        cur = [0]
        for j, cb in enumerate(b, 1):
            cur.append(prev[j - 1] + 1 if ca == cb
                       else max(prev[j], cur[j - 1]))
        prev = cur
    return prev[-1]


def _op_str_distance(node, env):
    """(strDistance fr y measure compare_empty): Levenshtein (``lv``),
    the LCS distance or Jaccard's over character sets, row by row; NaN
    for NA, and for an empty string unless ``compare_empty``."""
    fx = _as_frame(_eval(node[1], env))
    fy = _as_frame(_eval(node[2], env))
    measure = str(_lit(node[3])).lower()
    cmp_empty = bool(_eval(node[4], env))

    def dist(a, b):
        if a is None or b is None:
            return np.nan
        if (not a or not b) and not cmp_empty:
            return np.nan
        if measure in ("lv", "levenshtein"):
            return _levenshtein(a, b)
        if measure == "lcs":
            return float(len(a) + len(b) - 2 * _lcs_len(a, b))
        if measure == "jaccard":
            sa, sb = set(a), set(b)
            u = sa | sb
            return 1.0 - (len(sa & sb) / len(u) if u else 1.0)
        raise ValueError(f"strDistance measure {measure!r} not "
                         "supported (lv, lcs, jaccard)")

    la = _labels_of(fx.vecs[0])
    lb = _labels_of(fy.vecs[0])
    vals = np.asarray([dist(a, b) for a, b in zip(la, lb)], np.float32)
    return Frame(["distance"], [Vec(vals)])


def _op_tokenize(node, env):
    """(tokenize fr split): every string cell split into one word column,
    an NA row after each source row (Word2Vec's input)."""
    fr = _as_frame(_eval(node[1], env))
    rx = re.compile(str(_lit(node[2])))
    col_labels = [_labels_of(v) if v.type == T_STR or v.is_categorical
                  else None for v in fr.vecs]
    out: List[Optional[str]] = []
    for i in range(fr.nrows):
        for labels in col_labels:
            s = labels[i] if labels is not None else None
            if s:
                out.extend(t for t in rx.split(s) if t)
        out.append(None)
    return Frame(["C1"], [Vec(out, T_STR)])


def _op_num_valid_substrings(node, env):
    """(num_valid_substrings fr path): per cell, how many of its
    substrings are lines of the words file."""
    fr = _as_frame(_eval(node[1], env))
    with open(str(_lit(node[2]))) as f:
        words = {ln.strip() for ln in f if ln.strip()}

    def count(s):
        return float(sum(s[i:j] in words for i in range(len(s))
                         for j in range(i + 1, len(s) + 1)))

    return Frame(list(fr.names), [_label_floats(v, count) for v in fr.vecs])


def _op_tf_idf(node, env):
    """(tf-idf fr doc_id_idx text_idx preprocess case_sensitive):
    [DocID, Word, TF, IDF, TF_IDF] rows sorted by (doc, word), IDF =
    log((N + 1) / (df + 1)); ``preprocess`` splits texts on whitespace,
    else a text is one word."""
    from collections import Counter
    fr = _as_frame(_eval(node[1], env))
    doc_i = int(_eval(node[2], env))
    text_i = int(_eval(node[3], env))
    preprocess = bool(_eval(node[4], env))
    case_sensitive = bool(_eval(node[5], env))
    dv, tv = fr.vecs[doc_i], fr.vecs[text_i]
    doc_ids = dv.to_numpy()
    if tv.host_data is not None:
        texts = ["" if s is None else str(s) for s in tv.host_data]
    elif tv.is_categorical:
        texts = ["" if s is None else s for s in _labels_of(tv)]
    else:
        raise ValueError("tf-idf wants a string/categorical text column")
    tf: Counter = Counter()
    doc_words: Dict[str, set] = {}
    for d, t in zip(doc_ids, texts):
        d = float(d)
        if not case_sensitive:
            t = t.lower()
        for w in (t.split() if preprocess else ([t] if t else [])):
            tf[(d, w)] += 1
            doc_words.setdefault(w, set()).add(d)
    n_docs = len(set(float(d) for d in doc_ids))
    rows = sorted(tf.items())
    words_dom = sorted(doc_words)
    widx = {w: i for i, w in enumerate(words_dom)}
    out_tf = np.asarray([c for _k, c in rows], np.float32)
    out_idf = np.asarray(
        [math.log((n_docs + 1.0) / (len(doc_words[w]) + 1.0))
         for (_d, w), _c in rows], np.float32)
    return Frame(
        ["DocID", "Word", "TF", "IDF", "TF_IDF"],
        [Vec(np.asarray([d for (d, _w), _c in rows], np.float32)),
         Vec(np.asarray([widx[w] for (_d, w), _c in rows], np.int32),
             T_CAT, domain=words_dom),
         Vec(out_tf), Vec(out_idf), Vec(out_tf * out_idf)])


def _op_list_timezones(node, env):
    import zoneinfo
    zones = sorted(zoneinfo.available_timezones())
    return Frame(["Timezones"], [Vec(np.arange(len(zones), dtype=np.int32),
                                     T_CAT, domain=zones)])


def _op_set_timezone(node, env):
    """(setTimeZone tz): the cluster timezone that naive date strings are
    parsed in (``core.device.set_timezone``, which refuses an unknown
    name)."""
    tz = _lit(node[1])
    set_timezone(tz)
    return tz


def _op_get_timezone(node, env):
    return timezone() or "UTC"


# ---------------------------------------------------------------------------
# ops over models in the DKV; a model scores on its own device
# ---------------------------------------------------------------------------


def _op_reset_threshold(node, env):
    """(model.reset.threshold model thr): set a binomial model's label
    threshold and return the old one."""
    m = _model_arg(node[1], env)
    thr = float(_eval(node[2], env))
    old = float(m.output.get("default_threshold", 0.5))
    if not 0.0 < thr < 1.0:
        raise ValueError(f"threshold must be in (0,1), got {thr}")
    m.output["default_threshold"] = thr
    return Frame(["threshold"], [Vec(np.asarray([old], np.float32))])


def _op_w2v_to_frame(node, env):
    """(word2vec.to.frame model): [Word, V1..VD]."""
    from h2o_tpu_torch.models.word2vec import Word2VecModel
    m = dkv().get(_lit(node[1]))
    if not isinstance(m, Word2VecModel):
        raise ValueError(f"no word2vec model {_lit(node[1])!r}")
    words = list(m.output["words"])
    W = np.asarray(m.output["vectors"], np.float32)
    vecs = [Vec(np.arange(len(words), dtype=np.int32), T_CAT,
                domain=[str(w) for w in words])]
    vecs += [Vec(W[:, j]) for j in range(W.shape[1])]
    return Frame(["Word"] + [f"V{i + 1}" for i in range(W.shape[1])], vecs)


def _op_segment_models_as_frame(node, env):
    """(segment_models_as_frame key): one row a segment."""
    from h2o_tpu_torch.models.segment import SegmentModels
    key = _lit(node[1])
    sm = dkv().get(key)
    if not isinstance(sm, SegmentModels):
        raise ValueError(f"no segment models under key {key}")
    return sm.to_frame()


def _op_rulefit_predict_rules(node, env):
    """(rulefit.predict.rules model fr [rule_ids]): a 0/1 column a rule,
    1 where the row satisfies the rule."""
    m = dkv().get(_lit(node[1]))
    fr = _as_frame(_eval(node[2], env))
    rule_ids = [str(s) for s in _mixed_list(node[3], env)]
    if m is None or m.output.get("rule_importance") is None:
        raise ValueError("rulefit.predict.rules needs a RuleFit model")
    rows = {str(r[0]): r for r in m.output["rule_importance"]}
    out_names, out_vecs = [], []
    for rid in rule_ids:
        if rid not in rows:
            raise ValueError(f"unknown rule id {rid!r}")
        out_names.append(rid)
        out_vecs.append(Vec(_eval_rule_text(str(rows[rid][3]), fr)
                            .astype(np.float32)))
    return Frame(out_names, out_vecs)


def _eval_rule_text(rule: str, fr: Frame) -> np.ndarray:
    """A rendered RuleFit rule over a frame: conjunctions of ``a < 1.5``
    comparisons (NA fails) and ``x in {l1, l2}`` level sets."""
    mask = np.ones(fr.nrows, bool)
    for cond in rule.split("&"):
        cond = cond.strip()
        if not cond or cond.lower() == "linear":
            continue
        m_in = re.match(r"(\S+)\s+in\s+\{([^}]*)\}", cond)
        if m_in:
            levels = {s.strip() for s in m_in.group(2).split(",")}
            mask &= np.asarray([s in levels if s is not None else False
                                for s in _labels_of(fr.vec(m_in.group(1)))],
                               bool)
            continue
        m_cmp = re.match(r"(\S+)\s*(<=|>=|<|>)\s*(-?[\d.eE+]+)", cond)
        if m_cmp:
            col, op_s, thr = m_cmp.groups()
            x = np.asarray(fr.vec(col).to_numpy(), np.float64)
            thr = float(thr)
            cmp = {"<": x < thr, "<=": x <= thr, ">": x > thr,
                   ">=": x >= thr}[op_s]
            mask &= np.where(np.isnan(x), False, cmp)
            continue
        raise ValueError(f"cannot evaluate rule fragment {cond!r}")
    return mask


def _op_pred_vs_actual_by_var(node, env):
    """(predicted.vs.actual.by.var model fr variable predicted): the mean
    prediction (the predictions frame's last column) and the mean
    response for each level of a categorical."""
    m = _model_arg(node[1], env)
    fr = _as_frame(_eval(node[2], env))
    var = str(_lit(node[3]))
    pf = _as_frame(_eval(node[4], env))
    if var not in fr.names:
        raise ValueError(f"column {var!r} not in frame")
    v = fr.vec(var)
    if not v.is_categorical:
        raise ValueError("predicted.vs.actual.by.var wants a "
                         "categorical variable")
    codes = np.asarray(v.to_numpy(), np.int64)
    pred = np.asarray(pf.vecs[-1].to_numpy(), np.float64)[: fr.nrows]
    yv = fr.vec(m.params.get("response_column"))
    act = np.asarray(yv.as_float() if yv.is_categorical else yv.to_numpy(),
                     np.float64)[: fr.nrows]
    card = len(v.domain or [])
    rows_p, rows_a = [], []
    for k in range(card):
        sel = codes == k
        okp = sel & ~np.isnan(pred)
        oka = sel & ~np.isnan(act)
        rows_p.append(float(pred[okp].mean()) if okp.any() else math.nan)
        rows_a.append(float(act[oka].mean()) if oka.any() else math.nan)
    return Frame([var, "predicted", "actual"],
                 [Vec(np.arange(card, dtype=np.int32), T_CAT,
                      domain=list(v.domain)),
                  Vec(np.asarray(rows_p, np.float32)),
                  Vec(np.asarray(rows_a, np.float32))])


def _op_fairness_metrics(node, env):
    """(fairnessMetrics model fr protected_cols reference favorable_class):
    for each combination of the protected columns' levels present in
    the frame, the confusion counts of the model's labels against the
    response, the rates, and the adverse-impact ratio of its selected
    ratio against the reference group's."""
    import itertools
    m = _model_arg(node[1], env)
    fr = _as_frame(_eval(node[2], env))
    prot = [str(s) for s in _mixed_list(node[3], env)]
    ref_levels = [str(s) for s in _mixed_list(node[4], env)]
    favorable = str(_lit(node[5]))
    yv = fr.vec(m.params.get("response_column"))
    dom = list(yv.domain or [])
    if len(dom) != 2:
        raise ValueError("fairnessMetrics supports binomial models "
                         f"(response has {len(dom)} levels)")
    if favorable not in dom:
        raise ValueError(f"favorable_class {favorable!r} not in response "
                         f"domain {dom}")
    fav = dom.index(favorable)
    raw = m.predict_raw(fr)[:, 0].cpu().numpy()
    # the model's own label decides selection, whichever class is
    # favorable
    pred_fav = raw.astype(np.int64) == fav
    act_fav = np.asarray(yv.to_numpy(), np.int64) == fav
    groups = [np.asarray(fr.vec(c).to_numpy(), np.int64) for c in prot]
    doms = [list(fr.vec(c).domain or []) for c in prot]

    def rates(sel):
        n = int(sel.sum())
        if n == 0:
            return None
        tp = int((sel & pred_fav & act_fav).sum())
        fp = int((sel & pred_fav & ~act_fav).sum())
        fn = int((sel & ~pred_fav & act_fav).sum())
        tn = int((sel & ~pred_fav & ~act_fav).sum())
        return dict(total=n, tp=tp, fp=fp, fn=fn, tn=tn,
                    selected=(tp + fp) / n, tpr=tp / max(tp + fn, 1),
                    fpr=fp / max(fp + tn, 1), accuracy=(tp + tn) / n)

    ref_sel = np.ones(fr.nrows, bool)
    if ref_levels:
        for g, d, lev in zip(groups, doms, ref_levels):
            ref_sel &= g == (d.index(lev) if lev in d else -2)
    ref_r = rates(ref_sel) or dict(selected=1.0)
    cols: Dict[str, list] = {c: [] for c in prot}
    met: Dict[str, list] = {k: [] for k in (
        "total", "tp", "fp", "fn", "tn", "selectedRatio", "tpr", "fpr",
        "accuracy", "AIR_selectedRatio")}
    for combo in itertools.product(*[range(len(d)) for d in doms]):
        sel = np.ones(fr.nrows, bool)
        for g, k in zip(groups, combo):
            sel &= g == k
        r = rates(sel)
        if r is None:
            continue
        for c, k, d in zip(prot, combo, doms):
            cols[c].append(d[k])
        for k in ("total", "tp", "fp", "fn", "tn", "tpr", "fpr",
                  "accuracy"):
            met[k].append(r[k])
        met["selectedRatio"].append(r["selected"])
        met["AIR_selectedRatio"].append(
            r["selected"] / max(ref_r["selected"], 1e-12))
    names, vecs = [], []
    for c in prot:
        d = sorted(set(cols[c]))
        lut = {x: i for i, x in enumerate(d)}
        vecs.append(Vec(np.asarray([lut[x] for x in cols[c]], np.int32),
                        T_CAT, domain=d))
        names.append(c)
    for k, vals in met.items():
        names.append(k)
        vecs.append(Vec(np.asarray(vals, np.float32)))
    return Frame(names, vecs)


def _op_permutation_varimp(node, env):
    """(PermutationVarImp model fr metric n_samples n_repeats features
    seed): how much a metric degrades when one column's rows are
    shuffled (hex/PermutationVarImp.java).  One generator,
    ``default_rng(seed)``, draws the row sample and then every
    permutation, in the reference's order; the model scores each
    shuffled frame on its own device."""
    from h2o_tpu_torch.models.score_keeper import (is_maximizing,
                                                   resolve_stopping_metric)
    m = _model_arg(node[1], env)
    fr = _as_frame(_eval(node[2], env))
    metric = str(_lit(node[3]) or "AUTO")
    n_samples = int(_eval(node[4], env) or -1)
    n_repeats = max(int(_eval(node[5], env) or 1), 1)
    feats_node = node[6]
    features = [str(s) for s in _mixed_list(feats_node, env)] \
        if not (isinstance(feats_node, tuple) and feats_node[0] == "id" and
                feats_node[1] == "None") else []
    seed = int(_eval(node[7], env) or -1)
    rng = np.random.default_rng(seed if seed >= 0 else None)
    work = fr
    if 0 < n_samples < fr.nrows:
        idx = rng.choice(fr.nrows, size=n_samples, replace=False)
        work = _row_select_host(fr, np.sort(idx))
    x = [c for c in m.output.get("x", []) if c in work.names]
    features = features or x

    def metric_of(frame):
        mm_ = m.model_metrics(frame)
        name = metric
        if name.upper() == "AUTO":
            name = resolve_stopping_metric("AUTO", mm_.kind)
        v = mm_.get(name)
        if v is None:
            v = mm_.get(name.upper())
        if v is None:
            v = mm_.get(name.lower())
        if v is None:
            raise ValueError(f"metric {metric!r} not available")
        return float(v), name

    base, name = metric_of(work)
    maximize = is_maximizing(name)
    rows = []
    for c in features:
        drops = []
        j = work.names.index(c)
        v = work.vec(c)
        for _ in range(n_repeats):
            arr = v.to_numpy()[rng.permutation(work.nrows)]
            shuf = Frame(list(work.names), list(work.vecs))
            shuf.vecs[j] = Vec(np.asarray(arr, np.int32), T_CAT,
                               domain=list(v.domain)) \
                if v.is_categorical else Vec(np.asarray(arr, np.float32),
                                             v.type)
            pv, _ = metric_of(shuf)
            drops.append((base - pv) if maximize else (pv - base))
        rows.append((c, [max(d, 0.0) for d in drops]))
    dom = [r[0] for r in rows]
    var = Vec(np.arange(len(dom), dtype=np.int32), T_CAT, domain=dom)
    if n_repeats > 1:
        return Frame(["Variable"] + [f"Run {i + 1}" for i in
                                     range(n_repeats)],
                     [var] + [Vec(np.asarray([r[1][i] for r in rows],
                                             np.float32))
                              for i in range(n_repeats)])
    rel = np.asarray([r[1][0] for r in rows], np.float64)
    mx, tot = max(rel.max(), 1e-30), max(rel.sum(), 1e-30)
    return Frame(["Variable", "Relative Importance", "Scaled Importance",
                  "Percentage"],
                 [var, Vec(rel.astype(np.float32)),
                  Vec((rel / mx).astype(np.float32)),
                  Vec((rel / tot).astype(np.float32))])


def _op_isax(node, env):
    """(isax fr num_words max_cardinality optimize_card): each row
    z-normalised, averaged over ``num_words`` equal segments (PAA) and
    each average given its symbol among the standard normal's
    ``max_cardinality`` quantiles; the row's iSAX word as a
    categorical."""
    from scipy.special import ndtri
    fr = _as_frame(_eval(node[1], env))
    num_words = int(_eval(node[2], env))
    card = int(_eval(node[3], env))
    if bool(_eval(node[4], env)):
        raise NotImplementedError(
            "isax optimize_card=True (per-word cardinality reduction) is "
            "not implemented; pass optimize_card=False")
    if num_words <= 0 or card <= 1:
        raise ValueError("isax: num_words > 0 and max_cardinality > 1")
    X = np.stack([v.as_float() for v in fr.vecs], axis=1).astype(np.float64)
    C = X.shape[1]
    mu = np.nanmean(X, axis=1, keepdims=True)
    sd = np.nanstd(X, axis=1, keepdims=True)
    Z = (X - mu) / np.where(sd == 0, 1.0, sd)
    edges = np.linspace(0, C, num_words + 1).astype(int)
    paa = np.stack([np.nanmean(Z[:, edges[i]: max(edges[i + 1],
                                                  edges[i] + 1)], axis=1)
                    for i in range(num_words)], axis=1)
    brk = ndtri(np.arange(1, card) / card)
    sym = np.searchsorted(brk, np.nan_to_num(paa))
    # a word a distinct row of symbols, gathered to the rows
    rows_u, inv = np.unique(sym, axis=0, return_inverse=True)
    words = ["_".join(f"{int(s)}^{card}" for s in row) for row in rows_u]
    dom = sorted(set(words))
    lut = {w: i for i, w in enumerate(dom)}
    codes = np.asarray([lut[w] for w in words], np.int32)
    return Frame(["iSAX_index"], [Vec(codes[inv.ravel()], T_CAT,
                                      domain=dom)])


def _op_make_leaderboard(node, env):
    """(makeLeaderboard [model_ids] lb_frame_key sort_metric
    extra_columns scoring_data) over ``models/leaderboard.py``;
    ``predict_time_per_row_ms`` times a prediction of the leaderboard
    frame until its scores are on the host."""
    import time
    from h2o_tpu_torch.models.leaderboard import Leaderboard
    ids = [str(s) for s in _mixed_list(node[1], env)]
    lb_key = str(_lit(node[2]) or "")
    sort_metric = str(_lit(node[3]) or "AUTO")
    extra_cols = [str(s).lower() for s in _mixed_list(node[4], env)]
    scoring_data = str(_lit(node[5]) or "AUTO").lower()
    lb_frame = dkv().get(lb_key) if lb_key else None
    models = []
    for mid in ids:
        m = dkv().get(mid)
        if m is None:
            raise ValueError(f"makeLeaderboard: model {mid!r} not found")
        models.append(m)
    lb = Leaderboard(sort_metric=None if sort_metric.upper() == "AUTO"
                     else sort_metric.lower(), leaderboard_frame=lb_frame,
                     scoring_data=scoring_data)
    lb.add(*models)
    rows = lb.rows()
    if not rows:
        raise ValueError("makeLeaderboard: no models")
    if "all" in extra_cols:
        extra_cols = ["training_time_ms", "predict_time_per_row_ms", "algo"]
    if "predict_time_per_row_ms" in extra_cols:
        for r_, m in zip(rows, lb.sorted_models()):
            score_fr = lb_frame if lb_frame is not None and lb_frame.nrows \
                else dkv().get(str(m.params.get("training_frame") or ""))
            if score_fr is None:
                r_["predict_time_per_row_ms"] = math.nan
                continue
            t0 = time.perf_counter()
            m.predict_raw(score_fr).cpu()
            r_["predict_time_per_row_ms"] = (
                (time.perf_counter() - t0) * 1000.0 / max(score_fr.nrows, 1))
    drop = {"algo"} - set(extra_cols)
    if "training_time_ms" not in extra_cols:
        drop.add("training_time_ms")
    out_names, vecs = [], []
    for nname in (k for k in rows[0] if k not in drop):
        vals = [r[nname] for r in rows]
        if nname in ("model_id", "algo"):
            labels = [str(v) for v in vals]
            uniq = sorted(set(labels))
            lut = {x: i for i, x in enumerate(uniq)}
            vecs.append(Vec(np.asarray([lut[x] for x in labels], np.int32),
                            T_CAT, domain=uniq))
        else:
            vecs.append(Vec(np.asarray(
                [np.nan if v is None else float(v) for v in vals],
                np.float32)))
        out_names.append(nname)
    return Frame(out_names, vecs)


# ---------------------------------------------------------------------------
# frame and statistics ops (ast/prims/**): scale and not on the device,
# the rest on the host
# ---------------------------------------------------------------------------


def _host_matrix(fr: Frame) -> np.ndarray:
    """(rows, cols) float32 of every column's ``as_float``, on the host
    (the reference's ``as_matrix`` read back; a string column raises its
    type, an AttributeError)."""
    for n, v in zip(fr.names, fr.vecs):
        if v.data is None:
            raise AttributeError(f"{n!r} is a {v.type} column: no numeric "
                                 "payload")
    if not fr.vecs:
        return np.zeros((fr.nrows, 0), np.float32)
    return np.stack([v.as_float() for v in fr.vecs], axis=1)


def _upload_row(like: torch.Tensor, vals) -> torch.Tensor:
    """A (1, len(vals)) float32 row of numbers on ``like``'s device: one
    operand a column, so that the card divides as the CPU does."""
    row = np.asarray(vals, np.float32)[None, :]
    TransferStats.note("to_device", row.nbytes)
    return torch.from_numpy(row).to(like.device)


def _op_scale(node, env):
    """(scale fr center scale): the numeric columns centred and scaled in
    float32 on the device; ``center``/``scale`` a flag (the column's
    rollup mean, its sigma or 1 where that is 0) or a number a column."""
    fr = _as_frame(_eval(node[1], env))
    num_idx = [j for j, v in enumerate(fr.vecs) if v.is_numeric]

    def spec(arg, rollup):
        if isinstance(arg, tuple) and arg[0] == "numlist":
            return [float(x) for x in arg[1]]
        # evaluated, so that bare True/False ids read as 1.0/0.0
        return [rollup(fr.vecs[j].rollups) for j in num_idx] \
            if _eval(arg, env) else None

    centers = spec(node[2], lambda r: float(r.mean))
    scales = spec(node[3], lambda r: float(r.sigma) or 1.0)
    out_vecs = list(fr.vecs)
    if not num_idx:
        return Frame(list(fr.names), out_vecs)
    m = _upload(fr, env.dev, num_idx)
    if centers is not None:
        m = m - _upload_row(m, [centers[k] for k in range(len(num_idx))])
    if scales is not None:
        m = m / _upload_row(m, [scales[k] or 1.0
                                for k in range(len(num_idx))])
    out = _download(m)
    for k, j in enumerate(num_idx):
        out_vecs[j] = Vec(np.ascontiguousarray(out[:, k]))
    return Frame(list(fr.names), out_vecs)


def _op_not(node, env):
    """(not x): a number's logical not, or on the device each cell's: NaN
    where NaN, else 1 where 0."""
    fr = _eval(node[1], env)
    if isinstance(fr, (int, float)):
        return float(not fr)
    fr = _as_frame(fr)
    for n, v in zip(fr.names, fr.vecs):
        if v.data is None:          # the reference's isnan refuses it so
            raise TypeError(f"isnan requires ndarray or scalar arguments, "
                            f"got {n!r}, a {v.type} column")
    m = _upload(fr, env.dev)
    out = torch.where(torch.isnan(m), torch.full_like(m, math.nan),
                      (m == 0).to(torch.float32))
    return _numeric_frame(fr.names, _download(out))


def _op_hist(node, env):
    """(hist x breaks): [breaks, counts, mids_true, mids], the counts and
    mids after a leading NA row; ``breaks`` a list, a bin count or
    Sturges' (the default), Rice's or the square-root rule."""
    fr = _as_frame(_eval(node[1], env))
    v = fr.vecs[0]
    if not v.is_numeric:
        raise ValueError("hist only applies to single numeric columns")
    d = np.asarray(v.to_numpy(), np.float64)[: fr.nrows]
    d = d[~np.isnan(d)]
    a = node[2]
    if isinstance(a, tuple) and a[0] == "numlist":
        brks = np.asarray([float(x) for x in a[1]], np.float64)
    else:
        if isinstance(a, tuple) and a[0] == "str":
            algo = a[1].lower()
            n = len(d)
            if algo == "rice":
                nb = int(np.ceil(2 * n ** (1.0 / 3)))
            elif algo == "sqrt":
                nb = int(np.ceil(np.sqrt(n)))
            else:
                nb = int(np.ceil(np.log2(n) + 1))
        else:
            nb = int(a)
        brks = np.linspace(d.min(), d.max(), nb + 1)
    counts, _ = np.histogram(d, bins=brks)
    mids = 0.5 * (brks[:-1] + brks[1:])
    # each bin's own mean, in the reference's order (the last bin closed)
    mids_true = np.array([
        d[(d >= brks[i]) & (d <= brks[i + 1] if i == len(brks) - 2
                            else d < brks[i + 1])].mean()
        if counts[i] else np.nan for i in range(len(brks) - 1)])
    return Frame(
        ["breaks", "counts", "mids_true", "mids"],
        [Vec(brks.astype(np.float32)),
         Vec(np.concatenate([[np.nan], counts]).astype(np.float32)),
         Vec(np.concatenate([[np.nan], mids_true]).astype(np.float32)),
         Vec(np.concatenate([[np.nan], mids]).astype(np.float32))])


def _rng(seed: int) -> np.random.Generator:
    """numpy's generator of a Rapids seed (below 0: from entropy)."""
    return np.random.default_rng(None if seed < 0 else seed)


def _op_runif(node, env):
    """(h2o.runif fr seed): a uniform draw a row."""
    fr = _as_frame(_eval(node[1], env))
    rng = _rng(int(_eval(node[2], env)))
    return Frame(["rnd"], [Vec(rng.uniform(size=fr.nrows)
                               .astype(np.float32))])


def _op_kfold(node, env):
    """(kfold_column fr n seed): a fold in 0..n-1 drawn a row."""
    fr = _as_frame(_eval(node[1], env))
    n = int(_eval(node[2], env))
    rng = _rng(int(_eval(node[3], env)) if len(node) > 3 else -1)
    return Frame(["fold"], [Vec(rng.integers(0, n, fr.nrows)
                                .astype(np.float32))])


def _op_modulo_kfold(node, env):
    """(modulo_kfold_column fr n): row i in fold i mod n."""
    fr = _as_frame(_eval(node[1], env))
    n = int(_eval(node[2], env))
    return Frame(["fold"], [Vec((np.arange(fr.nrows) % n)
                                .astype(np.float32))])


def _op_stratified_kfold(node, env):
    """(stratified_kfold_column y n seed): each class's rows shuffled
    (classes in sorted order, one generator) and dealt round-robin into
    the folds; numeric NA rows stay in fold 0 (a categorical's NA code is
    a class of its own)."""
    fr = _as_frame(_eval(node[1], env))
    n = int(_eval(node[2], env))
    seed = int(_eval(node[3], env)) if len(node) > 3 else -1
    y = np.asarray(fr.vecs[0].to_numpy())[: fr.nrows]
    rng = _rng(seed)
    fold = np.zeros(fr.nrows, np.float32)
    for k in np.unique(y[~np.isnan(y.astype(np.float64))]):
        idx = np.flatnonzero(y == k)
        rng.shuffle(idx)
        fold[idx] = np.arange(len(idx)) % n
    return Frame(["fold"], [Vec(fold)])


def _op_which_extreme(op, node, env):
    """(which.max fr skipna axis), (which.min ...): axis 0 a one-row frame
    of each numeric column's row index, axis 1 a column of each row's
    column index; without ``skipna`` an NA gives NA."""
    fr = _as_frame(_eval(node[1], env))
    skipna = bool(_eval(node[2], env)) if len(node) > 2 else True
    axis = int(_eval(node[3], env)) if len(node) > 3 else 0
    arg = np.nanargmax if op == "which.max" else np.nanargmin
    arg_strict = np.argmax if op == "which.max" else np.argmin
    if axis == 1:
        num = [j for j, v in enumerate(fr.vecs) if v.is_numeric]
        mat = np.stack([np.asarray(fr.vecs[j].to_numpy(),
                                   np.float64)[: fr.nrows]
                        for j in num], axis=1)
        nanrow = np.isnan(mat).all(axis=1) if skipna \
            else np.isnan(mat).any(axis=1)
        safe = np.where(np.isnan(mat), -np.inf if op == "which.max"
                        else np.inf, mat) if skipna else mat
        idx = arg_strict(safe, axis=1).astype(np.float64)
        return Frame([op], [Vec(np.where(nanrow, np.nan, idx))])
    vecs, names = [], []
    for n, v in zip(fr.names, fr.vecs):
        if not v.is_numeric:
            continue
        names.append(n)
        d = np.asarray(v.to_numpy(), np.float64)[: fr.nrows]
        if np.isnan(d).all() or (not skipna and np.isnan(d).any()):
            vecs.append(Vec(np.asarray([np.nan], np.float32)))
            continue
        vecs.append(Vec(np.asarray([float(arg(d))], np.float32)))
    return Frame(names, vecs)


def _op_topn(node, env):
    """(topn fr col nPercent grabTopN): [row index, value] of the top (1)
    or bottom (-1) ``nPercent`` of a column's values, a stable order."""
    fr = _as_frame(_eval(node[1], env))
    col = int(_eval(node[2], env))
    npct = float(_eval(node[3], env))
    top = int(_eval(node[4], env)) >= 0
    d = np.asarray(fr.vecs[col].to_numpy(), np.float64)[: fr.nrows]
    ok = np.flatnonzero(~np.isnan(d))
    k = max(1, int(round(npct / 100.0 * len(ok))))
    order = ok[np.argsort(d[ok], kind="stable")]
    chosen = order[-k:][::-1] if top else order[:k]
    return Frame(["Row Indices", fr.names[col]],
                 [Vec(chosen.astype(np.float64)),
                  Vec(d[chosen].astype(np.float32))])


def _op_fillna(node, env):
    """(h2o.fillna fr method axis maxlen): forward or backward fill along
    the rows (axis 0) or the columns (axis 1), a run of at most
    ``maxlen`` NAs after a value; every column comes back float32."""
    fr = _as_frame(_eval(node[1], env))
    method = str(_lit(node[2])).lower()
    axis = int(_eval(node[3], env))
    maxlen = int(_eval(node[4], env))
    mat = np.stack([np.asarray(v.to_numpy(), np.float64)[: fr.nrows]
                    for v in fr.vecs], axis=1)
    if axis == 1:
        mat = mat.T
    if method.startswith("back"):
        mat = mat[::-1]
    # each cell's last value at or above it, and how many NAs it is on
    n = mat.shape[0]
    na = np.isnan(mat)
    pos = np.arange(n)[:, None]
    last = np.maximum.accumulate(np.where(na, -1, pos), axis=0)
    fill = na & (last >= 0) & (pos - last <= maxlen)
    mat = np.where(fill, np.take_along_axis(mat, np.maximum(last, 0),
                                            axis=0), mat)
    if method.startswith("back"):
        mat = mat[::-1]
    if axis == 1:
        mat = mat.T
    return Frame(list(fr.names),
                 [Vec(mat[:, j].astype(np.float32))
                  for j in range(mat.shape[1])])


def _moments_reduce(op, node, env):
    """(skewness fr na_rm), (kurtosis fr na_rm): sample moments over the
    sample variance; kurtosis is not the excess."""
    fr = _as_frame(_eval(node[1], env))

    def red(v):
        d = np.asarray(v.to_numpy(), np.float64)[: v.nrows]
        d = d[~np.isnan(d)]
        n = len(d)
        if n < 2:
            return float("nan")
        m = d.mean()
        s2 = ((d - m) ** 2).sum() / (n - 1)
        if op == "skewness":
            return float(((d - m) ** 3).mean() / s2 ** 1.5)
        return float(((d - m) ** 4).mean() / s2 ** 2)

    return _reduce_all(red, fr)


def _group_codes(fr: Frame, cols: List[int]) -> np.ndarray:
    """Each row's group code over the key columns, ``_key_codes``'
    inverse, from 1-d factorizations: each column's sorted distinct keys
    (NaN as ``_key_codes``' -inf sentinel) give a code, and the codes
    combined in column order sort the rows as ``_key_codes``' row sort
    does, code for code (a sort of values, not of rows)."""
    combined = np.zeros(fr.nrows, np.int64)
    width = 1
    for j in cols:
        v = fr.vecs[j]
        d = np.asarray(v.to_numpy(), np.float64)
        if not v.is_categorical:
            d = np.where(np.isnan(d), -np.inf, d)
        uniq, inv = np.unique(d, return_inverse=True)
        width *= max(len(uniq), 1)
        if width >= 1 << 62:        # the combined code would overflow
            return _key_codes(fr, cols)[1]
        combined = combined * len(uniq) + inv.ravel()
    return np.unique(combined, return_inverse=True)[1].ravel()


def _op_dropdup(node, env):
    """(dropdup fr [cols] keep): the first (or last) row of each key."""
    fr = _as_frame(_eval(node[1], env))
    cols = _col_indices(fr, node[2], names_first=True)
    keep = str(_lit(node[3])).strip().lower() if len(node) > 3 else "first"
    inv = _group_codes(fr, cols)
    keep_mask = np.zeros(fr.nrows, bool)
    if keep == "last":
        first_from_end = np.unique(inv[::-1], return_index=True)[1]
        keep_mask[len(inv) - 1 - first_from_end] = True
    else:
        keep_mask[np.unique(inv, return_index=True)[1]] = True
    return fr.slice_rows(keep_mask)


def _op_distance(node, env):
    """(distance x y measure): the (rows of x, rows of y) matrix of l2,
    l1, cosine or squared-cosine values, in float64."""
    X = _as_frame(_eval(node[1], env))
    Y = _as_frame(_eval(node[2], env))
    measure = str(_lit(node[3])).lower()
    A = np.stack([np.asarray(v.to_numpy(), np.float64)[: X.nrows]
                  for v in X.vecs], axis=1)
    B = np.stack([np.asarray(v.to_numpy(), np.float64)[: Y.nrows]
                  for v in Y.vecs], axis=1)
    if measure in ("l2", "euclidean"):
        D = np.sqrt(np.maximum(
            (A * A).sum(1)[:, None] + (B * B).sum(1)[None, :]
            - 2 * A @ B.T, 0.0))
    elif measure in ("l1", "manhattan"):
        D = np.abs(A[:, None, :] - B[None, :, :]).sum(axis=2)
    elif measure in ("cosine", "cosine_sq"):
        na = np.linalg.norm(A, axis=1)
        nb = np.linalg.norm(B, axis=1)
        C = (A @ B.T) / np.maximum(na[:, None] * nb[None, :], 1e-12)
        D = C * C if measure == "cosine_sq" else C
    else:
        raise ValueError(f"unknown distance measure {measure!r}")
    return Frame([f"C{j + 1}" for j in range(D.shape[1])],
                 [Vec(D[:, j].astype(np.float32))
                  for j in range(D.shape[1])])


def _op_melt(node, env):
    """(melt fr [id_vars] [value_vars] var_name value_name skipna): one
    row a (row, value column), the value columns' names a categorical."""
    fr = _as_frame(_eval(node[1], env))
    id_idx = _col_indices(fr, node[2], names_first=True)
    if isinstance(node[3], tuple) and node[3][0] == "numlist" and \
            not node[3][1]:
        val_idx = [j for j in range(fr.ncols) if j not in id_idx]
    else:
        val_idx = _col_indices(fr, node[3], names_first=True)
    var_name = _lit(node[4]) if len(node) > 4 else "variable"
    value_name = _lit(node[5]) if len(node) > 5 else "value"
    skipna = bool(int(_eval(node[6], env))) if len(node) > 6 else False
    n = fr.nrows
    ids, var_col, val_col = [], [], []
    for k, j in enumerate(val_idx):
        d = np.asarray(fr.vecs[j].to_numpy(), np.float64)[:n]
        keep = ~np.isnan(d) if skipna else np.ones(n, bool)
        ids.append(np.flatnonzero(keep))
        var_col.append(np.full(int(keep.sum()), k, np.int32))
        val_col.append(d[keep])
    row_idx = np.concatenate(ids) if ids else np.zeros(0, np.int64)
    names, vecs = [], []
    for j in id_idx:
        v = fr.vecs[j]
        d = v.to_numpy()[row_idx]
        vecs.append(Vec(d.astype(np.int32), T_CAT, domain=list(v.domain))
                    if v.is_categorical else Vec(d, v.type))
        names.append(fr.names[j])
    names += [var_name, value_name]
    vecs += [Vec(np.concatenate(var_col) if var_col else
                 np.zeros(0, np.int32), T_CAT,
                 domain=[fr.names[j] for j in val_idx]),
             Vec((np.concatenate(val_col) if val_col else
                  np.zeros(0)).astype(np.float32))]
    return Frame(names, vecs)


def _op_pivot(node, env):
    """(pivot fr index column value): one row a distinct index value, one
    column a distinct non-NA column value; a cell holds the value of the
    last row with its pair, NA where none has."""
    fr = _as_frame(_eval(node[1], env))
    i_j = _col_indices(fr, node[2], names_first=True)[0]
    c_j = _col_indices(fr, node[3], names_first=True)[0]
    v_j = _col_indices(fr, node[4], names_first=True)[0]
    iv, cv, vv = fr.vecs[i_j], fr.vecs[c_j], fr.vecs[v_j]
    ivals = np.asarray(iv.to_numpy(), np.float64)[: fr.nrows]
    cvals = np.asarray(cv.to_numpy(), np.float64)[: fr.nrows]
    vvals = np.asarray(vv.to_numpy(), np.float64)[: fr.nrows]
    uniq_i, inv_i = np.unique(ivals, return_inverse=True)
    uniq_c = np.unique(cvals[~np.isnan(cvals)])
    out = np.full((len(uniq_i), len(uniq_c)), np.nan)
    ok = ~np.isnan(cvals)
    cell = inv_i.ravel()[ok] * len(uniq_c) + \
        np.searchsorted(uniq_c, cvals[ok])
    # the last row of each cell writes it
    last = len(cell) - 1 - np.unique(cell[::-1], return_index=True)[1]
    out.reshape(-1)[cell[last]] = vvals[ok][last]
    col_labels = ([cv.domain[int(c)] for c in uniq_c]
                  if cv.is_categorical else
                  [str(int(c)) if c == int(c) else str(c) for c in uniq_c])
    first = Vec(uniq_i.astype(np.int32), T_CAT, domain=list(iv.domain)) \
        if iv.is_categorical else Vec(uniq_i.astype(np.float32), iv.type)
    return Frame([fr.names[i_j]] + list(col_labels),
                 [first] + [Vec(out[:, k].astype(np.float32))
                            for k in range(len(uniq_c))])


def _op_rank_within_gb(node, env):
    """(rank_within_groupby fr [gb_cols] [sort_cols] [ascending] new_col
    final_sort): each row's 1-based place within its group in the sort
    order (NAs first, as ``sort``); ``final_sort`` sorts the frame by the
    group and sort columns."""
    fr = _as_frame(_eval(node[1], env))
    gcols = _col_indices(fr, node[2], names_first=True)
    scols = _col_indices(fr, node[3], names_first=True)
    asc = [bool(int(x)) for x in node[4][1]] if isinstance(node[4], tuple) \
        else [True] * len(scols)
    new_col = _lit(node[5]) if len(node) > 5 else "rank"
    final_sort = bool(int(_eval(node[6], env))) if len(node) > 6 else False
    ginv = _group_codes(fr, gcols)
    order = _sort_keys(fr, scols, asc)
    # the rows in sort order, grouped (stable): a row's rank is its
    # distance from its group's first row, plus one
    by_group = order[np.argsort(ginv[order], kind="stable")]
    g = ginv[by_group]
    rank = np.zeros(fr.nrows, np.float32)
    rank[by_group] = np.arange(len(g)) - np.searchsorted(g, g) + 1
    out = Frame(list(fr.names), list(fr.vecs))
    out.add(new_col, Vec(rank))
    if final_sort:
        out = out.slice_rows(_sort_keys(out, gcols + scols,
                                        [True] * len(gcols) + asc))
    return out


_ROW_REDUCERS = {"mean": np.nanmean, "sum": np.nansum, "min": np.nanmin,
                 "max": np.nanmax, "median": np.nanmedian,
                 "sd": lambda m, axis: np.nanstd(m, axis=axis, ddof=1)}


def _op_apply(node, env):
    """(apply fr margin { args . body }): the client's lambda over each
    column (margin 2, the column bound to the argument) or each row
    (margin 1: a reducer body on the rows directly, else the body over
    the transposed frame, at most 100,000 rows)."""
    fr = _as_frame(_eval(node[1], env))
    margin = int(_eval(node[2], env))
    rest = node[3:]
    if not (isinstance(rest[0], tuple) and _lit(rest[0]) == "{"):
        raise ValueError("apply expects a lambda { args . body }")
    i = 1
    args = []
    while _lit(rest[i]) != ".":
        args.append(_lit(rest[i]))
        i += 1
    body = rest[i + 1]
    if margin == 2:
        cols = []
        for j, v in enumerate(fr.vecs):
            env.locals[args[0]] = Frame([fr.names[j]], [v])
            try:
                r = _eval(body, env)
            finally:
                env.locals.pop(args[0], None)
            cols.append((fr.names[j], r.vecs[0] if isinstance(r, Frame)
                         else Vec(np.asarray([float(r)], np.float32))))
        nr = max(v.nrows for _, v in cols)
        return Frame([n for n, _ in cols],
                     [v if v.nrows == nr else
                      Vec(np.resize(np.asarray(v.to_numpy()), nr))
                      for _, v in cols])
    mat = np.stack([np.asarray(v.to_numpy(), np.float64)[: fr.nrows]
                    for v in fr.vecs], axis=1)
    if isinstance(body, list) and len(body) == 2 and \
            _lit(body[0]) in _ROW_REDUCERS and \
            isinstance(body[1], tuple) and _lit(body[1]) == args[0]:
        vals = _ROW_REDUCERS[_lit(body[0])](mat, axis=1)
        return Frame(["apply"], [Vec(vals.astype(np.float32))])
    if fr.nrows > 100_000:
        raise ValueError(
            "apply(axis=1) with a non-reducer lambda materializes one "
            "column per row; limit is 100k rows — rewrite with "
            "column-wise ops or a supported row reducer "
            "(mean/sum/min/max/median/sd)")
    env.locals[args[0]] = Frame(
        [f"C{i + 1}" for i in range(mat.shape[0])],
        [Vec(mat[i].astype(np.float32)) for i in range(mat.shape[0])])
    try:
        r = _eval(body, env)
    finally:
        env.locals.pop(args[0], None)
    if isinstance(r, Frame):
        vals = [float(np.asarray(v.to_numpy())[0]) if v.nrows == 1 else
                np.nan for v in r.vecs]
        return Frame(["apply"], [Vec(np.asarray(vals, np.float32))])
    if isinstance(r, list):
        return Frame(["apply"], [Vec(np.asarray(r, np.float32))])
    return Frame(["apply"], [Vec(np.full(fr.nrows, float(r), np.float32))])


def _op_set_level(node, env):
    """(setLevel fr level): every row set to one level."""
    fr = _as_frame(_eval(node[1], env))
    level = _lit(node[2])
    v = fr.vecs[0]
    if not v.is_categorical:
        raise ValueError("setLevel requires a categorical column")
    if level not in (v.domain or []):
        raise ValueError(f"level {level!r} not in domain")
    return Frame(list(fr.names),
                 [Vec(np.full(fr.nrows, v.domain.index(level), np.int32),
                      T_CAT, domain=list(v.domain))])


def _op_relevel(node, env):
    """(relevel fr level): ``level`` first, the others in their order."""
    fr = _as_frame(_eval(node[1], env))
    level = _lit(node[2])
    v = fr.vecs[0]
    if not v.is_categorical or level not in (v.domain or []):
        raise ValueError(f"relevel: {level!r} not a level")
    new_dom = [level] + [d for d in v.domain if d != level]
    remap = _domain_remap(v.domain, new_dom)
    codes = np.asarray(v.to_numpy())
    return Frame(list(fr.names), [Vec(
        np.where(codes >= 0, remap[np.clip(codes, 0, None)], -1)
        .astype(np.int32), T_CAT, domain=new_dom)])


def _op_difflag1(node, env):
    """(difflag1 fr): x[i] - x[i-1], NA in the first row."""
    fr = _as_frame(_eval(node[1], env))
    out = []
    for v in fr.vecs:
        d = np.asarray(v.to_numpy(), np.float64)[: fr.nrows]
        out.append(Vec(np.concatenate([[np.nan], np.diff(d)])
                       .astype(np.float32)))
    return Frame(list(fr.names), out)


def _op_prod(node, env, na_rm: bool):
    fr = _as_frame(_eval(node[1], env))

    def red(v):
        d = np.asarray(v.to_numpy(), np.float64)[: v.nrows]
        if na_rm:
            d = d[~np.isnan(d)]
        return float(np.prod(d))

    return _reduce_all(red, fr)


def _op_any_all(node, env, which: str):
    """(any fr), (all fr): over every column's non-NA cells."""
    fr = _as_frame(_eval(node[1], env))
    vals = []
    for v in fr.vecs:
        d = np.asarray(v.to_numpy(), np.float64)[: v.nrows]
        d = d[~np.isnan(d)]
        vals.append(bool((d != 0).any() if which == "any"
                         else (d != 0).all()))
    return float(any(vals) if which == "any" else all(vals))


def _op_any_factor(node, env):
    fr = _as_frame(_eval(node[1], env))
    return float(any(v.is_categorical for v in fr.vecs))


def _na_count(v: Vec) -> int:
    """NA cells of a column: None strings, NaN numbers, -1 codes."""
    if v.host_data is not None:
        return sum(x is None for x in v.host_data)
    return v.rollups.nacnt


def _op_any_na(node, env):
    fr = _as_frame(_eval(node[1], env))
    return float(any(_na_count(v) > 0 for v in fr.vecs))


def _op_match(node, env):
    """(match fr table nomatch incomparables): each row's 1-based place
    in ``table`` (the first occurrence wins), ``nomatch`` where absent
    or NA; labels are matched as strings, numbers as floats."""
    fr = _as_frame(_eval(node[1], env))
    table = _mixed_list(node[2], env)
    nomatch = _eval(node[3], env)
    nomatch = float("nan") if nomatch is None else float(nomatch)
    v = fr.vecs[0]
    if v.is_categorical or v.type == T_STR:
        key, labels_fn = str, _distinct_labels
    else:
        key = float

        def labels_fn(vec):
            u, inv = np.unique(np.asarray(vec.to_numpy(), np.float64),
                               return_inverse=True)
            return [None if np.isnan(x) else float(x) for x in u], inv
    lut: Dict[Any, int] = {}
    for i, t in enumerate(table):
        lut.setdefault(key(t), i + 1)
    labels, inv = labels_fn(v)
    vals = np.asarray([nomatch if s is None else lut.get(s, nomatch)
                       for s in labels], np.float32)
    return Frame(["match"], [Vec(vals[np.asarray(inv).ravel()])])


def _rank_avg(col: np.ndarray) -> np.ndarray:
    """Ranks from 1, ties given their mean rank (R's ``average``); NaN
    stays NaN.  A tie's mean of consecutive ranks is (first + last) / 2,
    exactly."""
    out = np.full(col.shape, np.nan)
    ok = ~np.isnan(col)
    v = col[ok]
    order = np.argsort(v, kind="stable")
    sv = v[order]
    # the first and last sorted position of each run of equal values
    new = np.concatenate([[True], sv[1:] != sv[:-1]]) if len(sv) else \
        np.zeros(0, bool)
    run = np.cumsum(new) - 1
    first = np.flatnonzero(new)
    last = np.append(first[1:], len(sv)) - 1
    ranks = np.empty(len(v))
    ranks[order] = (first[run] + last[run] + 2) / 2.0
    out[ok] = ranks
    return out


def _op_cor(node, env):
    """(cor x y use method): Pearson or Spearman in float64; ``use``
    everything (an NA makes NaN) or complete.obs (rows with an NA
    dropped).  One number for two columns, else a frame."""
    fx = _as_frame(_eval(node[1], env))
    fy = _as_frame(_eval(node[2], env))
    use = str(_lit(node[3])).lower()
    method = str(_lit(node[4])).lower()
    X = _host_matrix(fx).astype(np.float64)
    Y = _host_matrix(fy).astype(np.float64)
    if use in ("complete.obs", "na.or.complete"):
        ok = ~(np.isnan(X).any(axis=1) | np.isnan(Y).any(axis=1))
        X, Y = X[ok], Y[ok]
    elif use != "everything":
        raise ValueError(f"cor: use={use!r} not supported "
                         "(everything, complete.obs)")
    if method == "spearman":
        X = np.stack([_rank_avg(X[:, j]) for j in range(X.shape[1])], 1)
        Y = np.stack([_rank_avg(Y[:, j]) for j in range(Y.shape[1])], 1)
    elif method != "pearson":
        raise ValueError(f"cor: method={method!r} not supported "
                         "(Pearson, Spearman)")
    Xc = X - X.mean(axis=0)
    Yc = Y - Y.mean(axis=0)
    denom = np.outer(np.sqrt((Xc ** 2).sum(axis=0)),
                     np.sqrt((Yc ** 2).sum(axis=0)))
    C = (Xc.T @ Yc) / np.maximum(denom, 1e-300)
    if C.size == 1:
        return float(C[0, 0])
    return Frame(list(fy.names), [Vec(C[:, j].astype(np.float32))
                                  for j in range(C.shape[1])])


def _op_cut(node, env):
    """(cut fr [breaks] [labels] include_lowest right dig_lab): a numeric
    column binned into a categorical, labels ``(a,b]`` (``%.<dig>g``)
    unless given; NA outside the breaks."""
    fr = _as_frame(_eval(node[1], env))
    breaks = _numlist_vals(node[2], env)
    labels = [str(s) for s in _mixed_list(node[3], env)] or None
    include_lowest = bool(_eval(node[4], env))
    right = bool(_eval(node[5], env))
    dig = int(_eval(node[6], env))
    x = np.asarray(fr.vecs[0].to_numpy(), np.float64)
    b = np.asarray(breaks, np.float64)
    if right:
        codes = np.searchsorted(b, x, side="left") - 1
        if include_lowest:
            codes = np.where(x == b[0], 0, codes)
    else:
        codes = np.searchsorted(b, x, side="right") - 1
        codes = np.where(x == b[-1], len(b) - 2, codes)
    codes = np.where(np.isnan(x) | (codes < 0) | (codes > len(b) - 2),
                     -1, codes).astype(np.int32)
    if labels and len(labels) != len(b) - 1:
        raise ValueError(f"cut: {len(labels)} labels for {len(b) - 1} bins")
    if not labels:
        fmt = f"%.{dig}g"
        lb, rb = ("(", "]") if right else ("[", ")")
        labels = [f"{lb}{fmt % b[i]},{fmt % b[i + 1]}{rb}"
                  for i in range(len(b) - 1)]
        if include_lowest and right:
            labels[0] = "[" + labels[0][1:]
    return Frame(list(fr.names), [Vec(codes, T_CAT, domain=labels)])


def _entropy(s: str) -> float:
    """Shannon entropy in bits of a string's characters, summed in the
    order they first appear."""
    counts: Dict[str, int] = {}
    for ch in s:
        counts[ch] = counts.get(ch, 0) + 1
    n = len(s)
    return -sum(c / n * math.log2(c / n) for c in counts.values())


def _op_entropy(node, env):
    fr = _as_frame(_eval(node[1], env))
    return Frame(list(fr.names), [_label_floats(v, _entropy)
                                  for v in fr.vecs])


def _op_columns_by_type(node, env):
    """(columnsByType fr type): the 0-based indices of the columns of a
    kind (numeric, categorical, string, time, uuid, bad)."""
    fr = _as_frame(_eval(node[1], env))
    want = str(_lit(node[2])).lower()
    return [float(j) for j, v in enumerate(fr.vecs) if {
        "numeric": v.is_numeric, "categorical": v.is_categorical,
        "string": v.type == T_STR, "time": v.type == T_TIME,
        "uuid": v.type == "uuid", "bad": v.type == "bad"}.get(want, False)]


def _op_filter_na_cols(node, env):
    """(filterNACols fr frac): the 1-based indices of the columns with at
    most ``frac`` of their rows NA."""
    fr = _as_frame(_eval(node[1], env))
    frac = float(_eval(node[2], env))
    return [float(j + 1) for j, v in enumerate(fr.vecs)
            if _na_count(v) <= frac * fr.nrows]


def _op_ls(node, env):
    """(ls): the DKV's keys, sorted, as a categorical."""
    keys = sorted(str(k) for k in dkv().keys()) or ["<empty>"]
    return Frame(["key"], [Vec(np.arange(len(keys), dtype=np.int32), T_CAT,
                               domain=keys)])


def _op_getrow(node, env):
    """(getrow fr): a one-row frame's values, a list even of one."""
    fr = _as_frame(_eval(node[1], env))
    if fr.nrows != 1:
        raise ValueError("getrow works on single-row frames only")
    return [float(v.as_float()[0]) for v in fr.vecs]


def _op_flatten(node, env):
    """(flatten x): a number, or a frame's first cell as a number or a
    label."""
    fr = _eval(node[1], env)
    if isinstance(fr, (int, float)):
        return float(fr)
    v = _as_frame(fr).vecs[0]
    if v.type == T_STR:
        return str(v.host_data[0])
    if v.is_categorical:
        lab = _labels_of(v)[0]
        return str(lab) if lab is not None else float("nan")
    return float(v.as_float()[0])


def _op_rep_len(node, env):
    """(rep_len x length): a number, or a frame's first column, recycled
    to ``length`` rows."""
    src = _eval(node[1], env)
    length = int(_eval(node[2], env))
    if isinstance(src, (int, float)):
        return Frame(["C1"], [Vec(np.full(length, float(src), np.float32))])
    fr = _as_frame(src)
    v = fr.vecs[0]
    arr = np.asarray(v.to_numpy())
    reps = int(np.ceil(length / max(len(arr), 1)))
    out = np.tile(arr, reps)[:length].astype(np.float32)
    if v.is_categorical:
        return Frame([fr.names[0]], [Vec(out.astype(np.int32), T_CAT,
                                         domain=list(v.domain))])
    return Frame([fr.names[0]], [Vec(out)])


def _op_transpose(node, env):
    fr = _as_frame(_eval(node[1], env))
    X = _host_matrix(fr).T
    return Frame([f"C{i + 1}" for i in range(X.shape[1])],
                 [Vec(X[:, j].astype(np.float32))
                  for j in range(X.shape[1])])


def _op_sumaxis(node, env):
    """(sumaxis fr skipna axis): a list of column sums (axis 0) or a
    column of row sums (axis 1), in float64."""
    fr = _as_frame(_eval(node[1], env))
    skipna = bool(_eval(node[2], env))
    axis = int(_eval(node[3], env))
    X = _host_matrix(fr).astype(np.float64)
    f = np.nansum if skipna else np.sum
    if axis == 0:
        return [float(f(X[:, j])) for j in range(X.shape[1])]
    return Frame(["sum"], [Vec(f(X, axis=1).astype(np.float32))])


def _op_set_domain(node, env):
    """(setDomain fr in_place [labels]): a categorical's labels replaced,
    its codes kept."""
    fr = _as_frame(_eval(node[1], env))
    labels = _mixed_list(node[3], env)
    v = fr.vecs[0]
    if not v.is_categorical:
        raise ValueError("setDomain needs a categorical column")
    if len(labels) < len(v.domain or []):
        raise ValueError(f"setDomain: {len(labels)} labels for "
                         f"{len(v.domain or [])} levels")
    return Frame(list(fr.names), [Vec(np.asarray(v.to_numpy(), np.int32),
                                      T_CAT, domain=[str(s) for s in labels])])


def _op_append_levels(node, env):
    """(appendLevels fr in_place [labels]): the labels not yet levels
    appended to the domain."""
    fr = _as_frame(_eval(node[1], env))
    labels = _mixed_list(node[3], env)
    v = fr.vecs[0]
    if not v.is_categorical:
        raise ValueError("appendLevels needs a categorical column")
    dom = list(v.domain or [])
    for lab in labels:
        if str(lab) not in dom:
            dom.append(str(lab))
    return Frame(list(fr.names), [Vec(np.asarray(v.to_numpy(), np.int32),
                                      T_CAT, domain=dom)])


def _op_relevel_by_freq(node, env):
    """(relevel.by.freq fr weights top_n): each categorical's levels by
    (weighted) count, most frequent first; with ``top_n`` > 0 only the
    top ``top_n`` move to the front, the rest keep their order."""
    fr = _as_frame(_eval(node[1], env))
    wcol = _lit(node[2])
    top_n = int(_eval(node[3], env))
    out_vecs = []
    for v in fr.vecs:
        if not v.is_categorical:
            out_vecs.append(v)
            continue
        codes = np.asarray(v.to_numpy(), np.int64)
        w = np.ones(len(codes))
        if wcol and wcol in fr.names:
            w = np.asarray(fr.vec(wcol).to_numpy(), np.float64)
        card = len(v.domain or [])
        freq = np.zeros(card)
        ok = codes >= 0
        np.add.at(freq, codes[ok], w[ok])
        order = np.argsort(-freq, kind="stable")
        if top_n > 0:
            head = order[:top_n]
            rest = np.setdiff1d(np.arange(card), head)
            order = np.concatenate([head, rest]) if len(rest) else head
        remap = np.empty(card, np.int64)
        remap[order] = np.arange(card)
        new_codes = np.where(ok, remap[np.clip(codes, 0, card - 1)],
                             -1).astype(np.int32)
        out_vecs.append(Vec(new_codes, T_CAT,
                            domain=[str(v.domain[i]) for i in order]))
    return Frame(list(fr.names), out_vecs)


# the reference's _EXTRA_OPS ("week" is dispatched as a time part before
# this table is read, as in the reference)
_EXTRA_OPS = {
    "tf-idf": _op_tf_idf,
    "segment_models_as_frame": _op_segment_models_as_frame,
    "makeLeaderboard": _op_make_leaderboard,
    "model.reset.threshold": _op_reset_threshold,
    "PermutationVarImp": _op_permutation_varimp,
    "predicted.vs.actual.by.var": _op_pred_vs_actual_by_var,
    "fairnessMetrics": _op_fairness_metrics,
    "isax": _op_isax,
    "as.character": _op_as_character,
    "is.character": _op_is_character,
    "strDistance": _op_str_distance,
    "tokenize": _op_tokenize,
    "listTimeZones": _op_list_timezones,
    "setTimeZone": _op_set_timezone,
    "getTimeZone": _op_get_timezone,
    "num_valid_substrings": _op_num_valid_substrings,
    "word2vec.to.frame": _op_w2v_to_frame,
    "rulefit.predict.rules": _op_rulefit_predict_rules,
    "as.Date": _op_as_date,
    "mktime": lambda n, e: _mktime_like(n, e, zero_based=True),
    "moment": lambda n, e: _mktime_like(n, e, zero_based=False),
    "grep": _op_grep,
    "strlen": _op_strlen,
    "not": _op_not,
    "any.factor": _op_any_factor,
    "any.na": _op_any_na,
    "match": _op_match,
    "cor": _op_cor,
    "cut": _op_cut,
    "entropy": _op_entropy,
    "columnsByType": _op_columns_by_type,
    "filterNACols": _op_filter_na_cols,
    "ls": _op_ls,
    "getrow": _op_getrow,
    "flatten": _op_flatten,
    "rep_len": _op_rep_len,
    "t": _op_transpose,
    "sumaxis": _op_sumaxis,
    "setDomain": _op_set_domain,
    "appendLevels": _op_append_levels,
    "relevel.by.freq": _op_relevel_by_freq,
    "scale": _op_scale,
    "hist": _op_hist,
    "h2o.runif": _op_runif,
    "kfold_column": _op_kfold,
    "modulo_kfold_column": _op_modulo_kfold,
    "stratified_kfold_column": _op_stratified_kfold,
    "which.max": lambda n, e: _op_which_extreme("which.max", n, e),
    "which.min": lambda n, e: _op_which_extreme("which.min", n, e),
    "topn": _op_topn,
    "h2o.fillna": _op_fillna,
    "fillna": _op_fillna,
    "skewness": lambda n, e: _moments_reduce("skewness", n, e),
    "kurtosis": lambda n, e: _moments_reduce("kurtosis", n, e),
    "dropdup": _op_dropdup,
    "distance": _op_distance,
    "melt": _op_melt,
    "pivot": _op_pivot,
    "rank_within_groupby": _op_rank_within_gb,
    "apply": _op_apply,
    "setLevel": _op_set_level,
    "relevel": _op_relevel,
    "difflag1": _op_difflag1,
    "prod": lambda n, e: _op_prod(n, e, na_rm=False),
    "prod.na": lambda n, e: _op_prod(n, e, na_rm=True),
    "any": lambda n, e: _op_any_all(n, e, "any"),
    "all": lambda n, e: _op_any_all(n, e, "all"),
}


def op_names() -> List[str]:
    """Every op name this interpreter dispatches (GET /99/Rapids/help)."""
    return sorted(set(_BINOPS) | set(_UNOPS) | set(_CUMOPS) |
                  set(_NAMED_OPS) | set(_STROPS) | set(_TIME_PARTS) |
                  set(_EXTRA_OPS))


_NUMPY_REPR = re.compile(
    r"np\.(?:str_|bytes_|float64|float32|float16|int64|int32|int16|int8|"
    r"intc|intp|uint64|uint32|uint16|uint8|longlong|bool_)\("
    r"('[^']*'|\"[^\"]*\"|[^()]*)\)")


def _normalize_numpy_reprs(expr: str) -> str:
    """Strip numpy 2's scalar reprs from a client-built expression
    (h2o-py serializes ``np.str_`` column selectors by ``repr``, so
    ``'c'`` arrives as ``np.str_('c')``).  A quoted string outside a
    wrapper is copied as it is: a user's argument that mentions
    ``np.float64(0)`` (a replaceall pattern) is not rewritten."""
    prev = None
    while prev != expr:                  # nested wrappers unwrap too
        prev = expr
        out = []
        i, n = 0, len(expr)
        while i < n:
            ch = expr[i]
            m = _NUMPY_REPR.match(expr, i)
            if m:
                out.append(m.group(1))
                i = m.end()
            elif ch in "'\"":            # copy the quoted span verbatim
                j = i + 1
                while j < n and expr[j] != ch:
                    j += 1
                out.append(expr[i: j + 1])
                i = j + 1
            else:
                out.append(ch)
                i += 1
        expr = "".join(out)
    return expr


def rapids_exec(expr: str, session: Optional[Session] = None,
                device: DeviceLike = None):
    """Execute one Rapids expression (the /3/Rapids POST body) on
    ``device``, else the session's, else ``cloud(None)`` (the card; pass
    ``device="cpu"`` for the CPU)."""
    session = session or Session(device=device)
    dev = cloud(device if device is not None else session.device)
    if "np." in expr:
        expr = _normalize_numpy_reprs(expr)
    return _eval(parse(expr), _Env(session, dev))
