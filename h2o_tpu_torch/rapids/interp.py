"""Rapids — the dataframe expression language behind ``POST /3/Rapids``:
a port of the first half of ``h2o_tpu/rapids/interp.py``.

Clients (h2o-py's ``expr.py``, R) send Lisp-style strings such as
``(tmp= t1 (mean (cols frame 'x')))``; the interpreter parses them and
evaluates each prim over frames, with a ``Session`` that names its
temporaries in the DKV.  Reference map: the parser ``_TOKEN`` ..
``parse`` :35-98; ``Session`` :106-130 and ``_Env`` :356-359;
``_as_frame`` :132-137, ``_string_compare`` :152-186, ``_elementwise``
:193-255, ``_reduce_all`` :257-267, ``_col_indices`` / ``_lit``
:270-287, ``_row_select`` and its host routes :297-348; the op tables
:362-404; ``_eval`` :415-735; the cumulative ops :745-748; sort, merge,
group-by and table :751-1099; ``_update`` and ``_impute`` :1234-1320;
``op_names`` :2994-3014; ``_normalize_numpy_reprs`` and ``rapids_exec``
:3017-3063.

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
A verb that fails on the device raises: no error sends a frame to a host
route (the reference's OOM ladder, ``core/oom.py``, and its lazy planner,
``rapids/plan.py``, come with later slices).  ``table``, ``:=``,
``h2o.impute``, ``asfactor``, ``which`` and the binds compute on the host,
as in the reference.  The reference's ``_dense`` repacks a frame whose
rows are spread over shards as ragged prefixes; one device holds no such
frame, so it has no counterpart here.

The string ops, the time parts and the long tail of prims (``_STROPS``,
``_time_part``, ``_EXTRA_OPS``: :1101-1233, :1328-2992) are not ported
yet: each raises ``NotImplementedError`` naming ROADMAP P12c-ii.

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

from h2o_tpu_torch.core.device import DeviceLike, cloud
from h2o_tpu_torch.core.diag import TransferStats
from h2o_tpu_torch.core.frame import (T_CAT, T_NUM, T_STR, T_TIME, Frame,
                                      Vec, frame_device_ok)
from h2o_tpu_torch.core.munge import (DEVICE_AGGS, device_munge_enabled,
                                      filter_rows, groupby_frame,
                                      merge_device_ok, merge_frames,
                                      mode_device_eligible, sort_frame,
                                      take_rows)
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


def _col_indices(fr: Frame, sel) -> List[int]:
    if isinstance(sel, tuple) and sel[0] == "numlist":
        try:
            return _expand_numlist(sel[1])
        except (TypeError, ValueError):
            # string names in the list
            return [fr.names.index(_lit(x)) for x in sel[1]]
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
            # the rows compact on the device (core/munge.filter_rows)
            return filter_rows(fr, mv.data, device=dev)
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
        return take_rows(fr, idx, device=dev)
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

# the ops of the second interpreter slice (ROADMAP P12c-ii): the string
# ops, the time parts and the reference's _EXTRA_OPS
_STROPS = ("toupper", "tolower", "trim", "nchar", "length", "substring",
           "replacefirst", "replaceall", "sub", "gsub", "strsplit",
           "countmatches", "lstrip", "rstrip")
_TIME_PARTS = ("year", "month", "day", "dayOfWeek", "hour", "minute",
               "second", "week")
_EXTRA_OPS = (
    "tf-idf", "segment_models_as_frame", "makeLeaderboard",
    "model.reset.threshold", "PermutationVarImp",
    "predicted.vs.actual.by.var", "fairnessMetrics", "isax", "not",
    "as.character", "is.character", "any.factor", "any.na", "match", "cor",
    "cut", "entropy", "columnsByType", "filterNACols", "ls", "getrow",
    "flatten", "rep_len", "t", "sumaxis", "strDistance", "tokenize",
    "listTimeZones", "setTimeZone", "getTimeZone", "setDomain",
    "appendLevels", "relevel.by.freq", "week", "num_valid_substrings",
    "word2vec.to.frame", "rulefit.predict.rules", "scale", "hist",
    "h2o.runif", "kfold_column", "modulo_kfold_column",
    "stratified_kfold_column", "as.Date", "mktime", "moment", "which.max",
    "which.min", "topn", "grep", "strlen", "h2o.fillna", "fillna",
    "skewness", "kurtosis", "dropdup", "distance", "melt", "pivot",
    "rank_within_groupby", "apply", "setLevel", "relevel", "difflag1",
    "prod", "prod.na", "any", "all")
_LATER = frozenset(_STROPS + _TIME_PARTS + _EXTRA_OPS)

# every op name _eval dispatches besides the op tables
_NAMED_OPS = (
    "tmp=", "rm", "rm_fr", "cols", "cols_py", "rows", "rows_py", "nrow",
    "ncol", "colnames", "colnames=", "cbind", "rbind", "sumNA", "minNA",
    "maxNA", "meanNA", "medianNA", "sdNA", "varNA") + _REDUCERS + (
    "quantile", "ifelse", "asfactor", "as.factor", "asnumeric",
    "as.numeric", "levels", "unique", ":", "assign", "sort", "merge", "GB",
    "groupby", "table", "na.omit", "naCnt", "which", "is.factor",
    "anyfactor", "is.numeric", ":=", "append", "h2o.impute")


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
        return _sort(node, env)
    if op == "merge":
        return _merge(node, env)
    if op in ("GB", "groupby"):
        return _groupby(node, env)
    if op == "table":
        return _table(node, env)
    if op in _CUMOPS:
        fr = _as_frame(_eval(node[1], env))
        m = _upload(fr, env.dev)
        x = torch.where(torch.isnan(m),
                        torch.full_like(m, _CUM_IDENT[op]), m)
        return _numeric_frame(fr.names, _download(_CUMOPS[op](x)))
    if op == "na.omit":
        return _na_omit(_as_frame(_eval(node[1], env)), env.dev)
    if op == "naCnt":
        fr = _as_frame(_eval(node[1], env))
        return [float(sum(x is None for x in v.host_data))
                if v.host_data is not None else float(v.rollups.nacnt)
                for v in fr.vecs]
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
    if op in _LATER:
        raise NotImplementedError(
            f"rapids op {op!r}: the string, time and long-tail ops come "
            "with ROADMAP P12c-ii")
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
        return sort_frame(fr, idxs, asc, device=env.dev)
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
        return merge_frames(L, R, all_x, all_y, by_x, by_y, device=env.dev)
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
        return groupby_frame(fr, gcols, aggs, device=env.dev)
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


def op_names() -> List[str]:
    """Every op name this interpreter dispatches (GET /99/Rapids/help);
    the P12c-ii ops it refuses are not among them."""
    return sorted(set(_BINOPS) | set(_UNOPS) | set(_CUMOPS) |
                  set(_NAMED_OPS))


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
