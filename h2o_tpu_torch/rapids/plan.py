"""The Rapids planner: fusable verb chains run as one region
(``core/fuse.py``) — a port of ``h2o_tpu/rapids/plan.py``.

Reference map: ``PlanStats`` :68-134, the bypass :139-153, ``_op_of``,
``_stage_of`` and ``_extract_chain`` :157-190, ``_pred_template`` :193-242,
``_compile_stages`` :245-256, ``_resolve_stages`` :259-302, ``_elision``
:305-316, ``try_plan`` :322-358 and ``_plan_region`` :361-491.

The interpreter (``rapids/interp.py``) offers every fusable terminal verb
(``rows``/``rows_py``, ``sort``, ``GB``/``groupby``, ``na.omit``) to
``try_plan`` before its eager handler runs.  The planner walks the
expression inward, collects the chain of predicate stages (a ``rows``
whose selector is an expression, or an ``na.omit``) feeding the verb,
compiles each predicate to a static template, evaluates the chain's base
frame and runs the region.  Region shapes: [stage...] -> sort; k >= 2
stages alone; one stage -> group-by.  Anything else declines and the
eager handler runs untouched; its evaluation of inner nodes offers them
again, so a long mixed chain splits into regions.  Nothing is deferred
past the expression: a frame bound by ``tmp=`` is still made whole.

Declines, as the reference's: a sort with no predicate chain; a
filter-only chain of fewer than 2 stages; a group-by fed by more than
one stage; a ``median`` or ``mode`` aggregate; a predicate reading
another frame than its stage's input, a string literal, an environment
id, a multi-column selector or an op outside the fused tables; a frame
that fails ``frame_device_ok``; ``H2O_TPU_DEVICE_MUNGE`` or
``H2O_TPU_SHARD_MUNGE`` off.  The chain stops at
``H2O_TPU_RAPIDS_FUSE_MAX_VERBS`` verbs.

The lever: ``H2O_TPU_RAPIDS_FUSE`` set to ``1`` or ``0`` wins, and
``H2O_TPU_AUTOTUNE=off`` means per-verb, as in the reference.  Otherwise
the reference measures the two on its accelerator (its ``rapids.fuse``
lever) and keeps per-verb on the CPU.  Until the port's autotuner
(ROADMAP P14b) measures, the port keeps per-verb when the session's
device is the CPU and fuses when it is CUDA, or under
``H2O_TPU_AUTOTUNE=force``.  The reason: on one device with frames on the
host, a region moves strictly fewer bytes than the chain it replaces
(one upload of what it reads and one download of its result, against
one of each a verb), and its result is the same bit for bit.

Errors keep the reference's shape.  An error while planning is counted
(``planner_errors``), logged, and the eager chain runs.  The fused run
is not caught, but by ``core/oom.fused_fallback`` for a device OOM: the
region replays as the eager chain under ``_bypass`` (so the replay does
not plan again) and ``fallbacks_unfused`` counts it.

One device holds no ragged frame, so a base is never ragged: the
elision counters (``_elision``) take ``base_ragged`` False.  Where the
reference's base is a filter's ragged output (a chain cut by the verb
cap), its region counts one repack elided more.  Its refusal of a
ragged group-by base, which is what declines a group-by fed by more
than one stage, is made here by the chain's structure.  Nor is there an
executable store: the reference's exec-store recompile counter waits
for ROADMAP P14a.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

from h2o_tpu_torch import config
from h2o_tpu_torch.core import fuse
from h2o_tpu_torch.core.frame import Frame, frame_device_ok
from h2o_tpu_torch.core.log import get_logger
from h2o_tpu_torch.core.munge import (COMBINABLE_AGGS, device_munge_enabled,
                                      shard_munge_enabled)
from h2o_tpu_torch.core.oom import fused_fallback
from h2o_tpu_torch.rapids.interp import _as_frame, _col_indices, _lit

log = get_logger("rapids.plan")

_FILTER_OPS = ("rows", "rows_py")
_STAGE_OPS = _FILTER_OPS + ("na.omit",)


class PlanStats:
    """Planner counters, process-wide.  The elision counters are computed
    per region from the chain's shape (``_elision``), as the reference
    computes them: the count syncs and repacks its eager chain makes
    between shards and its fused region does not."""

    _lock = threading.Lock()
    _counts: Dict[str, int] = {}
    _kinds: Dict[str, int] = {}

    @classmethod
    def _bump(cls, key: str, n: int = 1) -> None:
        with cls._lock:
            cls._counts[key] = cls._counts.get(key, 0) + n

    @classmethod
    def note_considered(cls) -> None:
        cls._bump("regions_considered")

    @classmethod
    def note_lever(cls, fused: bool) -> None:
        cls._bump("lever_fused" if fused else "lever_per_verb")

    @classmethod
    def note_fused(cls, kind: str, verbs: int, repacks_elided: int,
                   syncs_elided: int) -> None:
        cls._bump("regions_fused")
        cls._bump("verbs_fused", verbs)
        cls._bump("repacks_elided", repacks_elided)
        cls._bump("host_syncs_elided", syncs_elided)
        with cls._lock:
            cls._kinds[kind] = cls._kinds.get(kind, 0) + 1

    @classmethod
    def note_fallback(cls) -> None:
        cls._bump("fallbacks_unfused")

    @classmethod
    def note_error(cls) -> None:
        cls._bump("planner_errors")

    @classmethod
    def snapshot(cls) -> Dict[str, Any]:
        with cls._lock:
            out = {k: cls._counts.get(k, 0) for k in (
                "regions_considered", "regions_fused", "verbs_fused",
                "repacks_elided", "host_syncs_elided",
                "fallbacks_unfused", "planner_errors",
                "lever_fused", "lever_per_verb")}
            out["kinds"] = dict(cls._kinds)
        return out

    @classmethod
    def reset(cls) -> None:
        with cls._lock:
            cls._counts.clear()
            cls._kinds.clear()


# -- the bypass: the OOM replay (and nothing else) runs the same region
# eagerly on this thread; without it the replay would plan it again -------

_tls = threading.local()


def _bypassed() -> bool:
    return getattr(_tls, "bypass", 0) > 0


class _bypass:
    def __enter__(self):
        _tls.bypass = getattr(_tls, "bypass", 0) + 1

    def __exit__(self, *exc):
        _tls.bypass -= 1


# -- chain extraction (structural, before evaluation) ----------------------


def _op_of(node) -> Optional[str]:
    if not isinstance(node, list) or not node:
        return None
    head = node[0]
    return head[1] if isinstance(head, tuple) else head


def _stage_of(node):
    """``(kind, selector node, input node)`` when ``node`` is a predicate
    stage, else None.  A ``rows`` node is one only when its selector is an
    expression (a mask); an index list or span is a gather."""
    op = _op_of(node)
    if op in _FILTER_OPS and len(node) >= 3 and isinstance(node[2], list):
        return ("filter", node[2], node[1])
    if op == "na.omit" and len(node) >= 2:
        return ("naomit", None, node[1])
    return None


def _extract_chain(node, cap: int):
    """Walk inward collecting consecutive predicate stages, at most
    ``cap``: ``(base node, stages)``, the stages innermost first (the
    order the eager chain applies them)."""
    stages = []
    cur = node
    while len(stages) < cap:
        st = _stage_of(cur)
        if st is None:
            break
        stages.append(st)
        cur = st[2]
    stages.reverse()
    return cur, stages


def _pred_template(sel, input_node):
    """A selector expression as a static template, or None when it cannot
    fuse.  A fusable predicate is a tree of the fused op tables over
    numbers, the boolean and NA literals, and single-column reads of the
    stage's own input (structural node equality); an environment id, a
    string literal, another frame or any other op declines."""
    cols = []

    def walk(nd):
        if isinstance(nd, float):
            return ("const", float(nd))
        if isinstance(nd, int):
            return ("const", float(nd))
        if isinstance(nd, tuple):
            if nd[0] == "id":
                name = nd[1]
                if name in ("TRUE", "True", "true"):
                    return ("const", 1.0)
                if name in ("FALSE", "False", "false"):
                    return ("const", 0.0)
                if name in ("NA", "NaN", "nan"):
                    return ("const", float("nan"))
            return None
        if not isinstance(nd, list) or not nd:
            return None
        o = _op_of(nd)
        if o in ("cols", "cols_py") and len(nd) >= 3:
            if nd[1] != input_node:
                return None
            s = nd[2]
            if not isinstance(s, (tuple, float)):
                return None
            cols.append(s)
            return ("rawcol", s)
        if o in fuse._PRED_BINOPS and len(nd) == 3:
            a, b = walk(nd[1]), walk(nd[2])
            if a is None or b is None:
                return None
            return ("bin", o, a, b)
        if o in fuse._PRED_UNOPS and len(nd) == 2:
            a = walk(nd[1])
            if a is None:
                return None
            return ("un", o, a)
        return None

    t = walk(sel)
    return t if (t is not None and cols) else None


def _compile_stages(stage_nodes):
    """Every stage as a template, or None."""
    out = []
    for kind, sel, inner in stage_nodes:
        if kind == "naomit":
            out.append(("naomit", None))
            continue
        t = _pred_template(sel, inner)
        if t is None:
            return None
        out.append(("filter", t))
    return out


def _resolve_stages(templates, fr: Frame):
    """Bind the templates to the base frame: a column selector becomes
    ``("col", j, is_categorical)`` (one column only: the eager mask reads
    the selection's first column, so a wider one is refused), and na.omit
    takes each column's categorical flag.  None when a selector does not
    bind, or when a unary op's operand reads no column (the eager op
    raises on a number)."""

    def bind(t):
        tag = t[0]
        if tag == "rawcol":
            try:
                idxs = _col_indices(fr, t[1])
            except (TypeError, ValueError, IndexError):
                return None
            if len(idxs) != 1 or not 0 <= idxs[0] < fr.ncols:
                return None
            j = int(idxs[0])
            return ("col", j, bool(fr.vecs[j].is_categorical))
        if tag == "const":
            return t
        if tag == "bin":
            a, b = bind(t[2]), bind(t[3])
            return None if a is None or b is None else ("bin", t[1], a, b)
        if tag == "un":
            a = bind(t[2])
            return ("un", t[1], a) if a is not None and fuse.pred_cols(a) \
                else None
        return None

    cats = tuple(bool(v.is_categorical) for v in fr.vecs)
    out = []
    for kind, t in templates:
        if kind == "naomit":
            out.append(("filter", ("notna", cats)))
            continue
        e = bind(t)
        if e is None:
            return None
        out.append(("filter", e))
    return tuple(out)


def _elision(kind: str, k: int, base_ragged: bool):
    """(verbs, repacks elided, count syncs elided) of a region of ``k``
    predicate stages, as the reference counts them for its shards: its
    eager chain repacks every ragged stage input and syncs one count a
    stage (and the group count); its region syncs once and keeps one
    exchange for the filter-only shape."""
    eager_repacks = (k - 1) + (1 if base_ragged else 0)
    if kind == "filter_sort":
        return k + 1, eager_repacks, k - 1
    if kind == "filter_only":
        return k, max(eager_repacks - 1, 0), k - 1
    return k + 1, eager_repacks, k   # filter_gb: filter sync + G -> G


def _lever_fuses(dev) -> bool:
    """The lever's decision before any evaluation: ``H2O_TPU_RAPIDS_FUSE``
    wins; ``H2O_TPU_AUTOTUNE=off`` keeps per-verb; otherwise fuse on CUDA
    or under ``force``, per-verb on the CPU."""
    forced = config.tri_state("H2O_TPU_RAPIDS_FUSE")
    if forced is not None:
        return forced
    mode = config.autotune_mode()
    if mode == "off":
        return False
    return mode == "force" or dev.type == "cuda"


# -- the planner's entry point ---------------------------------------------


def try_plan(op: str, node, env, eval_fn) -> Optional[Frame]:
    """Offer a terminal verb node to the planner: the fused region's
    frame, or None to decline (the caller's eager handler then runs)."""
    if _bypassed():
        return None
    if config.rapids_fuse_mode() == "off":
        return None
    try:
        plan = _plan_region(op, node, env, eval_fn)
    except Exception:  # noqa: BLE001 — planning must never fail a tree
        PlanStats.note_error()
        log.warning("rapids planner failed on %r; falling back to the "
                    "eager path", op, exc_info=True)
        return None
    if plan is None:
        return None
    kind, run_fused, k = plan
    fell_back = []

    def run_eager():
        fell_back.append(True)
        PlanStats.note_fallback()
        with _bypass():
            return eval_fn(node, env)

    out = fused_fallback(fuse.SITE, run_fused, run_eager)
    if not fell_back:
        PlanStats.note_fused(kind, *_elision(kind, k, False))
    return out


def _plan_region(op: str, node, env, eval_fn):
    """Structural extraction and the gates: ``(kind, run_fused thunk,
    number of predicate stages)`` or None."""
    if not (device_munge_enabled() and shard_munge_enabled()):
        return None
    cap = config.rapids_fuse_max_verbs()

    if op == "sort":
        if len(node) < 3 or not (isinstance(node[2], tuple) and
                                 node[2][0] == "numlist"):
            return None
        base_node, stage_nodes = _extract_chain(node[1], cap - 1)
        if not stage_nodes:
            return None
        kind = "filter_sort"
    elif op in _STAGE_OPS:
        base_node, stage_nodes = _extract_chain(node, cap)
        if len(stage_nodes) < 2:
            return None
        kind = "filter_only"
    elif op in ("GB", "groupby"):
        base_node, stage_nodes = _extract_chain(node[1], 1)
        if len(stage_nodes) != 1:
            return None
        kind = "filter_gb"
    else:
        return None

    templates = _compile_stages(stage_nodes)
    if templates is None:
        return None

    PlanStats.note_considered()
    # the lever is decided before the base is evaluated: when it keeps
    # per-verb, the eager handler evaluates the tree itself, and
    # evaluating the base here first would run its verbs twice
    if not _lever_fuses(env.dev):
        PlanStats.note_lever(False)
        return None

    if kind == "filter_gb" and _stage_of(base_node) is not None:
        # a group-by fed by more than one stage: the reference's base is
        # then a filter's output, ragged over its shards, which it
        # refuses; refused here by structure, before the base is made, so
        # the eager group-by offers the inner chain as its own region
        return None
    with _bypass():
        fr = _as_frame(eval_fn(base_node, env))
    if not frame_device_ok(fr):
        return None
    stages = _resolve_stages(templates, fr)
    if stages is None:
        return None

    if kind == "filter_sort":
        try:
            idxs = [fr.names.index(x[1]) if isinstance(x, tuple) and
                    x[0] == "str" else int(x) for x in node[2][1]]
        except (TypeError, ValueError, IndexError, KeyError):
            return None
        asc = [bool(int(x)) for x in node[3][1]] if len(node) > 3 \
            else [True] * len(idxs)
        if not idxs or len(asc) != len(idxs):
            return None
        sort_spec = tuple(
            (int(j), bool(a), bool(fr.vecs[j].is_categorical))
            for j, a in zip(idxs, asc))
    elif kind == "filter_gb":
        try:
            gcols = [int(x) for x in node[2][1]]
        except (TypeError, ValueError):
            return None
        aggs = []
        i = 3
        while i < len(node):
            a = _lit(node[i])
            if not isinstance(a, str):
                break
            if a in ("median", "mode"):
                # the reference's regions combine shard partials, which
                # these have none of: the eager handler owns them
                return None
            if a not in COMBINABLE_AGGS:
                break               # trailing non-agg args, eager-style
            if i + 1 >= len(node):
                return None
            col = node[i + 1]
            try:
                col_i = int(col) if isinstance(col, float) else \
                    fr.names.index(_lit(col))
            except (TypeError, ValueError):
                return None
            na = _lit(node[i + 2]) if i + 2 < len(node) else "all"
            aggs.append((a, col_i, na))
            i += 3
        if not gcols:
            return None

    PlanStats.note_lever(True)
    dev = env.dev
    if kind == "filter_sort":
        def run():
            return fuse.run_fused_sort(fr, stages, sort_spec, dev)
    elif kind == "filter_only":
        def run():
            return fuse.run_fused_filter(fr, stages, dev)
    else:
        def run():
            return fuse.run_fused_groupby(fr, stages, gcols, aggs, dev)
    return kind, run, len(stages)
