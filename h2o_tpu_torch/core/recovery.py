"""Recovery — job-level fault-tolerance snapshots and auto-resume: port of
``h2o_tpu/core/recovery.py`` (``Recovery`` :39-160, ``_mesh_info``
:162-179, ``_jsonable`` :181-190, ``pending_recoveries`` :192-261,
``_resume_model`` :263-278, ``auto_recover`` :280-313, ``resume_grid``
:315-336; reference hex/faulttolerance/{Recoverable,Recovery}.java:21-86,
``-auto_recovery_dir``, h2o-py ``h2o.resume``, R ``h2o.resumeGrid``).

A ``Recovery`` attached to a model build or a grid writes the job's
params, its training frame (``persist.save_frame``) and every finished
model (``Model.save``) under ``<recovery_dir>/<kind>_<job id>``; the
success path deletes the directory.  After a crash, ``auto_recover``
finds every unfinished snapshot and resumes it: a grid reloads its
finished models into ``dkv()`` and trains only the remaining
combinations; a model build restarts from its iteration checkpoint
(``save_iteration``): the tree driver's per-block forest state, GLM's
IRLSM or L-BFGS beta at its lambda, DeepLearning's weights, optimizer
state and key per block.  A resumed build continues the same random
stream from the same state, so it is bitwise the uninterrupted one.

Every write is atomic (a ``.tmp`` file, then ``os.replace``) and goes
through ``resilience.default_policy()`` with the chaos persist injector
live, like every other persist path.  A torn ``iter.pkl`` loses the
increment, never the job (``load_iteration`` returns None and the build
starts over); a torn ``info.json`` is skipped by discovery.

Payloads hold numpy arrays and host objects only, never a device
tensor, so a checkpoint pickles, and loads, without the card.  The
snapshot's ``mesh`` stamp is the one-device geometry the port builds
on: the device type, one device, one row shard and a row quantum of 1
(rows are never padded to a mesh).  Discovery skips a snapshot that
needs more devices than this process has (``torch.cuda.device_count()``,
1 on the CPU), as the reference skips one written by a larger pod; a
build spread over several cards comes with the multi-GPU mesh (P8).
Checkpoints are pickles, like ``Model.save``'s files: resume only a
directory this program wrote.
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
import time
from typing import Any, Dict, List, Optional

import torch

from h2o_tpu_torch.core import persist
from h2o_tpu_torch.core.device import DeviceLike
from h2o_tpu_torch.core.frame import Frame
from h2o_tpu_torch.core.log import get_logger

log = get_logger("recovery")


class Recovery:
    """Snapshot writer and reader for one recoverable job."""

    def __init__(self, recovery_dir: str, job_kind: str, job_id: str,
                 device: DeviceLike = None):
        self.dir = os.path.join(recovery_dir, f"{job_kind}_{job_id}")
        self.kind = job_kind
        self.job_id = job_id
        self.device_type = torch.device(device).type \
            if device is not None else "cuda"
        os.makedirs(self.dir, exist_ok=True)

    # -- writing (called by the running job) -------------------------------

    def begin(self, params: Dict[str, Any], train: Frame,
              extra: Optional[Dict] = None) -> None:
        """Persist the job's params and training frame before work
        starts (Recovery.onStart).  The frame is stored, not deflated:
        zlib takes seconds over a million rows of float columns and
        saves little on them, and the build waits for the snapshot."""
        persist.save_frame(train, os.path.join(self.dir, "train"),
                           compressed=False)
        self._write_info({"kind": self.kind, "job_id": self.job_id,
                          "started": time.time(),
                          "params": _jsonable(params),
                          "extra": extra or {},
                          "mesh": _mesh_info(self.device_type),
                          "done": False, "models": []})

    def model_done(self, model) -> None:
        """Persist one finished model (Recovery.onModel)."""
        info = self._info()
        path = os.path.join(self.dir, f"model_{len(info['models'])}.bin")
        model.save(path)
        info["models"].append({"key": str(model.key), "path": path})
        self._write_info(info)

    def done(self) -> None:
        """The job succeeded: delete the snapshot, as the reference does."""
        shutil.rmtree(self.dir, ignore_errors=True)

    # -- iteration checkpoints (mid-build resume) ----------------------------

    def save_iteration(self, payload: Dict[str, Any],
                       meta: Optional[Dict] = None) -> None:
        """Atomically checkpoint a build's state: ``payload`` is a
        pickleable dict of numpy arrays and host objects, ``meta`` a
        small JSON summary beside it that discovery reports without
        reading the payload."""
        def write():
            self._chaos_write("iter.pkl")
            _atomic(os.path.join(self.dir, "iter.pkl"),
                    pickle.dumps(payload))
            m = dict(meta or {})
            m["saved_at"] = time.time()
            m.setdefault("mesh", _mesh_info(self.device_type))
            _atomic(os.path.join(self.dir, "iter.json"),
                    json.dumps(m).encode())

        _policy().call(write, what=f"iteration checkpoint {self.dir}")

    def load_iteration(self) -> Optional[Dict[str, Any]]:
        """The last iteration checkpoint, or None (none yet, or torn)."""
        p = os.path.join(self.dir, "iter.pkl")
        if not os.path.exists(p):
            return None
        try:
            with open(p, "rb") as f:
                return pickle.load(f)
        except Exception as e:  # noqa: BLE001 — a torn checkpoint
            log.warning("unreadable iteration checkpoint %s (%r) — "
                        "resuming from the previous boundary", p, e)
            return None

    def iteration_meta(self) -> Optional[Dict[str, Any]]:
        """The JSON summary of the last checkpoint, or None."""
        return _read_json(os.path.join(self.dir, "iter.json"))

    def clear_iteration(self) -> None:
        for n in ("iter.pkl", "iter.json"):
            try:
                os.remove(os.path.join(self.dir, n))
            except OSError:
                pass

    # -- the snapshot's record ------------------------------------------------

    def _info(self) -> Dict:
        with open(os.path.join(self.dir, "info.json")) as f:
            return json.load(f)

    def _write_info(self, info: Dict) -> None:
        def write():
            self._chaos_write("info.json")
            _atomic(os.path.join(self.dir, "info.json"),
                    json.dumps(info).encode())

        _policy().call(write, what=f"recovery info {self.dir}")

    def _chaos_write(self, name: str) -> None:
        from h2o_tpu_torch.core.chaos import chaos
        if chaos().enabled:
            chaos().maybe_fail_persist("write", os.path.join(self.dir, name))


def _policy():
    from h2o_tpu_torch.core.resilience import default_policy
    return default_policy()


def _atomic(path: str, data: bytes) -> None:
    """Write ``data`` to ``path`` through ``path.tmp`` and a rename."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def _read_json(path: str) -> Optional[Any]:
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (json.JSONDecodeError, OSError):
        return None


def _mesh_info(device_type: str = "cuda") -> Dict:
    """The geometry a snapshot was written under: one device of
    ``device_type``, one row shard, rows unpadded."""
    return {"device_type": device_type, "devices": 1, "data_shards": 1,
            "row_quantum": 1}


def _devices_available() -> int:
    return max(torch.cuda.device_count(), 1)


def _jsonable(params: Dict) -> Dict:
    """``params`` with every value JSON cannot hold as its ``str``."""
    out = {}
    for k, v in params.items():
        try:
            json.dumps(v)
            out[k] = v
        except TypeError:
            out[k] = str(v)
    return out


def pending_recoveries(recovery_dir: str) -> List[Dict]:
    """The unfinished snapshots under ``recovery_dir``, newest first,
    each its ``info.json`` plus ``dir``, ``has_iteration_checkpoint``
    and the checkpoint's ``iteration`` summary.  An unreadable or
    malformed ``info.json`` (a write torn by the crash) is skipped with
    a warning, and so is a snapshot needing more devices than this
    process has."""
    out = []
    if not os.path.isdir(recovery_dir):
        return out
    for d in os.listdir(recovery_dir):
        info_p = os.path.join(recovery_dir, d, "info.json")
        if not os.path.exists(info_p):
            continue
        try:
            with open(info_p) as f:
                info = json.load(f)
        except (json.JSONDecodeError, OSError) as e:
            log.warning("skipping unreadable recovery snapshot %s (%r)",
                        info_p, e)
            continue
        if not isinstance(info, dict):
            log.warning("skipping malformed recovery snapshot %s", info_p)
            continue
        mesh = info.get("mesh")
        if isinstance(mesh, dict) and (mesh.get("data_shards")
                                       or mesh.get("devices")):
            shards = int(mesh.get("data_shards", mesh.get("devices", 0)))
            avail = _devices_available()
            if shards > avail:
                log.warning(
                    "skipping recovery snapshot %s: written with %d row "
                    "shards but only %d devices are available",
                    info_p, shards, avail)
                continue
        if not info.get("done"):
            info["dir"] = os.path.join(recovery_dir, d)
            info["has_iteration_checkpoint"] = os.path.exists(
                os.path.join(recovery_dir, d, "iter.pkl"))
            it = _read_json(os.path.join(recovery_dir, d, "iter.json"))
            if it is not None:
                info["iteration"] = it
            out.append(info)
    out.sort(key=lambda i: -i.get("started", 0))
    return out


def _load_done_models(info: Dict, device: DeviceLike) -> List:
    """The snapshot's finished models, loaded onto ``device`` and
    published in ``dkv()``."""
    from h2o_tpu_torch.core.store import dkv
    from h2o_tpu_torch.models.model import Model
    done = []
    for m in info.get("models") or ():
        mdl = Model.load(m["path"], device)
        dkv().put(mdl.key, mdl)
        done.append(mdl)
    return done


def _resume_model(info: Dict, train: Frame, device: DeviceLike):
    """Resume one interrupted model build: the builder re-attaches to
    the snapshot's directory and its driver restarts from the iteration
    checkpoint (mid-forest, mid-IRLSM, mid-network)."""
    from h2o_tpu_torch.models.registry import builder_class
    extra = info["extra"]
    cls = builder_class(extra["algo"])
    allowed = cls(device="cpu").default_params()
    params = {k: v for k, v in (info.get("params") or {}).items()
              if k in allowed}
    params["recovery_dir"] = os.path.dirname(info["dir"])
    b = cls(device=device, model_id=info["job_id"], **params)
    b._recovery_resuming = True
    return b.train(x=extra.get("x"), y=extra.get("y"), training_frame=train)


def auto_recover(recovery_dir: str, device: DeviceLike = None) -> List[Any]:
    """Resume every unfinished job under ``recovery_dir`` (the
    Recovery.autoRecover / ``POST /3/Recovery/resume`` path) on
    ``device`` (``cuda:0`` by default): a grid reloads its finished
    models into ``dkv()`` and trains only the remaining combinations, a
    model build resumes mid-build from its iteration checkpoint.
    Returns the resumed grids and models."""
    results = []
    for info in pending_recoveries(recovery_dir):
        kind = info["kind"]
        log.info("auto-recovering %s job %s (%d models already done%s)",
                 kind, info["job_id"], len(info.get("models") or ()),
                 ", iteration checkpoint present"
                 if info.get("has_iteration_checkpoint") else "")
        train = persist.load_frame(os.path.join(info["dir"], "train"))
        done_models = _load_done_models(info, device)
        if kind == "grid":
            from h2o_tpu_torch.models.grid import GridSearch
            results.append(GridSearch.resume_from_recovery(
                info, train, done_models, device=device))
        elif kind == "model":
            results.append(_resume_model(info, train, device))
        else:
            log.warning("unknown recoverable kind %r", kind)
    return results


def resume_grid(grid_id: str, recovery_dir: str, device: DeviceLike = None):
    """Resume one grid by id from its snapshot, asynchronously (the
    ``/99/Grid/{algo}/resume`` surface, R's ``h2o.resumeGrid``); returns
    the grid's ``Job``."""
    from h2o_tpu_torch.models.grid import GridSearch
    for info in pending_recoveries(recovery_dir):
        if info.get("kind") != "grid" or info["job_id"] != grid_id:
            continue
        train = persist.load_frame(os.path.join(info["dir"], "train"))
        return GridSearch.resume_from_recovery(
            info, train, _load_done_models(info, device), sync=False,
            device=device)
    raise KeyError(f"no unfinished recovery snapshot for grid {grid_id!r} "
                   f"in {recovery_dir!r}")
