"""Persist — frame snapshots and URI-scheme byte stores: port of
``h2o_tpu/core/persist.py`` (the scheme registry :32-51, the http(s)
read :54-61, ``read_bytes``/``write_bytes`` with the retry policy and
the chaos persist site :64-137, ``save_frame``/``load_frame``
:139-180, ``register_s3``/``register_gcs``/``register_hdfs``
:182-345), stdlib ``urllib`` only.

Reference:
- water/fvec/persist/FramePersist.java — a frame snapshot of every
  column plus a metadata record, reloadable;
- water/persist/PersistManager.java:33,45,813 — URI-scheme-dispatched
  byte stores (file, NFS, HDFS, S3, GCS, HTTP).

A frame snapshot is one ``columns.npz`` plus ``frame.json``, the
reference's layout, so each package loads the other's snapshots.  The
port's frames have no DKV key: ``save_frame`` writes ``"key": null``
and ``load_frame`` takes none.  A sparse column is saved dense, and
loads dense, as the reference's loader gives it.
"""

from __future__ import annotations

import io
import json
import os
from typing import Callable, Dict, Optional

import numpy as np

from h2o_tpu_torch.core.frame import T_CAT, T_STR, T_UUID, Frame, Vec
from h2o_tpu_torch.core.log import get_logger

log = get_logger("persist")

# -- byte stores (PersistManager scheme dispatch) ---------------------------

_SCHEMES: Dict[str, Dict[str, Callable]] = {}


def register_scheme(scheme: str, reader: Callable[[str], bytes],
                    writer: Callable[[str, bytes], None]) -> None:
    """Plug in a byte store (the h2o-persist-{s3,gcs,hdfs} analog)."""
    _SCHEMES[scheme] = {"read": reader, "write": writer}


def unregister_scheme(scheme: str) -> None:
    """Remove a byte store (DELETE /3/PersistS3 credential removal)."""
    _SCHEMES.pop(scheme, None)


def _split(uri: str):
    if "://" in uri:
        scheme, rest = uri.split("://", 1)
        return scheme, rest
    return "file", uri


def _http_read(uri: str) -> bytes:
    """Built-in http(s) byte store, read side (reference
    water/persist/PersistHTTP — likewise read-only)."""
    import urllib.request
    req = urllib.request.Request(uri, headers={
        "User-Agent": "h2o-tpu/persist"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.read()


def _read_once(uri: str) -> bytes:
    """One read attempt (the retry wrapper in read_bytes re-invokes this,
    so the chaos hook fires per ATTEMPT — transient injection proves the
    retries recover)."""
    from h2o_tpu_torch.core.chaos import chaos
    if chaos().enabled:
        chaos().maybe_fail_persist("read", uri)
    scheme, rest = _split(uri)
    if scheme in _SCHEMES:
        return _SCHEMES[scheme]["read"](uri)
    if scheme in ("http", "https"):
        return _http_read(uri)
    if scheme == "gcs":
        register_gcs()                 # lazy default: env-credentialed
        return _SCHEMES["gcs"]["read"](uri)
    if scheme == "hdfs":
        register_hdfs()                # lazy default: HDFS_NAMENODE_URL
        return _SCHEMES["hdfs"]["read"](uri)
    if scheme in ("file", "nfs"):
        with open(rest, "rb") as f:
            return f.read()
    raise NotImplementedError(
        f"no persist backend for scheme '{scheme}' — register one with "
        "h2o_tpu_torch.core.persist.register_scheme")


def read_bytes(uri: str) -> bytes:
    """Read a blob, retrying transient faults (network hiccups, flaky
    stores) per the process RetryPolicy — permanent errors (missing
    file, unknown scheme) raise immediately."""
    from h2o_tpu_torch.core.resilience import default_policy
    return default_policy().call(_read_once, uri,
                                 what=f"persist read {uri}")


def _write_once(uri: str, data: bytes) -> None:
    from h2o_tpu_torch.core.chaos import chaos
    if chaos().enabled:
        chaos().maybe_fail_persist("write", uri)
    scheme, rest = _split(uri)
    if scheme in _SCHEMES:
        _SCHEMES[scheme]["write"](uri, data)
        return
    if scheme in ("http", "https"):
        raise NotImplementedError(
            "http(s):// persist is read-only (reference PersistHTTP)")
    if scheme == "gcs":
        register_gcs()
        _SCHEMES["gcs"]["write"](uri, data)
        return
    if scheme == "hdfs":
        register_hdfs()
        _SCHEMES["hdfs"]["write"](uri, data)
        return
    if scheme in ("file", "nfs"):
        os.makedirs(os.path.dirname(rest) or ".", exist_ok=True)
        with open(rest, "wb") as f:
            f.write(data)
        return
    raise NotImplementedError(
        f"no persist backend for scheme '{scheme}' — register one with "
        "h2o_tpu_torch.core.persist.register_scheme")


def write_bytes(uri: str, data: bytes) -> None:
    """Write a blob with the same retry envelope as read_bytes.  Scheme
    writers must be idempotent (whole-object PUT semantics — true for
    every built-in backend), so a retried partial write converges."""
    from h2o_tpu_torch.core.resilience import default_policy
    default_policy().call(_write_once, uri, data,
                          what=f"persist write {uri}")


# -- frame snapshots (FramePersist) -----------------------------------------

def save_frame(frame: Frame, dir_uri: str, compressed: bool = True) -> str:
    """Snapshot a frame to ``<dir>/frame.json`` + ``<dir>/columns.npz``,
    deflated as the reference's unless ``compressed`` is False (both
    packages' loaders read either)."""
    meta = {"key": None, "names": frame.names,
            "types": frame.types(), "nrows": frame.nrows,
            "domains": [v.domain for v in frame.vecs]}
    arrays: Dict[str, np.ndarray] = {}
    strings: Dict[str, list] = {}
    for n, v in zip(frame.names, frame.vecs):
        if v.host_data is not None:
            strings[n] = [None if x is None else str(x)
                          for x in v.host_data]
        else:
            arrays[f"c_{n}"] = v.to_numpy()
    meta["strings"] = strings
    buf = io.BytesIO()
    (np.savez_compressed if compressed else np.savez)(buf, **arrays)
    write_bytes(f"{dir_uri}/columns.npz", buf.getvalue())
    write_bytes(f"{dir_uri}/frame.json",
                json.dumps(meta).encode())
    log.info("frame saved to %s", dir_uri)
    return dir_uri


def load_frame(dir_uri: str) -> Frame:
    """The frame a ``save_frame`` (of either package) wrote to
    ``dir_uri``."""
    meta = json.loads(read_bytes(f"{dir_uri}/frame.json"))
    npz = np.load(io.BytesIO(read_bytes(f"{dir_uri}/columns.npz")),
                  allow_pickle=False)
    vecs = []
    for n, t, dom in zip(meta["names"], meta["types"], meta["domains"]):
        if t in (T_STR, T_UUID):
            vecs.append(Vec(meta["strings"][n], t))
        elif t == T_CAT:
            vecs.append(Vec(npz[f"c_{n}"].astype(np.int32), t, domain=dom))
        else:
            # keep the saved dtype: T_TIME epoch-ms (and any float64 numeric
            # host copy) exceeds f32 precision (~131 s ulp at epoch scale);
            # a round trip must not corrupt timestamps.
            vecs.append(Vec(npz[f"c_{n}"], t))
    return Frame(meta["names"], vecs)


# -- cloud object-store backends (h2o-persist-s3 / -gcs analogs) ------------

def register_s3(endpoint_url: Optional[str] = None,
                access_key: Optional[str] = None,
                secret_key: Optional[str] = None,
                scheme: str = "s3") -> None:
    """Register an ``s3://bucket/key`` byte store against an S3-compatible
    HTTP endpoint (reference: h2o-persist-s3 / PersistS3.java; the
    reference likewise reads credentials + endpoint overrides from config).

    boto3 is not in the image, so objects move over the S3 REST surface
    directly (GET/PUT object).  ``endpoint_url`` (or the
    ``AWS_ENDPOINT_URL`` env var) points at the store — a real
    S3-compatible service (minio, GCS interop, on-prem) or a test stub.
    SigV4 signing is intentionally out of scope: deployments front the
    store with instance-profile proxies or presigned endpoints; anonymous
    + header-token access is what the direct path supports
    (``access_key``/``secret_key`` go out as AWS_ACCESS_KEY_ID /
    x-api-key headers for stores that accept static credentials)."""
    import urllib.request

    endpoint = (endpoint_url or os.environ.get("AWS_ENDPOINT_URL") or
                "").rstrip("/")
    if not endpoint:
        raise ValueError("register_s3 needs endpoint_url (or "
                         "AWS_ENDPOINT_URL)")

    def _url(uri: str) -> str:
        _, rest = uri.split("://", 1)          # bucket/key...
        return f"{endpoint}/{rest}"

    def _headers() -> Dict[str, str]:
        h = {}
        if access_key:
            h["AWS_ACCESS_KEY_ID"] = access_key
            h["x-api-key"] = access_key
        if secret_key:
            h["AWS_SECRET_ACCESS_KEY"] = secret_key
        return h

    def reader(uri: str) -> bytes:
        req = urllib.request.Request(_url(uri), headers=_headers())
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.read()

    def writer(uri: str, data: bytes) -> None:
        req = urllib.request.Request(_url(uri), data=data,
                                     headers=_headers(), method="PUT")
        with urllib.request.urlopen(req, timeout=60) as r:
            r.read()

    register_scheme(scheme, reader, writer)
    log.info("registered %s:// persist backend -> %s", scheme, endpoint)


def register_gcs(token: Optional[str] = None,
                 endpoint_url: Optional[str] = None) -> None:
    """Register a ``gcs://bucket/object`` byte store over the GCS JSON
    API (reference: h2o-persist-gcs / PersistGcs.java).

    Credentials: a bearer token from ``token`` or the
    ``GOOGLE_OAUTH_ACCESS_TOKEN`` env var (how short-lived tokens reach
    containers); public buckets work anonymously.  ``endpoint_url``
    overrides the API host (fake-gcs-server / tests)."""
    import urllib.parse
    import urllib.request

    endpoint = (endpoint_url or
                os.environ.get("GCS_ENDPOINT_URL") or
                "https://storage.googleapis.com").rstrip("/")

    def _headers() -> Dict[str, str]:
        tok = token or os.environ.get("GOOGLE_OAUTH_ACCESS_TOKEN")
        h = {"User-Agent": "h2o-tpu/persist"}
        if tok:
            h["Authorization"] = f"Bearer {tok}"
        return h

    def _parts(uri: str):
        _, rest = uri.split("://", 1)
        bucket, _, obj = rest.partition("/")
        return bucket, urllib.parse.quote(obj, safe="")

    def reader(uri: str) -> bytes:
        bucket, obj = _parts(uri)
        url = f"{endpoint}/storage/v1/b/{bucket}/o/{obj}?alt=media"
        req = urllib.request.Request(url, headers=_headers())
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.read()

    def writer(uri: str, data: bytes) -> None:
        bucket, obj = _parts(uri)
        url = (f"{endpoint}/upload/storage/v1/b/{bucket}/o"
               f"?uploadType=media&name={obj}")
        hdrs = _headers()
        hdrs["Content-Type"] = "application/octet-stream"
        req = urllib.request.Request(url, data=data, headers=hdrs,
                                     method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            r.read()

    register_scheme("gcs", reader, writer)
    log.info("registered gcs:// persist backend -> %s", endpoint)


def register_hdfs(namenode_http: Optional[str] = None,
                  user: Optional[str] = None) -> None:
    """Register an ``hdfs://path`` byte store over WebHDFS (reference:
    h2o-persist-hdfs / PersistHdfs.java — that module links the Hadoop
    client; the wire-compatible TPU path is the NameNode's WebHDFS REST
    surface, which every Hadoop deployment exposes).

    ``namenode_http`` (or HDFS_NAMENODE_URL env) is the NameNode's HTTP
    address, e.g. ``http://namenode:9870``; ``user`` (or HADOOP_USER_NAME)
    goes out as the ``user.name`` query param (simple auth)."""
    import urllib.parse
    import urllib.error
    import urllib.request

    endpoint = (namenode_http or
                os.environ.get("HDFS_NAMENODE_URL") or "").rstrip("/")
    if not endpoint:
        raise ValueError("register_hdfs needs namenode_http (or "
                         "HDFS_NAMENODE_URL)")
    uname = user or os.environ.get("HADOOP_USER_NAME")

    def _url(uri: str, op: str, **extra) -> str:
        _, rest = uri.split("://", 1)
        path = rest if rest.startswith("/") else "/" + rest
        q = {"op": op, **extra}
        if uname:
            q["user.name"] = uname
        return (f"{endpoint}/webhdfs/v1"
                f"{urllib.parse.quote(path)}?{urllib.parse.urlencode(q)}")

    def reader(uri: str) -> bytes:
        # OPEN redirects to a DataNode; urllib follows it
        req = urllib.request.Request(_url(uri, "OPEN"))
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.read()

    def writer(uri: str, data: bytes) -> None:
        # two-step create: NameNode 307 -> DataNode PUT
        req = urllib.request.Request(
            _url(uri, "CREATE", overwrite="true"), method="PUT")

        class _NoRedirect(urllib.request.HTTPRedirectHandler):
            def redirect_request(self, *a, **k):
                return None
        opener = urllib.request.build_opener(_NoRedirect)
        try:
            with opener.open(req, timeout=120) as r:
                loc = r.headers.get("Location")
        except urllib.error.HTTPError as e:
            if e.code != 307:
                raise
            loc = e.headers.get("Location")
        if not loc:
            raise IOError(f"WebHDFS CREATE for {uri} returned no "
                          "DataNode redirect")
        req2 = urllib.request.Request(loc, data=data, method="PUT")
        with urllib.request.urlopen(req2, timeout=300) as r:
            r.read()

    register_scheme("hdfs", reader, writer)
    log.info("registered hdfs:// persist backend -> %s (WebHDFS)",
             endpoint)
