"""Crash-safe snapshots of accumulated engine state (atomic, verified).

Port of ``metrics_tpu/engine/snapshot.py``. Recovery contract: a snapshot
directory always holds at least one COMPLETE snapshot once any save
finished, whenever the process dies.

Layout (one directory per engine)::

    <dir>/snap_000000000042_<ns>              # one pickle file per snapshot;
    <dir>/integrity_snap_000000000042_<ns>.json  # <ns> = creation time in ns,
    <dir>/LATEST                              # so a reset/restarted engine
                                              # never rewrites an existing one

Atomicity: the payload is written first, then its integrity sidecar (sha256
over a canonical serialization of the whole payload), then ``LATEST`` is
replaced through a temp file and ``os.replace``. A kill mid-payload leaves a
``snap_*`` that ``LATEST`` never points to; a kill mid-pointer leaves the
previous pointer. Older snapshots beyond ``keep`` are removed, by creation
order, after the pointer moves; ``LATEST``'s target never is.
``load_snapshot`` re-derives the digest and raises a typed
:class:`SnapshotCorruptError` on a mismatch or on a payload that does not
deserialize; with ``fallback=True`` it walks the retained generations
newest-first past corrupt ones.

The file format is the JAX package's pickle codec, so a snapshot crosses
between the packages in both directions: a dict ``{"state", "meta"[,
"host_attrs"]}`` of numpy arrays, Python scalars, strings and ``None``, never
a ``torch.Tensor`` (JAX unpickles it without torch). Tensors cross to numpy
through ``utils/state_bridge.py`` (a bf16 leaf as ``ml_dtypes.bfloat16``,
raising, naming the leaf, where ``ml_dtypes`` is missing); meta ints are
written as 0-d arrays, as JAX writes them. The integrity digest is JAX's,
byte for byte: it hashes the ``repr`` of JAX's treedef of the payload
(:func:`~metrics_tpu_torch.utils.tree.spell_treedef`) and the leaves in
JAX's order. The JAX package's default codec, orbax (a directory per
snapshot), imports JAX: the port refuses such a snapshot, naming orbax.

``host_attrs`` carry the metric's host-derived compute attributes
(``Metric.host_compute_attrs``, e.g. ``Accuracy``'s input mode) as a JSON
byte array, enums by class path and value. The port writes its enums under
the JAX package's module path (``metrics_tpu.utils.enums``) so that JAX
decodes a real enum member, and reads either package's path as its own
module; any other module path is refused.

``load_snapshot`` returns the state as host numpy; the engines seat it
(``engine/pipeline.py`` ``restore``).
"""
import hashlib
import importlib
import json
import os
import pickle
import shutil
import time
from enum import Enum
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from metrics_tpu_torch.engine.faults import SnapshotCorruptError
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError
from metrics_tpu_torch.utils.state_bridge import state_to_numpy
from metrics_tpu_torch.utils.tree import spell_treedef

__all__ = [
    "SnapshotCorruptError",
    "generations",
    "latest_snapshot",
    "load_snapshot",
    "save_snapshot",
]

_LATEST = "LATEST"
_PORT_PKG = "metrics_tpu_torch"
#: the JAX package's name, as the snapshot files spell enum module paths (a string, never imported)
_JAX_PKG = "metrics_tpu"
#: files only an orbax checkpoint directory holds
_ORBAX_MARKERS = ("_METADATA", "_CHECKPOINT_METADATA", "manifest.ocdbt")


def _integrity_path(path: str) -> str:
    """Checksum sidecar for a snapshot: ``integrity_<name>.json`` next to it
    (not ``snap_``-prefixed, so no listing mistakes it for a generation)."""
    return os.path.join(os.path.dirname(path), f"integrity_{os.path.basename(path)}.json")


def _encode_host_attr(v: Any) -> Any:
    """JSON-able encoding of one host-derived attribute value. An enum
    carries its class path, the port's package renamed to the JAX package's,
    so either package decodes its own real enum member; ndarrays and tuples
    round-trip typed. Anything else raises, naming its type."""
    if isinstance(v, Enum):
        module = type(v).__module__
        if module == _PORT_PKG or module.startswith(_PORT_PKG + "."):
            module = _JAX_PKG + module[len(_PORT_PKG):]
        return {"__enum__": [module, type(v).__qualname__], "value": v.value}
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, np.ndarray):
        return {"__ndarray__": v.tolist(), "dtype": v.dtype.str}
    if isinstance(v, tuple):
        return {"__tuple__": [_encode_host_attr(x) for x in v]}
    if isinstance(v, list):
        return [_encode_host_attr(x) for x in v]
    if isinstance(v, (bool, int, float, str, type(None))):
        return v
    raise TypeError(
        f"host-derived compute attr of type {type(v).__name__} is not snapshot-"
        "serializable; supported: scalars, strings, None, enums, tuples/lists, ndarrays"
    )


def _port_module(module: str) -> str:
    """The port's module for an enum's recorded module path: either
    package's path maps to the port's own; any other path is refused."""
    for pkg in (_PORT_PKG, _JAX_PKG):
        if module == pkg or module.startswith(pkg + "."):
            return _PORT_PKG + module[len(pkg):]
    raise MetricsTPUUserError(
        f"snapshot host attribute names an enum of module {module!r}; the port decodes enums of its own "
        f"package ({_PORT_PKG!r}) or the JAX package's ({_JAX_PKG!r}) only"
    )


def _decode_host_attr(v: Any) -> Any:
    if isinstance(v, dict) and "__enum__" in v:
        module, qualname = v["__enum__"]
        cls: Any = importlib.import_module(_port_module(module))
        for part in qualname.split("."):
            cls = getattr(cls, part)
        return cls(v["value"])
    if isinstance(v, dict) and "__ndarray__" in v:
        return np.asarray(v["__ndarray__"], np.dtype(v["dtype"]))
    if isinstance(v, dict) and "__tuple__" in v:
        return tuple(_decode_host_attr(x) for x in v["__tuple__"])
    if isinstance(v, list):
        return [_decode_host_attr(x) for x in v]
    return v


def _host_attrs_to_bytes(attrs: Dict[str, Any]) -> np.ndarray:
    doc = json.dumps({k: _encode_host_attr(v) for k, v in attrs.items()})
    return np.frombuffer(doc.encode("utf-8"), np.uint8).copy()


def _host_attrs_from_bytes(buf: Any) -> Dict[str, Any]:
    doc = json.loads(bytes(np.asarray(buf, np.uint8)).decode("utf-8"))
    return {k: _decode_host_attr(v) for k, v in doc.items()}


def _payload_digest(payload: Any) -> str:
    """sha256 over a canonical serialization of the payload, equal to the
    JAX package's for the same payload: the ``repr`` of JAX's treedef, then
    per leaf in JAX's order a typed header and, for arrays, the raw bytes.
    Computed on the host payload at save time and re-derived from the
    deserialized payload at load time, so it catches bit flips that still
    deserialize."""
    h = hashlib.sha256()
    leaves, spelled = spell_treedef(payload)
    h.update(spelled.encode())
    for leaf in leaves:
        # strings BEFORE the numpy branch: a codec may hand back np.str_
        # (both a str and an np.generic); normalize to the python value
        if isinstance(leaf, str):
            h.update(f"s:str:{str(leaf)!r}".encode())
        elif isinstance(leaf, (bytes, bytearray)):
            h.update(b"b:")
            h.update(bytes(leaf))
        elif isinstance(leaf, (np.ndarray, np.generic)):
            arr = np.asarray(leaf)
            h.update(f"a:{arr.dtype.str}:{arr.shape}".encode())
            h.update(np.ascontiguousarray(arr).tobytes())
        elif isinstance(leaf, (bool, int, float, type(None))):
            h.update(f"s:{type(leaf).__name__}:{leaf!r}".encode())
        else:  # pragma: no cover - payloads are numpy/scalars by construction
            h.update(f"o:{leaf!r}"[:256].encode())
    return h.hexdigest()


def save_snapshot(
    directory: str,
    state: Any,
    meta: Dict[str, Any],
    keep: int = 2,
    host_attrs: Optional[Dict[str, Any]] = None,
) -> str:
    """Write one complete snapshot and atomically advance ``LATEST``.

    ``state`` is the engine's state tree (tensors or numpy: a packed arena,
    a logical tree, a paged arena with its pager payload); the loader returns
    it verbatim, as numpy. ``meta`` is a flat dict of ints, floats and
    strings; ``host_attrs`` the metric's host-derived compute attributes
    (returned under ``meta["host_attrs"]`` on load). Returns the snapshot's
    path. Keeps the newest ``keep`` snapshots and removes the rest.
    """
    os.makedirs(directory, exist_ok=True)
    step = int(meta.get("step", 0))
    # UNIQUE, not just step-keyed: after a reset or restart the same step
    # comes round again, and rewriting LATEST's target in place would break
    # the "LATEST always names a complete snapshot" guarantee
    name = f"snap_{step:012d}_{time.time_ns():016x}"
    payload = {
        "state": state_to_numpy(state),
        "meta": {k: np.asarray(v) if isinstance(v, (int, float)) else v for k, v in meta.items()},
    }
    if host_attrs:
        payload["host_attrs"] = _host_attrs_to_bytes(host_attrs)
    path = os.path.join(directory, name)
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    # the sidecar AFTER the payload, BEFORE the pointer: a kill between them
    # leaves an unreferenced generation; LATEST never names an unverifiable one
    with open(_integrity_path(path), "w") as f:
        json.dump({"sha256": _payload_digest(payload)}, f)
    tmp = os.path.join(directory, _LATEST + ".tmp")
    with open(tmp, "w") as f:
        f.write(name)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(directory, _LATEST))
    _gc(directory, keep)
    return path


def _gc(directory: str, keep: int) -> None:
    latest = latest_snapshot(directory)
    # newest by CREATION order (the ns suffix), not by step: after a reset the
    # step counter goes backwards
    snaps = sorted((n for n in os.listdir(directory) if n.startswith("snap_")), key=lambda n: n.rsplit("_", 1)[-1])
    for n in snaps[:-keep] if keep > 0 else []:
        full = os.path.join(directory, n)
        if latest is not None and full == latest:
            continue  # never remove the pointer's target
        shutil.rmtree(full, ignore_errors=True) if os.path.isdir(full) else os.unlink(full)
        integrity = _integrity_path(full)
        if os.path.exists(integrity):
            os.unlink(integrity)


def latest_snapshot(directory: str) -> Optional[str]:
    """Path of the newest COMPLETE snapshot, or None."""
    pointer = os.path.join(directory, _LATEST)
    if not os.path.exists(pointer):
        return None
    with open(pointer) as f:
        name = f.read().strip()
    path = os.path.join(directory, name)
    return path if os.path.exists(path) else None


def generations(directory: str) -> List[str]:
    """Every retained snapshot path under ``directory``, newest-first by
    creation order: the generation ring the fallback restore walks."""
    try:
        names = os.listdir(directory)
    except (FileNotFoundError, NotADirectoryError):
        return []
    snaps = [n for n in names if n.startswith("snap_")]
    return [os.path.join(directory, n) for n in sorted(snaps, key=lambda n: n.rsplit("_", 1)[-1], reverse=True)]


def _refuse_orbax(path: str) -> None:
    """An orbax checkpoint directory (the JAX package's default codec) cannot
    be read here: orbax imports JAX."""
    if any(os.path.exists(os.path.join(path, m)) for m in _ORBAX_MARKERS):
        raise MetricsTPUUserError(
            f"snapshot {path} is an orbax checkpoint directory, which the port cannot read (orbax imports JAX); "
            "re-save it with the JAX package's pickle codec (metrics_tpu.engine.snapshot with orbax off), "
            "which both packages read"
        )


def _load_verified(path: str, verify: bool = True) -> Any:
    """Deserialize and integrity-check one snapshot payload. Every failure
    of a rotten payload (truncation, bit flips the unpickler rejects or
    silently accepts) is one typed :class:`SnapshotCorruptError` naming the
    path and generation."""
    generation = os.path.basename(path)
    if not os.path.exists(path):
        # an ABSENT snapshot is not a corrupt one: "no snapshot yet" callers
        # catch FileNotFoundError
        raise FileNotFoundError(f"no snapshot at {path}")
    if os.path.isdir(path):
        _refuse_orbax(path)
    try:
        with open(path, "rb") as f:
            payload = pickle.load(f)
        if not isinstance(payload, dict) or "state" not in payload or "meta" not in payload:
            raise SnapshotCorruptError(path, generation=generation, reason="payload is not a snapshot dict")
    except SnapshotCorruptError:
        raise
    except Exception as e:
        raise SnapshotCorruptError(
            path, generation=generation, reason=f"deserialization failed: {type(e).__name__}: {e}"
        ) from e
    integrity = _integrity_path(path)
    if verify and os.path.exists(integrity):
        try:
            with open(integrity) as f:
                want = json.load(f)["sha256"]
        except Exception as e:
            raise SnapshotCorruptError(path, generation=generation, reason="unreadable integrity sidecar") from e
        got = _payload_digest(payload)
        if got != want:
            raise SnapshotCorruptError(
                path, generation=generation, reason=f"checksum mismatch (want {want[:12]}…, got {got[:12]}…)"
            )
    return payload


def load_snapshot(directory_or_path: str, fallback: bool = False, verify: bool = True) -> Tuple[Any, Dict[str, Any]]:
    """Load ``(state, meta)`` from a snapshot directory (follows ``LATEST``)
    or an explicit snapshot path; the state as host numpy. Raises
    ``FileNotFoundError`` when none exists.

    With ``fallback=True`` (directory form only) a corrupt payload does not
    end recovery: the generation ring is walked newest-first past every
    :class:`SnapshotCorruptError` to the newest valid generation;
    ``meta["generations_skipped"]`` counts what was skipped and
    ``meta["snapshot_path"]`` names what loaded. Raises the last corruption
    error when every generation is rotten. ``verify=False`` skips the
    checksum (deserialization errors still surface typed)."""
    path = directory_or_path
    skipped = 0
    if os.path.isdir(path) and not os.path.basename(path).startswith("snap_"):
        latest = latest_snapshot(path)
        ring = generations(path)
        if latest is None and not (fallback and ring):
            raise FileNotFoundError(f"no complete snapshot under {path}")
        candidates = [latest] if latest is not None else []
        if fallback:
            candidates += [p for p in ring if p != latest]
        payload, path = None, None
        last_err: Optional[SnapshotCorruptError] = None
        for cand in candidates:
            try:
                payload = _load_verified(cand, verify=verify)
                path = cand
                break
            except SnapshotCorruptError as e:
                if not fallback:
                    raise
                skipped += 1
                last_err = e
        if payload is None:
            raise last_err
    else:
        payload = _load_verified(path, verify=verify)
    meta = {k: (int(v) if isinstance(v, np.ndarray) and v.dtype.kind in "iu" else v) for k, v in payload["meta"].items()}
    if "host_attrs" in payload:
        meta["host_attrs"] = _host_attrs_from_bytes(payload["host_attrs"])
    meta["snapshot_path"] = path
    meta["generations_skipped"] = skipped
    return payload["state"], meta
