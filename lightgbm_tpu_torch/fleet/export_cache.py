"""Persistent predictor-entry cache: which entries a restart finds warm
(port of lightgbm_tpu/fleet/export_cache.py, its file conventions and
counters).

The JAX package persists serialized XLA executables here, so a restart
compiles nothing. The port compiles nothing per shape: a predictor
entry is the prepared bucket (a device input buffer, a pinned output
buffer and one warm-up walk, `serving/predictor.py`), and a captured
CUDA graph, the one per-shape artefact worth keeping, belongs to its
process and cannot be written to disk. What an entry carries across a
restart is its spec -- the family key (`PredictorCache.family`) and the
bucket -- so that the restarted registry installs the entry's buffers
directly: a hit counts neither a build nor a miss, and saves that
entry's build walk (tens of ms on the card), nothing more.

Conventions kept from the JAX package:

* ``<model_file>.xcache/`` is the directory (`cache_dir_for_model`);
* the entry's file name is the sha256 of (family, bucket), ``.xc``;
* an entry is a magic line, a 4-byte big-endian header length, a JSON
  header, then the payload; writes are atomic (a temp file of the
  writer's own + os.replace), so replicas may share the directory; a
  failed write is logged and skipped (the cache is best-effort);
* a torn, corrupt or foreign entry is a miss -- the port's magic
  differs from the JAX package's, so a JAX entry in the same directory
  is a miss and is never read as the port's;
* the environment fingerprint lives INSIDE the entry, not in its name:
  an entry written under another torch, CUDA or card is rebuilt the
  ordinary way (one build, counted in ``export_cache_rebuilds``) and
  overwritten in place;
* counters ``export_cache_hits`` / ``_rebuilds`` / ``_misses`` /
  ``_saves`` and the gauge ``export_cache_last_restored``.

A failure to build or allocate an entry on the card raises: only a
missing or unreadable file is a miss.
"""
from __future__ import annotations

import hashlib
import json
import os
import struct
import tempfile
import time
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..ops.predict import _bucket_up
from ..telemetry import counters as telem_counters
from ..utils import log

__all__ = ["ExportCache", "cache_dir_for_model", "env_fingerprint"]

_MAGIC = b"LGBMTORCHXC1\n"


def env_fingerprint(device) -> Dict[str, str]:
    """The validity domain of an entry's spec: the torch and CUDA
    versions and the device (name and compute capability, or ``cpu``).
    The port donates no buffer, so ``donate`` is "0"."""
    dev = torch.device(device)
    fp = {"torch": torch.__version__, "cuda": str(torch.version.cuda),
          "donate": "0"}
    if dev.type == "cuda":
        fp["device"] = torch.cuda.get_device_name(dev)
        fp["capability"] = "%d.%d" % torch.cuda.get_device_capability(dev)
    else:
        fp["device"] = fp["capability"] = "cpu"
    return fp


def cache_dir_for_model(model_file: str) -> str:
    """The on-disk location convention: `<model_file>.xcache/` -- the
    cache travels with the model artifact through a rollout."""
    return str(model_file) + ".xcache"


def _spec(family: Tuple, bucket: int) -> bytes:
    return repr((family, int(bucket))).encode()


class ExportCache:
    """One on-disk directory of predictor-entry specs."""

    def __init__(self, cache_dir: str):
        self.cache_dir = str(cache_dir)
        self.last_restore: Dict[str, int] = {}

    # -- keys -----------------------------------------------------------
    @staticmethod
    def entry_name(family: Tuple, bucket: int) -> str:
        digest = hashlib.sha256(
            repr((family, int(bucket))).encode()).hexdigest()[:32]
        return f"{digest}.xc"

    def _path(self, family: Tuple, bucket: int) -> str:
        return os.path.join(self.cache_dir, self.entry_name(family, bucket))

    # -- write ----------------------------------------------------------
    def save(self, model, predictor, overwrite: bool = False) -> int:
        """Write the spec of every entry of `model` (matched by ensemble
        shape signature + device) into the cache dir. Returns the number
        of entries written; existing entries are kept unless `overwrite`
        (restore already rewrote any whose environment differed)."""
        entries = [(fam, bucket) for fam, bucket, _ in predictor.entries()
                   if fam[0] == model.shape_sig
                   and fam[6] == model.device_key]
        if not entries:
            return 0
        os.makedirs(self.cache_dir, exist_ok=True)
        written = 0
        for family, bucket in entries:
            path = self._path(family, bucket)
            if not overwrite and os.path.exists(path):
                continue
            try:
                self._write_entry(path, family, bucket, model)
                written += 1
            except OSError as exc:   # the cache is best-effort
                log.warning("export cache: writing bucket=%d failed: %s",
                            bucket, exc)
        if written:
            log.info("export cache: wrote %d entr%s to %s", written,
                     "y" if written == 1 else "ies", self.cache_dir)
        return written

    def _write_entry(self, path, family, bucket, model) -> None:
        payload = _spec(family, bucket)
        header = json.dumps({
            "env": env_fingerprint(model.device),
            "bucket": int(bucket),
            "n_features": int(family[1]),
            "raw_score": bool(family[4]),
            "device": family[6],
            "version": model.version,
            "created_unix": round(time.time(), 3),
            "payload_len": len(payload),
        }).encode()
        # a temp file of its own: replicas sharing the directory may
        # write the same entry at once
        fd, tmp = tempfile.mkstemp(prefix=".xc_", dir=self.cache_dir)
        try:
            with os.fdopen(fd, "wb") as fh:
                fh.write(_MAGIC)
                fh.write(struct.pack(">I", len(header)))
                fh.write(header)
                fh.write(payload)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        telem_counters.incr("export_cache_saves")

    # -- read -----------------------------------------------------------
    def restore(self, model, predictor, buckets: Sequence[int],
                raw_flags: Sequence[bool] = (False,)) -> Dict[str, int]:
        """Install the cached entries of every (bucket, raw_score) pair
        into `predictor`. An entry written in this environment is
        installed (its buffers allocated, no walk); one written in
        another is built the ordinary way and rewritten; anything else
        is a miss the caller warms the ordinary way. Returns {restored,
        rebuilt, missed} and remembers it in `last_restore`."""
        from ..serving.predictor import _Entry
        stats = {"restored": 0, "rebuilt": 0, "missed": 0}
        want_env = env_fingerprint(model.device)
        for raw in raw_flags:
            family = predictor.family(model, model.num_features, bool(raw))
            for bucket_rows in buckets:
                bucket = min(_bucket_up(max(1, int(bucket_rows))),
                             predictor.max_batch_rows)
                path = self._path(family, bucket)
                entry = self._read_entry(path)
                if entry is None or entry[1] != _spec(family, bucket):
                    stats["missed"] += 1
                    telem_counters.incr("export_cache_misses")
                    continue
                if entry[0]["env"] == want_env:
                    predictor.install(family, bucket, _Entry(
                        bucket, int(family[1]), model.num_class,
                        model.device))
                    stats["restored"] += 1
                    telem_counters.incr("export_cache_hits")
                else:
                    predictor._build(family, bucket, model, int(family[1]),
                                     bool(raw))
                    try:
                        self._write_entry(path, family, bucket, model)
                    except OSError as exc:   # the cache is best-effort
                        log.warning("export cache: rewriting bucket=%d "
                                    "failed: %s", bucket, exc)
                    stats["rebuilt"] += 1
                    telem_counters.incr("export_cache_rebuilds")
        self.last_restore = dict(stats)
        telem_counters.set_gauge(
            "export_cache_last_restored", stats["restored"])
        return stats

    def _read_entry(self, path: str) -> Optional[Tuple[dict, bytes]]:
        """(header, payload), or None for a missing, torn or foreign
        file."""
        try:
            with open(path, "rb") as fh:
                if fh.read(len(_MAGIC)) != _MAGIC:
                    return None
                (hlen,) = struct.unpack(">I", fh.read(4))
                header = json.loads(fh.read(hlen))
                payload = fh.read(header["payload_len"])
                if len(payload) != header["payload_len"] \
                        or not isinstance(header.get("env"), dict):
                    return None                     # torn write
                return header, payload
        except (OSError, ValueError, KeyError, TypeError, struct.error):
            return None

    # -- introspection ---------------------------------------------------
    def info(self) -> Dict[str, object]:
        """The port's entries in the directory (a JAX entry beside them
        is not counted), their bytes and the last restore's tally."""
        files, size = [], 0
        try:
            for name in os.listdir(self.cache_dir):
                path = os.path.join(self.cache_dir, name)
                if name.endswith(".xc") and self._read_entry(path):
                    files.append(name)
                    size += os.path.getsize(path)
        except OSError:
            pass
        return {"dir": self.cache_dir, "entries": len(files),
                "bytes": size, "last_restore": dict(self.last_restore)}
