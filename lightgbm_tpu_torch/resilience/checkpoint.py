"""Full training checkpoints: atomic, checksummed, rotated, resumable
(port of lightgbm_tpu/resilience/checkpoint.py, the same file format: a
checkpoint written by either package loads in the other).

A checkpoint captures everything ``engine.train`` needs to continue a
boosting run exactly where it stopped — not just the model text the
CLI's ``snapshot_freq`` saves, but the live training state: iteration
counter, raw score tensors (train + every valid set, bit-exact f32, so
resumed gradients match the uninterrupted run to the last ulp), the
bagging RNG, the current bag, DART's tree weights, and the engine-level
eval history that early stopping is computed from. Iteration boundaries
are the consistency point (per-iteration allreduce structure,
arXiv:1806.11248): a checkpoint is only ever written between updates.

File format (single file, designed so a mid-write kill can never be
mistaken for a valid checkpoint):

    LGBMTPUCKPT1\\n
    {manifest json: format, version, iteration, payload_sha256, ...}\\n
    <npz payload: model_text, state_json, score arrays, rng keys>

The port adds two npz arrays, each tree's internal values and shrinkage
in f64 (the model text prints them to 6 digits, and DART rescales trees
already written); the JAX package's reader ignores them.

Writes go to a temp file in the destination directory, are fsynced, and
``os.replace``d into place; reads verify size + SHA-256 before touching
the payload. ``CheckpointManager`` names files ``ckpt_iter_NNNNNNN.ckpt``,
keeps the last K, and ``latest()`` skips corrupt/truncated files.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import re
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..utils import log
from ..utils.log import LightGBMError

__all__ = ["CheckpointError", "CheckpointData", "CheckpointManager",
           "atomic_write_text", "atomic_write_bytes", "save_checkpoint",
           "load_checkpoint", "find_checkpoint", "restore_checkpoint"]

MAGIC = b"LGBMTPUCKPT1\n"
FORMAT = "lgbm-tpu-checkpoint"
# Version 2 adds out-of-core streaming state (stream cursor +
# GOSS working-set membership, io/stream.py). Writers only stamp 2 —
# with a matching min_reader_version — when stream state is present, so
# non-streamed checkpoints stay readable by version-1 readers.
VERSION = 2
_CKPT_RE = re.compile(r"_iter_(\d+)\.ckpt$")


class CheckpointError(LightGBMError):
    """Missing, truncated, or corrupt checkpoint."""


# -- atomic filesystem primitives --------------------------------------

def atomic_write_bytes(path: str, data: bytes) -> None:
    """Write-to-temp + fsync + rename: readers never observe a partial
    file, and a kill mid-write leaves the previous version intact."""
    path = os.path.abspath(path)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=os.path.basename(path) + ".tmp.",
                               dir=d or ".")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def atomic_write_text(path: str, text: str) -> None:
    atomic_write_bytes(path, text.encode("utf-8"))


# -- file format --------------------------------------------------------

def write_checkpoint_file(path: str, meta: Dict[str, Any],
                          arrays: Dict[str, np.ndarray]) -> None:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    payload = buf.getvalue()
    manifest = dict(meta)
    manifest["payload_sha256"] = hashlib.sha256(payload).hexdigest()
    manifest["payload_size"] = len(payload)
    header = MAGIC + (json.dumps(manifest, sort_keys=True) + "\n").encode()
    atomic_write_bytes(path, header + payload)


def read_checkpoint_file(path: str) -> Tuple[Dict[str, Any], Any]:
    if not os.path.isfile(path):
        raise CheckpointError(f"no checkpoint at {path}")
    with open(path, "rb") as f:
        blob = f.read()
    if not blob.startswith(MAGIC):
        raise CheckpointError(f"{path}: not a lightgbm_tpu checkpoint")
    try:
        nl = blob.index(b"\n", len(MAGIC))
        manifest = json.loads(blob[len(MAGIC):nl].decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as exc:
        raise CheckpointError(f"{path}: unreadable manifest ({exc})")
    payload = blob[nl + 1:]
    if len(payload) != int(manifest.get("payload_size", -1)):
        raise CheckpointError(
            f"{path}: truncated payload ({len(payload)} bytes, manifest "
            f"says {manifest.get('payload_size')})")
    digest = hashlib.sha256(payload).hexdigest()
    if digest != manifest.get("payload_sha256"):
        raise CheckpointError(f"{path}: payload checksum mismatch")
    npz = np.load(io.BytesIO(payload), allow_pickle=False)
    return manifest, npz


# -- capture / restore --------------------------------------------------

def _gbdt_of(booster):
    return getattr(booster, "_gbdt", booster)


def _params_hash(gbdt) -> str:
    try:
        return hashlib.sha256(gbdt.config.to_string().encode()).hexdigest()
    except Exception:   # model-only boosters carry no full config
        return ""


def _pack_rng(state) -> Tuple[list, np.ndarray]:
    name, keys, pos, has_gauss, cached = state
    return ([str(name), int(pos), int(has_gauss), float(cached)],
            np.asarray(keys, dtype=np.uint32))


def _unpack_rng(meta: list, keys: np.ndarray):
    return (meta[0], np.asarray(keys, dtype=np.uint32), int(meta[1]),
            int(meta[2]), float(meta[3]))


class CheckpointData:
    """Decoded checkpoint: manifest meta, model text, training state dict
    (the shape GBDT.restore_state expects), and engine eval history."""

    def __init__(self, meta, model_text, state, history, path=None):
        self.meta = meta
        self.model_text = model_text
        self.state = state
        self.history = history
        self.path = path

    @property
    def iteration(self) -> int:
        return int(self.meta.get("iteration", 0))


def _refuse_data_parallel(gbdt) -> None:
    """A data-parallel run keeps each rank's scores only: its checkpoints
    (rank-0 writes, a resume broadcast) are a later slice's."""
    if getattr(gbdt, "row_block", None) is not None:
        from ..utils.log import LightGBMError
        raise LightGBMError(
            "checkpoints of a tree_learner=data run are not supported by "
            "lightgbm_tpu_torch yet (ROADMAP.md section 1, item 5: "
            "distributed/checkpoint.py)")


def capture(booster, history: Optional[list] = None,
            extra_meta: Optional[Dict[str, Any]] = None
            ) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
    """-> (meta, arrays) ready for write_checkpoint_file, taken between
    iterations (the port's fused iteration commits its tree before it
    returns, so every boundary is consistent).

    ``extra_meta`` merges caller context into the manifest — e.g. the
    run's original round budget (``target_rounds``) so a resume after
    preemption finishes the right count, or ``preempted=True`` marking
    an emergency checkpoint. Reserved keys (format/version/iteration/
    checksums) cannot be overridden."""
    gbdt = _gbdt_of(booster)
    _refuse_data_parallel(gbdt)
    st = gbdt.capture_state()
    model_text = gbdt.save_model_to_string(0, -1)
    arrays: Dict[str, np.ndarray] = {"model_text": np.array(model_text)}
    # the two tree fields that model text prints to 6 digits and later
    # iterations rescale in place (DART's drops): kept exact beside the
    # text. A reader that does not know these keys (the JAX package's)
    # ignores them and takes the text's values.
    models = list(gbdt.models)
    arrays["tree_internal_value"] = np.concatenate(
        [np.asarray(t.internal_value[:max(t.num_leaves - 1, 0)],
                    dtype=np.float64) for t in models]
        + [np.zeros(0, np.float64)])
    arrays["tree_shrinkage"] = np.asarray([t.shrinkage for t in models],
                                          dtype=np.float64)
    rng_meta, rng_keys = _pack_rng(st["bag_rng"])
    arrays["bag_rng_keys"] = rng_keys
    state_json: Dict[str, Any] = {
        "iter": int(st["iter"]),
        "shrinkage_rate": float(st["shrinkage_rate"]),
        "best_iteration": int(st["best_iteration"]),
        "num_init_iteration": int(st["num_init_iteration"]),
        "bag_rng": rng_meta,
        "n_valid": len(st["valid_scores"]),
    }
    if st.get("bag_indices") is not None:
        arrays["bag_indices"] = np.asarray(st["bag_indices"], dtype=np.int32)
    if st.get("train_score") is not None:
        arrays["train_score"] = np.asarray(st["train_score"],
                                           dtype=np.float32)
    for i, vs in enumerate(st["valid_scores"]):
        arrays[f"valid_score_{i}"] = np.asarray(vs, dtype=np.float32)
    if st.get("dart") is not None:
        d = st["dart"]
        drop_meta, drop_keys = _pack_rng(d["drop_rng"])
        arrays["dart_drop_rng_keys"] = drop_keys
        state_json["dart"] = {"tree_weights": [float(w) for w
                                               in d["tree_weights"]],
                              "sum_weight": float(d["sum_weight"]),
                              "drop_rng": drop_meta}
    version = 1
    if st.get("stream") is not None:
        # streaming state only exists when stream_mode is active; old
        # readers cannot resume it bit-identically, so the manifest
        # demands a version-2 reader in exactly that case
        stream = st["stream"]
        arrays["stream_ws_ids"] = np.asarray(
            stream.get("ws_ids", np.zeros(0, np.int32)), dtype=np.int32)
        state_json["stream"] = {"cursor": int(stream.get("cursor", 0))}
        version = VERSION
    arrays["state_json"] = np.array(json.dumps(state_json))
    arrays["history_json"] = np.array(json.dumps(history or []))
    meta = dict(extra_meta or {})
    meta.update({
        "format": FORMAT,
        "version": version,
        "min_reader_version": version,
        "iteration": int(st["iter"]),
        "num_class": int(gbdt.num_class),
        "num_trees": len(gbdt.models),
        "params_sha256": _params_hash(gbdt),
    })
    return meta, arrays


def save_checkpoint(path: str, booster, history: Optional[list] = None,
                    extra_meta: Optional[Dict[str, Any]] = None) -> str:
    meta, arrays = capture(booster, history, extra_meta=extra_meta)
    write_checkpoint_file(path, meta, arrays)
    return path


def load_checkpoint(path: str) -> CheckpointData:
    manifest, npz = read_checkpoint_file(path)
    if manifest.get("format") != FORMAT:
        raise CheckpointError(f"{path}: unknown format "
                              f"{manifest.get('format')!r}")
    need = int(manifest.get("min_reader_version", 1))
    if need > VERSION:
        raise CheckpointError(
            f"{path}: checkpoint requires reader version {need} "
            f"(this build reads up to {VERSION}); it was written by a "
            "newer build — resume with that build or retrain")
    state_json = json.loads(str(npz["state_json"].item()))
    st: Dict[str, Any] = {
        "iter": int(state_json["iter"]),
        "shrinkage_rate": float(state_json["shrinkage_rate"]),
        "best_iteration": int(state_json["best_iteration"]),
        "num_init_iteration": int(state_json["num_init_iteration"]),
        "bag_rng": _unpack_rng(state_json["bag_rng"], npz["bag_rng_keys"]),
        "bag_indices": (np.asarray(npz["bag_indices"])
                        if "bag_indices" in npz else None),
        "train_score": (np.asarray(npz["train_score"])
                        if "train_score" in npz else None),
        "valid_scores": [np.asarray(npz[f"valid_score_{i}"])
                         for i in range(int(state_json.get("n_valid", 0)))],
    }
    if "dart" in state_json:
        d = state_json["dart"]
        st["dart"] = {
            "tree_weights": list(d["tree_weights"]),
            "sum_weight": float(d["sum_weight"]),
            "drop_rng": _unpack_rng(d["drop_rng"],
                                    npz["dart_drop_rng_keys"]),
        }
    if "stream" in state_json:
        st["stream"] = {
            "cursor": int(state_json["stream"].get("cursor", 0)),
            "ws_ids": (np.asarray(npz["stream_ws_ids"], dtype=np.int32)
                       if "stream_ws_ids" in npz
                       else np.zeros(0, np.int32)),
        }
    if "tree_shrinkage" in npz:
        st["tree_internal_value"] = np.asarray(npz["tree_internal_value"])
        st["tree_shrinkage"] = np.asarray(npz["tree_shrinkage"])
    history = json.loads(str(npz["history_json"].item()))
    return CheckpointData(manifest, str(npz["model_text"].item()), st,
                          history, path=path)


def restore_checkpoint(booster, data) -> None:
    """Restore a CheckpointData (or a path to one) into a live booster
    whose train/valid Datasets are already attached. Models are replaced
    wholesale (each tree re-binned over this training set's mappers when
    it is first walked), scores come back bit-exact from the stored
    arrays, and RNG state resumes mid-stream."""
    _refuse_data_parallel(_gbdt_of(booster))
    if isinstance(data, str):
        data = find_checkpoint(data)
    gbdt = _gbdt_of(booster)
    ph = _params_hash(gbdt)
    if ph and data.meta.get("params_sha256") and \
            ph != data.meta["params_sha256"]:
        log.warning("resuming with different parameters than the "
                    "checkpointed run; results may diverge")
    if data.meta.get("num_class", gbdt.num_class) != gbdt.num_class:
        raise CheckpointError(
            f"checkpoint num_class={data.meta.get('num_class')} does not "
            f"match booster num_class={gbdt.num_class}")
    from ..config import Config
    from ..models.gbdt import GBDT
    tmp = GBDT.load_model_from_string(data.model_text, Config(),
                                      device=gbdt.device)
    gbdt.models = list(tmp.models)
    _exact_tree_fields(gbdt.models, data.state)
    gbdt.invalidate_ensemble_cache()
    gbdt.restore_state(data.state)
    log.info("restored checkpoint %s at iteration %d (%d trees)",
             data.path or "<mem>", data.iteration, len(gbdt.models))


def _exact_tree_fields(models, st) -> None:
    """Put the exact internal values and shrinkages a port checkpoint
    carries back into the trees parsed from its text (none in a JAX
    package checkpoint: the text's values stand)."""
    shrink = st.get("tree_shrinkage")
    if shrink is None or len(shrink) != len(models):
        return
    iv = st["tree_internal_value"]
    pos = 0
    for t, sh in zip(models, shrink):
        m = max(t.num_leaves - 1, 0)
        t.internal_value[:m] = iv[pos:pos + m]
        t.shrinkage = float(sh)
        pos += m


def find_checkpoint(path: str) -> CheckpointData:
    """Load a checkpoint from a file path, or the newest valid one from
    a checkpoint directory."""
    if os.path.isdir(path):
        data = CheckpointManager(path).latest()
        if data is None:
            raise CheckpointError(f"no usable checkpoint in {path}")
        return data
    return load_checkpoint(path)


# -- rotation -----------------------------------------------------------

class CheckpointManager:
    """Names, rotates, and scans checkpoints in one directory."""

    def __init__(self, directory: str, keep_last: int = 3,
                 prefix: str = "ckpt"):
        self.directory = str(directory)
        self.keep_last = max(1, int(keep_last))
        self.prefix = prefix

    def path_for(self, iteration: int) -> str:
        return os.path.join(self.directory,
                            f"{self.prefix}_iter_{int(iteration):07d}.ckpt")

    def checkpoints(self) -> List[Tuple[int, str]]:
        """[(iteration, path)] ascending; unparseable names ignored."""
        out = []
        if not os.path.isdir(self.directory):
            return out
        for name in os.listdir(self.directory):
            if not name.startswith(self.prefix):
                continue
            m = _CKPT_RE.search(name)
            if m:
                out.append((int(m.group(1)),
                            os.path.join(self.directory, name)))
        out.sort()
        return out

    def save(self, booster, history: Optional[list] = None,
             extra_meta: Optional[Dict[str, Any]] = None) -> str:
        return self.save_captured(*capture(booster, history,
                                           extra_meta=extra_meta))

    def save_captured(self, meta: Dict[str, Any],
                      arrays: Dict[str, np.ndarray]) -> str:
        """Write an already-captured state."""
        path = self.path_for(meta["iteration"])
        write_checkpoint_file(path, meta, arrays)
        self._rotate()
        return path

    def _rotate(self) -> None:
        ckpts = self.checkpoints()
        for _, path in ckpts[:max(0, len(ckpts) - self.keep_last)]:
            try:
                os.unlink(path)
            except OSError:   # pragma: no cover - already gone
                pass

    def latest(self) -> Optional[CheckpointData]:
        """Newest checkpoint that passes validation; corrupt/truncated
        files are skipped with a warning (a kill mid-rotation must not
        strand the run)."""
        for _, path in reversed(self.checkpoints()):
            try:
                return load_checkpoint(path)
            except CheckpointError as exc:
                log.warning("skipping unusable checkpoint: %s", exc)
        return None
