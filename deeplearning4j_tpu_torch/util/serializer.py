"""Model persistence (counterpart of
``deeplearning4j_tpu/util/serializer.py``), in the same archive format,
so each package restores the other's files.

A checkpoint is a zip holding ``configuration.json`` (the configuration's
JSON, :meth:`MultiLayerConfiguration.to_json`), ``params.npz``,
``state.npz`` (the layers' state, when there is any), ``updater.npz``,
``extra.npz`` (runtime state outside the model, when given),
``normalizer.json`` (when given) and ``meta.json``: ``step``, ``epoch``,
``model_type``, ``format_version`` (2), ``rng`` (the key chain as two
uint32 words, what ``np.asarray(key).tolist()`` gives in JAX) and the
loop's ``cursor`` (when given). The npz entries are the flattened trees,
keyed as JAX's ``tree_flatten_with_path`` spells them (``layer_0/W``,
``layer_0/m/W``: dict keys in sorted order joined by ``/``), with the
trees' dtypes; a bf16 leaf is the raw 2-byte void (``|V2``) member
``np.savez`` writes for a JAX bf16 array, and reads back as bf16. A restored network resumes exactly: the same params,
updater state, layer state, step counter and key chain.

Writing is split into :func:`snapshot_training_state` (the copy of the
device tensors to the host, the only part that must pause training) and
:meth:`ModelSerializer.write_snapshot` (host I/O only). Format version 3
is a directory of per-worker shard zips under a ``manifest.json``
written last; its content functions (:func:`shard_training_snapshot`,
:func:`write_shard`, :func:`read_shard`, :func:`read_manifest`,
:func:`merge_shard_snapshots`) are plain numpy and the JAX package's.
"""
from __future__ import annotations

import io
import json
import os
import zipfile
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..convert import is_bf16_array, numpy_from_tensor, tensor_from_numpy

#: zip (single-file) checkpoint versions this build reads; shard
#: directories are exactly :data:`SHARDED_FORMAT_VERSION`.
SUPPORTED_FILE_FORMATS = (1, 2)
SHARDED_FORMAT_VERSION = 3
MANIFEST_NAME = "manifest.json"


class CheckpointFormatError(RuntimeError):
    """A checkpoint's recorded format version (or structure) is not one
    this build reads: raised with the path and the found and expected
    versions, before any payload is parsed."""

    def __init__(self, path: str, found, expected):
        self.path = path
        self.found = found
        self.expected = expected
        super().__init__(
            f"unsupported checkpoint format at {path}: found "
            f"format_version={found!r}, this build supports {expected} "
            "(v1/v2 single-file zips, v3 shard directories). A "
            "newer-format checkpoint needs a newer build to resume.")


def _items(tree):
    """(key, child) pairs of a dict (keys sorted, as JAX flattens) or a
    tuple or list (indices)."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    return [(str(i), v) for i, v in enumerate(tree)]


def _is_node(tree) -> bool:
    return isinstance(tree, (dict, tuple, list))


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return numpy_from_tensor(leaf)
    return np.array(leaf, copy=True)


def _flatten_tree(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """``{"a/b/c": array}`` of a tree of dicts, tuples and tensors (a
    host copy of every leaf; empty nodes have no entry)."""
    flat = {}
    for k, v in _items(tree):
        key = f"{prefix}/{k}" if prefix else k
        if _is_node(v):
            flat.update(_flatten_tree(v, key))
        else:
            flat[key] = _host(v)
    return flat


def _unflatten_like(template, flat: Dict[str, np.ndarray], prefix: str = ""):
    """A tree of ``template``'s layout whose leaves come from ``flat``
    (as CPU tensors), each in its template leaf's shape and dtype, but a
    half leaf (bf16, stored as ``|V2``, or fp16) keeps its own dtype: a
    pure-bf16 network's leaves turn f32 one by one as it trains (see
    ``nn/multilayer.py``), so the archive, not a fresh ``init``, says
    which are still half."""
    def leaf(key, t):
        out = tensor_from_numpy(np.asarray(flat[key]))
        if out.dtype not in (torch.bfloat16, torch.float16):
            out = out.to(t.dtype)
        return out.reshape(t.shape)
    if isinstance(template, dict):
        return {k: (_unflatten_like(v, flat, f"{prefix}/{k}" if prefix
                                    else str(k))
                    if _is_node(v) else
                    leaf(f"{prefix}/{k}" if prefix else str(k), v))
                for k, v in template.items()}
    return type(template)(
        _unflatten_like(v, flat, f"{prefix}/{i}" if prefix else str(i))
        if _is_node(v) else leaf(f"{prefix}/{i}" if prefix else str(i), v)
        for i, v in enumerate(template))


def _npy_bytes(a: np.ndarray) -> bytes:
    """One ``.npy`` member as ``np.savez`` writes it. For a bf16 leaf
    (a ``|V2`` array here) that is the header JAX's ``ml_dtypes`` array
    gets, ``'descr': '<V2'``, over the same bits."""
    buf = io.BytesIO()
    np.lib.format.write_array(buf, np.asanyarray(a), allow_pickle=False)
    data = buf.getvalue()
    if is_bf16_array(np.asanyarray(a)):
        data = data.replace(b"'descr': '|V2'", b"'descr': '<V2'", 1)
    return data


def _npz_bytes(arrs: Dict[str, np.ndarray]) -> bytes:
    """What ``np.savez`` writes, byte for byte (stored members, zip64
    headers), with the bf16 members' header as JAX writes it."""
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_STORED,
                         allowZip64=True) as z:
        for k, a in arrs.items():
            with z.open(f"{k}.npy", "w", force_zip64=True) as f:
                f.write(_npy_bytes(a))
    return buf.getvalue()


def snapshot_training_state(model, cursor: Optional[dict] = None,
                            extra: Optional[Dict[str, np.ndarray]] = None,
                            save_updater: bool = True) -> dict:
    """A host copy of the whole resumable training state: the
    configuration's JSON, the flattened params, layer state and updater
    state, ``extra`` and the meta (step, epoch, model type, format
    version, key chain, ``cursor``). The copy from the device is the
    only part that waits for it; the returned dict (numpy and str) can
    be written from any thread."""
    snap = {
        "conf_json": model.conf.to_json(),
        "params": _flatten_tree(model._params),
        "net_state": (_flatten_tree(model._net_state)
                      if model._net_state else None),
        "opt_state": (_flatten_tree(model._opt_state)
                      if save_updater and model._opt_state is not None
                      else None),
        "extra": ({k: np.array(v, copy=True) for k, v in extra.items()}
                  if extra else None),
        "meta": {
            "step": model._step,
            "epoch": model._epoch,
            "model_type": type(model).__name__,
            "format_version": 2,
        },
    }
    rng = getattr(model, "_rng", None)
    if rng is not None:
        # fit() splits the chain once a batch: restoring it replays the
        # same keys the uninterrupted run would have drawn
        snap["meta"]["rng"] = [int(rng[0]), int(rng[1])]
    if cursor is not None:
        snap["meta"]["cursor"] = cursor
    return snap


def shard_name(i: int) -> str:
    return f"shard_{i:05d}.zip"


def shard_training_snapshot(snap: dict, num_workers: int
                            ) -> Tuple[List[dict], dict]:
    """Split a :func:`snapshot_training_state` dict into ``num_workers``
    per-worker shard dicts plus the manifest skeleton (format v3).

    - **Per-worker arrays** (``extra`` entries whose leading axis equals
      the worker count — gradient-sharing residuals, per-worker updater
      moments) are SLICED: shard *w* gets worker *w*'s slab with the
      leading axis dropped. This is the load-bearing part: each worker
      writes only its own state, and re-meshing re-buckets exactly
      these keys.
    - **Model-wide flat entries** (params / updater / net state, plus
      any non-sliced extra) are distributed across shards by sorted key
      round-robin — deterministic, and no shard must hold the whole
      model (the once-models-outgrow-host-RAM requirement).

    ``merge_shard_snapshots`` is the exact inverse; slicing + stacking
    round-trips bitwise, so a same-shape resume stays bit-exact."""
    w = int(num_workers)
    if w < 1:
        raise ValueError(f"num_workers must be >= 1, got {num_workers}")
    shards = [{"params": {}, "net_state": {}, "opt_state": {},
               "extra": {}, "meta": {"shard": i, "num_workers": w,
                                     "format_version":
                                         SHARDED_FORMAT_VERSION}}
              for i in range(w)]
    worker_sliced = []
    extra = snap.get("extra") or {}
    for k in sorted(extra):
        arr = np.asarray(extra[k])
        if arr.ndim >= 1 and arr.shape[0] == w:
            worker_sliced.append(k)
            for i in range(w):
                shards[i]["extra"][k] = np.array(arr[i], copy=True)
    spill = [k for k in sorted(extra) if k not in worker_sliced]
    for section in ("params", "net_state", "opt_state"):
        flat = snap.get(section)
        for j, k in enumerate(sorted(flat or {})):
            shards[j % w][section][k] = flat[k]
    for j, k in enumerate(spill):
        # worker-count-independent extras (adaptive threshold, last
        # sparsity) round-robin like the model-wide sections
        shards[j % w]["extra"][k] = extra[k]
    meta = dict(snap["meta"])
    meta["format_version"] = SHARDED_FORMAT_VERSION
    manifest = {
        "format_version": SHARDED_FORMAT_VERSION,
        "num_workers": w,
        "meta": meta,
        "conf_json": snap["conf_json"],
        "sections_present": {
            "net_state": bool(snap.get("net_state")),
            "opt_state": snap.get("opt_state") is not None,
            "extra": bool(extra),
        },
        "worker_sliced": worker_sliced,
        # file/bytes columns are filled in by the writer as each shard
        # lands — the manifest commits last, after every shard is
        # durable, so its presence IS the not-torn marker
        "shards": [{"file": shard_name(i)} for i in range(w)],
    }
    return shards, manifest


def write_shard(shard: dict, path: str):
    """One shard zip: npz members for each non-empty section + a tiny
    meta.json. Pure host I/O (background-writer safe)."""
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        for section, member in (("params", "params.npz"),
                                ("net_state", "state.npz"),
                                ("opt_state", "updater.npz"),
                                ("extra", "extra.npz")):
            if shard.get(section):
                z.writestr(member, _npz_bytes(shard[section]))
        z.writestr("meta.json", json.dumps(shard["meta"]))


def read_shard(path: str) -> dict:
    with zipfile.ZipFile(path) as z:
        names = z.namelist()
        out = {"meta": json.loads(z.read("meta.json").decode())}
        for section, member in (("params", "params.npz"),
                                ("net_state", "state.npz"),
                                ("opt_state", "updater.npz"),
                                ("extra", "extra.npz")):
            out[section] = (dict(np.load(io.BytesIO(z.read(member))))
                            if member in names else {})
    return out


def read_manifest(directory: str) -> dict:
    """Load + validate a v3 shard directory's manifest. A directory
    without a (complete) manifest is a torn write — the writer commits
    the manifest last — and must never be resumed."""
    mpath = os.path.join(directory, MANIFEST_NAME)
    if not os.path.isfile(mpath):
        raise CheckpointFormatError(
            directory, "<no manifest.json — torn or foreign directory>",
            SUPPORTED_FILE_FORMATS + (SHARDED_FORMAT_VERSION,))
    with open(mpath) as f:
        manifest = json.load(f)
    fv = manifest.get("format_version")
    if fv != SHARDED_FORMAT_VERSION:
        raise CheckpointFormatError(directory, fv,
                                    (SHARDED_FORMAT_VERSION,))
    # stamp the origin so downstream errors (shard-count mismatch in
    # merge_shard_snapshots) can name the offending checkpoint
    manifest["_path"] = directory
    return manifest


def merge_shard_snapshots(manifest: dict, shards: List[dict]) -> dict:
    """Inverse of :func:`shard_training_snapshot`: reassemble the
    v2-shaped snapshot dict. Worker-sliced extras are re-stacked in
    shard order (bitwise identical to what was sliced); everything else
    is a dict union."""
    w = int(manifest["num_workers"])
    if len(shards) != w:
        raise CheckpointFormatError(
            manifest.get("_path", "<sharded checkpoint>"),
            f"{len(shards)} shards for num_workers={w}",
            (SHARDED_FORMAT_VERSION,))
    present = manifest.get("sections_present", {})
    snap = {"conf_json": manifest["conf_json"],
            "meta": dict(manifest["meta"]),
            "params": {}, "net_state": {}, "opt_state": {}, "extra": {}}
    sliced = set(manifest.get("worker_sliced", ()))
    for sh in shards:
        for section in ("params", "net_state", "opt_state"):
            snap[section].update(sh.get(section) or {})
        for k, v in (sh.get("extra") or {}).items():
            if k not in sliced:
                snap["extra"][k] = v
    for k in sliced:
        snap["extra"][k] = np.stack(
            [np.asarray(sh["extra"][k]) for sh in shards])
    if not present.get("net_state", bool(snap["net_state"])):
        snap["net_state"] = None
    if not present.get("opt_state", bool(snap["opt_state"])):
        snap["opt_state"] = None
    if not present.get("extra", bool(snap["extra"])):
        snap["extra"] = None
    return snap


class ModelSerializer:
    """Write and restore networks in the shared archive format."""

    @staticmethod
    def write_model(model, path: str, save_updater: bool = True,
                    normalizer=None):
        ModelSerializer.write_snapshot(
            snapshot_training_state(model, save_updater=save_updater),
            path, normalizer=normalizer)

    @staticmethod
    def write_snapshot(snap: dict, path: str, normalizer=None):
        """Write a :func:`snapshot_training_state` dict (host I/O only,
        safe on a background thread)."""
        with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
            z.writestr("configuration.json", snap["conf_json"])
            z.writestr("params.npz", _npz_bytes(snap["params"]))
            if snap.get("net_state"):
                z.writestr("state.npz", _npz_bytes(snap["net_state"]))
            if snap.get("opt_state") is not None:
                z.writestr("updater.npz", _npz_bytes(snap["opt_state"]))
            if snap.get("extra"):
                z.writestr("extra.npz", _npz_bytes(snap["extra"]))
            if normalizer is not None:
                z.writestr("normalizer.json", json.dumps(normalizer))
            z.writestr("meta.json", json.dumps(snap["meta"]))

    @staticmethod
    def validate_format(path: str) -> int:
        """The recorded format version, checked before any payload is
        read: an unknown one raises :class:`CheckpointFormatError`."""
        if os.path.isdir(path):
            return int(read_manifest(path)["format_version"])
        with zipfile.ZipFile(path) as z:
            meta = json.loads(z.read("meta.json").decode())
        fv = meta.get("format_version", 1)   # pre-v2 files carried none
        if fv not in SUPPORTED_FILE_FORMATS:
            raise CheckpointFormatError(
                path, fv, SUPPORTED_FILE_FORMATS + (SHARDED_FORMAT_VERSION,))
        return int(fv)

    @staticmethod
    def restore(path: str, load_updater: bool = True, device=None):
        """The network a v1/v2 zip or a v3 shard directory holds, on
        ``device`` (the card unless ``"cpu"`` is asked for), by the
        model type recorded at save time."""
        ModelSerializer.validate_format(path)
        if os.path.isdir(path):
            return ModelSerializer.restore_sharded(path, load_updater,
                                                   device)
        with zipfile.ZipFile(path) as z:
            meta = json.loads(z.read("meta.json").decode())
        if meta.get("model_type") == "ComputationGraph":
            return ModelSerializer.restore_computation_graph(
                path, load_updater, device)
        return ModelSerializer.restore_multi_layer_network(
            path, load_updater, device)

    @staticmethod
    def restore_sharded(directory: str, load_updater: bool = True,
                        device=None):
        """A v3 shard directory: every shard read, the v2-shaped snapshot
        reassembled, the network rebuilt from the manifest's
        configuration (per-worker arrays stacked ``[W, ...]`` in
        ``model._resume_extra``)."""
        manifest = read_manifest(directory)
        shards = [read_shard(os.path.join(directory, s["file"]))
                  for s in manifest["shards"]]
        snap = merge_shard_snapshots(manifest, shards)
        model = ModelSerializer._model_from_conf(
            snap["conf_json"], snap["meta"].get("model_type"), device)
        return ModelSerializer._restore_from_snapshot(model, snap,
                                                      load_updater)

    @staticmethod
    def _model_from_conf(conf_json: str, model_type: Optional[str],
                         device=None):
        if model_type == "ComputationGraph":
            from ..nn.graph import (ComputationGraph,
                                    ComputationGraphConfiguration)
            return ComputationGraph(
                ComputationGraphConfiguration.from_json(conf_json),
                device=device).init()
        from ..nn.conf import MultiLayerConfiguration
        from ..nn.multilayer import MultiLayerNetwork
        return MultiLayerNetwork(MultiLayerConfiguration.from_json(conf_json),
                                 device=device).init()

    @staticmethod
    def _restore_from_snapshot(model, snap: dict, load_updater: bool):
        """Shared tail of every restore: params, layer state and updater
        state, the counters and the resume state (key chain, loop
        cursor, extra arrays)."""
        model.set_params(_unflatten_like(model._params, snap["params"]))
        if snap.get("net_state") and model._net_state:
            model.set_net_state(_unflatten_like(model._net_state,
                                                snap["net_state"]))
        if load_updater and snap.get("opt_state"):
            model.set_updater_state(_unflatten_like(model._opt_state,
                                                    snap["opt_state"]))
        meta = snap["meta"]
        model._step = meta.get("step", 0)
        model._epoch = meta.get("epoch", 0)
        if meta.get("rng") is not None:
            model._rng = (int(meta["rng"][0]), int(meta["rng"][1]))
        # the loop's cursor and out-of-model state ride on the model for
        # whoever resumes the loop
        model._resume_cursor = meta.get("cursor")
        model._resume_extra = (dict(snap["extra"])
                               if snap.get("extra") else None)
        return model

    @staticmethod
    def _restore_common(model, z: zipfile.ZipFile, load_updater: bool):
        names = z.namelist()

        def npz(member):
            return (dict(np.load(io.BytesIO(z.read(member))))
                    if member in names else None)
        snap = {"params": npz("params.npz"), "net_state": npz("state.npz"),
                "opt_state": npz("updater.npz"), "extra": npz("extra.npz"),
                "meta": json.loads(z.read("meta.json").decode())}
        return ModelSerializer._restore_from_snapshot(model, snap,
                                                      load_updater)

    @staticmethod
    def restore_computation_graph(path: str, load_updater: bool = True,
                                  device=None):
        """The ``ComputationGraph`` a v1/v2 zip holds, on ``device``."""
        with zipfile.ZipFile(path) as z:
            model = ModelSerializer._model_from_conf(
                z.read("configuration.json").decode(), "ComputationGraph",
                device)
            return ModelSerializer._restore_common(model, z, load_updater)

    @staticmethod
    def restore_multi_layer_network(path: str, load_updater: bool = True,
                                    device=None):
        from ..nn.conf import MultiLayerConfiguration
        from ..nn.multilayer import MultiLayerNetwork
        with zipfile.ZipFile(path) as z:
            conf = MultiLayerConfiguration.from_json(
                z.read("configuration.json").decode())
            model = MultiLayerNetwork(conf, device=device).init()
            return ModelSerializer._restore_common(model, z, load_updater)

    @staticmethod
    def restore_normalizer(path: str) -> Optional[dict]:
        with zipfile.ZipFile(path) as z:
            if "normalizer.json" in z.namelist():
                return json.loads(z.read("normalizer.json").decode())
        return None
