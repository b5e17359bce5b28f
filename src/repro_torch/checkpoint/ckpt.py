"""Tree checkpoints: a flat-path ``.npz`` payload beside a ``.meta.json``
manifest (the counterpart of ``repro/checkpoint/ckpt.py``).

Leaves are torch tensors (any device) and Python ints (the optimizer's
step), keyed by their ``/``-joined tree path (``params/layers/0/ffn/w_in``,
``opt/step``).  ``restore`` rebuilds into a template tree: tensors come
back on the template leaf's device.  Both files are written atomically
(temp + rename), and the meta carries a per-leaf sha256 over dtype, shape
and bytes: ``restore`` checks it, ``verify`` answers without raising, so
the rollback can pick the newest checkpoint that is still intact.

numpy has no bfloat16: a bf16 leaf is stored as its ``int16`` bits and the
torch dtype of every leaf rides in the payload itself (the ``__dtypes__``
entry), so a bf16 leaf round-trips bit for bit and a dtype drift is still
refused by name.  On an EP world each process writes its own payload
(:func:`rank_path` at its process rank): its expert shard, its model
slices under a tensor-parallel axis, and the replicated leaves.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile

import numpy as np
import torch

_DTYPES_KEY = "__dtypes__"
_INT = "int"                     # a Python int leaf (stored as int64)


def _items(tree, prefix=()):
    """(key, leaf) pairs of a nested dict/list tree, dict keys in
    insertion order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _items(v, prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _unflatten(like, leaves: list):
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)
    return build(like)


def _dtype_name(leaf) -> str:
    if isinstance(leaf, bool) or not isinstance(leaf, (int, torch.Tensor)):
        raise TypeError(f"checkpoint leaves are tensors or ints, got "
                        f"{type(leaf).__name__}")
    if isinstance(leaf, int):
        return _INT
    return str(leaf.dtype).removeprefix("torch.")


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int64)
    t = leaf.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _from_numpy(arr: np.ndarray, dtype: str, like):
    if dtype == _INT:
        return int(arr)
    t = torch.from_numpy(np.array(arr))
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.to(like.device)


def _leaf_sha256(arr: np.ndarray, dtype: str) -> str:
    """Hash of the dtype name, the shape and the bytes, so a silent dtype
    rewrite or reshape cannot pass the manifest."""
    h = hashlib.sha256()
    h.update(dtype.encode())
    h.update(str(tuple(arr.shape)).encode())
    h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def _write_atomic(path: str, write) -> None:
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            write(f)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def rank_path(path: str, rank: int, size: int) -> str:
    """This rank's payload path: ``path`` on one rank, else
    ``<base>.rank<r><ext>``."""
    if size <= 1:
        return path
    base, ext = os.path.splitext(path)
    return f"{base}.rank{rank}{ext}"


def save(path: str, tree, step: int | None = None) -> None:
    flat, dtypes = {}, {}
    for key, leaf in _items(tree):
        dtypes[key] = _dtype_name(leaf)
        flat[key] = _to_numpy(leaf)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = dict(flat, **{_DTYPES_KEY: np.asarray(json.dumps(dtypes))})
    _write_atomic(path, lambda f: np.savez(f, **payload))
    meta = {"step": step, "num_leaves": len(flat),
            "manifest": {k: _leaf_sha256(v, dtypes[k])
                         for k, v in flat.items()}}
    _write_atomic(path + ".meta.json",
                  lambda f: f.write(json.dumps(meta).encode()))


def _load_meta(path: str) -> dict | None:
    meta = path + ".meta.json"
    if not os.path.exists(meta):
        return None
    with open(meta) as f:
        return json.load(f)


def _header(data, key: str) -> tuple:
    """(shape, numpy dtype) of one payload entry, read from its ``.npy``
    header without loading the array."""
    with data.zip.open(key + ".npy") as f:
        read = {(1, 0): np.lib.format.read_array_header_1_0,
                (2, 0): np.lib.format.read_array_header_2_0}[
                    np.lib.format.read_magic(f)]
        shape, _, dtype = read(f)
    return tuple(shape), dtype


def _checked(path: str, template, check_hashes: bool):
    """Every (template leaf, stored array, dtype name) pair, after the key
    sets, shapes and dtypes of the whole tree were checked; each array's
    hash is checked as it is read.  Every mismatch is a ``ValueError``
    naming the key."""
    with np.load(path) as data:
        dtypes = json.loads(str(data[_DTYPES_KEY]))
        leaves = list(_items(template))
        keys = [k for k, _ in leaves]
        saved = set(data.files) - {_DTYPES_KEY}
        missing = sorted(set(keys) - saved)
        extra = sorted(saved - set(keys))
        if missing:
            raise ValueError(
                f"checkpoint {path}: missing key {missing[0]!r}"
                + (f" (+{len(missing) - 1} more)" if len(missing) > 1
                   else ""))
        if extra:
            raise ValueError(
                f"checkpoint {path}: extra key {extra[0]!r} not in template"
                + (f" (+{len(extra) - 1} more)" if len(extra) > 1 else ""))
        for key, leaf in leaves:
            want = () if isinstance(leaf, int) else tuple(leaf.shape)
            shape, _ = _header(data, key)
            if shape != want:
                raise ValueError(f"checkpoint {path}: key {key!r} has shape "
                                 f"{shape}, template wants {want}")
            if dtypes[key] != _dtype_name(leaf):
                raise ValueError(f"checkpoint {path}: key {key!r} has dtype "
                                 f"{dtypes[key]}, template wants "
                                 f"{_dtype_name(leaf)} (refusing to cast)")
        meta = _load_meta(path) if check_hashes else None
        manifest = (meta or {}).get("manifest")
        for key, leaf in leaves:
            arr = data[key]
            if manifest is not None and (
                    manifest.get(key) != _leaf_sha256(arr, dtypes[key])):
                raise ValueError(f"checkpoint {path}: key {key!r} fails "
                                 f"sha256 manifest verification (corrupt "
                                 f"or stale payload)")
            yield leaf, arr, dtypes[key]


def restore(path: str, template, *, check_hashes: bool = True):
    """A new tree in the structure of ``template``, each tensor on its
    template leaf's device.

    Fails loudly: every mismatch is a ``ValueError`` naming the key
    (missing or extra keys, shape, dtype with no silent cast, and, when the
    manifest exists, the per-leaf sha256).  A payload without its meta
    restores without hash checks."""
    return _unflatten(template, [_from_numpy(arr, dtype, leaf)
                                 for leaf, arr, dtype
                                 in _checked(path, template, check_hashes)])


@torch.no_grad()
def restore_into(path: str, live, *, check_hashes: bool = True):
    """:func:`restore` into the tensors of ``live`` (``copy_``, so a
    parameter stays the same leaf tensor with its ``requires_grad``).
    Returns ``live`` with its int leaves replaced.  Key sets, shapes and
    dtypes are checked before any copy; a leaf's hash as it is read, so
    call :func:`verify` first where a corrupt payload must leave ``live``
    untouched."""
    out = []
    for leaf, arr, dtype in _checked(path, live, check_hashes):
        if dtype == _INT:
            out.append(int(arr))
        else:
            leaf.copy_(_from_numpy(arr, dtype, leaf))
            out.append(leaf)
    return _unflatten(live, out)


def verify(path: str) -> bool:
    """True when the payload at ``path`` matches its sha256 manifest.
    Never raises: an unreadable payload, a missing meta, a key-set mismatch
    or a hash mismatch is ``False``."""
    try:
        meta = _load_meta(path)
        if meta is None or "manifest" not in meta:
            return False
        manifest = meta["manifest"]
        with np.load(path) as data:
            dtypes = json.loads(str(data[_DTYPES_KEY]))
            if set(data.files) - {_DTYPES_KEY} != set(manifest):
                return False
            return all(_leaf_sha256(data[k], dtypes[k]) == manifest[k]
                       for k in manifest)
    except Exception:  # noqa: BLE001 - the contract: any failure is False
        return False


def latest_step(path: str):
    meta = _load_meta(path)
    return None if meta is None else meta.get("step")
