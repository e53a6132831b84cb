"""Pytree checkpoints in the JAX package's format: a flat-path npz and a
json manifest (numpy, torch and the standard library only).

The files are the reference's (``repro/checkpoint/io.py``), so a
checkpoint written by either package loads in the other:

- ``params-{step}.npz`` holds one array per leaf, under the key jax's
  ``tree_flatten_with_path`` gives it, joined by ``/``
  (``['global']/['convs']/[0]/['w']``; ``models.module.key_path``);
- ``manifest.json`` names the archive and is the single publish point;
- an FL checkpoint adds the host rng's ``bit_generator.state`` (PCG64;
  json carries its big ints) and, for an incremental client-state store
  (fl/statestore.py), its shard layout and shard files.

Trees here are in the reference's layout (conv weights HWIO): the FL
runtime converts its flat state on the way in and out
(``convert.flat_to_reference``). Leaves may be numpy arrays or torch
tensors. A bfloat16 tensor is refused: numpy has no bfloat16 of its own,
and the FL state holds none (fp32 params and method state, fedadam's
fp32 step count, int and float64 host arrays).
"""
from __future__ import annotations

import json
import os
import zipfile

import numpy as np
import torch

from repro_torch.models.module import tree_leaves_with_path, tree_map_with_path


def _array(key: str, leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise ValueError(
                f"checkpoint leaf {key} is bfloat16, which numpy holds "
                "only through ml_dtypes: cast it to float32 before saving "
                "(the FL state has no bfloat16 leaf)")
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree) -> dict:
    return {key: _array(key, leaf)
            for key, leaf in tree_leaves_with_path(tree)}


# bytes of a strided array copied at a time into a file (a block of rows)
BLOCK_BYTES = 1 << 26


def write_array_atomic(path: str, arr) -> None:
    """Write one ``.npy`` file atomically (tmp + ``os.replace``): the
    publish discipline of ``save_checkpoint``'s params archive, shared
    with the out-of-core client-state shards (fl/statestore.py). A reader
    never sees a half-written array. A strided array (a transposed view,
    a broadcast row) is copied into the file in C-ordered blocks of rows:
    numpy's own writer walks such an array element by element, 10x
    slower, and a whole copy would cost the array's size in memory."""
    arr = np.asarray(arr)
    tmp = path + ".tmp.npy"            # .npy suffix: np.save appends one
    if arr.ndim == 0 or arr.flags.c_contiguous:
        np.save(tmp, arr)
    else:
        out = np.lib.format.open_memmap(tmp, mode="w+", dtype=arr.dtype,
                                        shape=arr.shape)
        step = max(1, BLOCK_BYTES // max(1, arr[0].nbytes))
        for i in range(0, len(arr), step):
            out[i:i + step] = arr[i:i + step]
        out.flush()
        del out
    os.replace(tmp, path)


def _savez(path: str, arrays: dict) -> None:
    """``np.savez``'s archive (an uncompressed zip of ``<key>.npy``
    members), one member at a time from a C-ordered copy of its array:
    one leaf's copy at most, and numpy's writer never walks a strided
    array."""
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, arr in arrays.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                if not arr.flags.c_contiguous:
                    arr = arr.copy(order="C")
                np.lib.format.write_array(f, arr, allow_pickle=False)


def _params_file(path: str) -> str:
    """The params archive the manifest names (older checkpoints predate
    the field and always used params.npz)."""
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f).get("params_file", "params.npz")


def save_checkpoint(path: str, params, *, step: int = 0, extra: dict = None):
    """Atomic save with the manifest replace as the single publish point:
    params land in a step-versioned archive first, then the manifest
    naming that archive is ``os.replace``'d. A crash at any point leaves
    the previous manifest naming the previous (intact) archive, never a
    manifest paired with mismatched params. Superseded archives are
    pruned after publish, best effort."""
    os.makedirs(path, exist_ok=True)
    arrays = _flatten(params)
    params_file = f"params-{step}.npz"
    tmp_npz = os.path.join(path, f"params-{step}.tmp.npz")
    _savez(tmp_npz, arrays)
    os.replace(tmp_npz, os.path.join(path, params_file))
    manifest = {
        "step": step,
        "params_file": params_file,
        "keys": sorted(arrays.keys()),
        "shapes": {k: list(v.shape) for k, v in arrays.items()},
        "dtypes": {k: str(v.dtype) for k, v in arrays.items()},
        "extra": extra or {},
    }
    mpath = os.path.join(path, "manifest.json")
    with open(mpath + ".tmp", "w") as f:
        json.dump(manifest, f, indent=1)
    os.replace(mpath + ".tmp", mpath)
    for name in os.listdir(path):             # prune superseded archives
        # only our own params archives (step-versioned, legacy, or tmp):
        # the directory may hold unrelated .npz files
        ours = (name == "params.npz"
                or (name.startswith("params-") and name.endswith(".npz")))
        if ours and name != params_file:
            try:
                os.remove(os.path.join(path, name))
            except OSError:
                pass


def load_checkpoint(path: str, like_params):
    """Restore into the structure of ``like_params`` (shape checked,
    cast to each like leaf's dtype). A torch leaf of ``like_params``
    comes back as a tensor on its device; any other as numpy."""
    with np.load(os.path.join(path, _params_file(path))) as data:
        arrays = {k: data[k] for k in data.files}

    def one(key, leaf):
        if key not in arrays:
            raise KeyError(f"checkpoint missing {key}")
        a = arrays[key]
        is_torch = isinstance(leaf, torch.Tensor)
        shape = tuple(leaf.shape) if is_torch else np.shape(leaf)
        if tuple(a.shape) != shape:
            raise ValueError(f"{key}: shape {a.shape} != {shape}")
        if is_torch:
            return torch.from_numpy(a).to(device=leaf.device,
                                          dtype=leaf.dtype)
        return np.asarray(a, dtype=np.asarray(leaf).dtype)
    return tree_map_with_path(one, like_params)


def checkpoint_step(path: str) -> int:
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)["step"]


def checkpoint_exists(path: str) -> bool:
    if not os.path.isfile(os.path.join(path, "manifest.json")):
        return False
    try:
        return os.path.isfile(os.path.join(path, _params_file(path)))
    except (OSError, ValueError):
        return False


def save_fl_checkpoint(path: str, *, round_idx: int, global_params,
                       server_state, client_state, rng) -> None:
    """One federated run's resumable state after ``round_idx`` completed
    rounds: global params, the method's server tree, the population's
    client state and the host rng state (batch packing and client
    sampling draw from it: restoring it makes a resumed run equal the
    uninterrupted one).

    ``client_state`` is either a stacked tree (saved whole inside the
    params archive) or an incremental ``ClientStateStore``
    (``store.incremental``): then only the shards dirtied since the last
    save are flushed into ``<path>/clients/`` as step-versioned files,
    and the manifest records the full shard -> file map (clean shards
    keep the file the previous manifest published). Write order keeps
    the crash guarantee: fresh shard files first, the manifest replace
    as the single publish point, superseded shard files pruned last."""
    extra = {"rng_state": rng.bit_generator.state}
    if getattr(client_state, "incremental", False):
        store = client_state
        clients_dir = os.path.join(path, "clients")
        files = store.checkpoint_shards(clients_dir, round_idx)
        extra["client_store"] = {"layout": store.layout(), "files": files}
        save_checkpoint(path, {"global": global_params,
                               "server": server_state},
                        step=round_idx, extra=extra)
        store.prune_checkpoint_files(clients_dir)
        return
    tree = getattr(client_state, "tree", client_state)
    save_checkpoint(path, {"global": global_params, "server": server_state,
                           "clients": tree},
                    step=round_idx, extra=extra)


def load_fl_checkpoint(path: str, *, like_global, like_server,
                       like_clients=None, store=None):
    """Restore a run saved by ``save_fl_checkpoint``.

    Returns (round_idx, global_params, server_state, client_state,
    rng_state). For the whole-stack format client_state comes back in
    the ``like_clients`` structure (numpy for numpy like leaves, fresh
    and writable). For an incremental checkpoint the shards are restored
    INTO ``store`` (which must match the saved layout) and client_state
    is None: the store already holds the rows."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if "client_store" in manifest.get("extra", {}):
        if store is None or not getattr(store, "incremental", False):
            raise ValueError(
                f"checkpoint at {path} holds an incremental client-state "
                "store; pass the run's MmapShardStore (store=) to "
                "restore it — an in-memory run cannot resume it")
        tree = load_checkpoint(path, {"global": like_global,
                                      "server": like_server})
        store.restore_shards(os.path.join(path, "clients"),
                             manifest["extra"]["client_store"])
        return (manifest["step"], tree["global"], tree["server"], None,
                manifest["extra"]["rng_state"])
    tree = load_checkpoint(path, {"global": like_global,
                                  "server": like_server,
                                  "clients": like_clients})
    return (manifest["step"], tree["global"], tree["server"],
            tree["clients"], manifest["extra"]["rng_state"])
