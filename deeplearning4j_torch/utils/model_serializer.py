"""Checkpoints: save and restore a network's whole training state.

Port of `deeplearning4j_tpu/utils/model_serializer.py` (reference
util/ModelSerializer.java), the same ZIP format both ways: a checkpoint
the JAX package wrote restores here, and one written here restores there.

Entries: ``configuration.json`` (the configuration's JSON, shared by both
packages), ``metadata.json`` (format version, model class, dtype name
``float32``/``bfloat16``, iteration, epoch), ``coefficients.npz`` (the
parameters), ``state.npz`` (layer state: BatchNormalization's running
mean and variance, float32 in a bfloat16 network too),
``updaterState.npz`` (optimizer state) and ``normalizer.json`` (a
data/normalizers.py normalizer, by its registered name). Each npz holds a tree's leaves as
``leaf00000``, ``leaf00001``, ... in ``jax.tree_util`` order
(utils/params.py `tree_leaves`), in the JAX package's layout (HWIO
kernels), with their type names in a ``__dtypes__`` array; bfloat16 leaves
are stored as their uint16 bits and read back without ``ml_dtypes``.

Deliberate differences from the JAX package:

- ``rngState.npz``, the JAX package's PRNG key, is neither written nor
  read: the port draws dropout masks from a ``torch.Generator``, and a
  restored network keeps the one seeded from its configuration. The JAX
  package restores a zip without the entry.

Writes are atomic: the archive is built in a temporary file beside the
target, fsynced and ``os.replace``d over it, so a crash mid-write (the
``checkpoint.write`` fault point) leaves the previous checkpoint or none,
never a torn one.
"""
from __future__ import annotations

import io
import json
import os
import zipfile
import zlib

import numpy as np
import torch

from . import faults, serde
from . import params as param_utils
from .device import DeviceLike, resolve_device

FORMAT_VERSION = 1


class CheckpointCorruptError(Exception):
    """The archive is unreadable: truncated, missing a required entry,
    failing a CRC, or of an unsupported format_version. Distinct from the
    ValueError that restoring a valid archive into a model it does not fit
    raises."""


CONFIG_ENTRY = "configuration.json"
META_ENTRY = "metadata.json"
PARAMS_ENTRY = "coefficients.npz"
UPDATER_ENTRY = "updaterState.npz"
STATE_ENTRY = "state.npz"
NORMALIZER_ENTRY = "normalizer.json"
RNG_ENTRY = "rngState.npz"  # the JAX package's; the port ignores it

REQUIRED_ENTRIES = (META_ENTRY, CONFIG_ENTRY, PARAMS_ENTRY, STATE_ENTRY)

# read failures of single ZIP members: a CRC mismatch surfaces as
# BadZipFile, deflate damage as zlib.error, short reads as EOFError
_READ_ERRORS = (zipfile.BadZipFile, zlib.error, EOFError, KeyError, OSError)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float64": torch.float64, "float16": torch.float16}


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _tree_to_npz_bytes(tree) -> bytes:
    """npz-encode a port tree: its leaves in `tree_leaves` order, each in
    the reference's layout, bfloat16 as uint16 bits named in __dtypes__. A
    leaf that tensor parallelism holds in blocks (`ShardedLeaf`) is written
    whole, so a placed network checkpoints as the JAX package's does."""
    arrays, names = {}, []
    for i, t in enumerate(param_utils.tree_leaves(tree)):
        if hasattr(t, "full"):   # parallel/mesh.py:ShardedLeaf
            t = t.full("cpu")
        a, name = param_utils.leaf_to_reference_bits(t)
        arrays[f"leaf{i:05d}"] = a
        names.append(name)
    arrays["__dtypes__"] = np.array(names)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _npz_leaves(data: bytes):
    """[(array, dtype name)] of an npz tree, in leaf order."""
    with np.load(io.BytesIO(data)) as z:
        keys = sorted(k for k in z.files if k != "__dtypes__")
        names = ([str(s) for s in z["__dtypes__"]] if "__dtypes__" in z.files
                 else [None] * len(keys))
        return [(z[k], name or z[k].dtype.name) for k, name in zip(keys, names)]


def _npz_bytes_to_tree(data: bytes, template, device: torch.device):
    """The stored leaves on `template`'s structure, each checked against
    the template leaf's shape and cast to its type."""
    leaves = param_utils.tree_leaves(template)
    stored = _npz_leaves(data)
    if len(stored) != len(leaves):
        raise ValueError(
            f"Checkpoint has {len(stored)} arrays but the model expects "
            f"{len(leaves)}: config/architecture mismatch")
    out = []
    for t, (a, name) in zip(leaves, stored):
        got = param_utils.leaf_from_reference_bits(a, name, device)
        if tuple(got.shape) != tuple(t.shape):
            raise ValueError(f"Checkpoint array shape {tuple(got.shape)} != "
                             f"model shape {tuple(t.shape)}")
        out.append(got.to(t.dtype))
    return param_utils.tree_unflatten(template, out)


def _model_class(model) -> str:
    from ..nn.graph.graph import ComputationGraph
    from ..nn.multilayer import MultiLayerNetwork
    if isinstance(model, MultiLayerNetwork):
        return "MultiLayerNetwork"
    if isinstance(model, ComputationGraph):
        return "ComputationGraph"
    raise ValueError(f"Cannot serialize {type(model).__name__}")


def _fsync_dir(path: str) -> None:
    """fsync the directory so the rename itself survives power loss."""
    try:
        dfd = os.open(os.path.dirname(os.path.abspath(path)), os.O_RDONLY)
    except OSError:
        return  # e.g. a directory that cannot be opened for fsync
    try:
        os.fsync(dfd)
    except OSError:
        pass
    finally:
        os.close(dfd)


def save_model(model, path, save_updater: bool = True, normalizer=None) -> None:
    """Write a checkpoint ZIP (reference ModelSerializer.writeModel)
    atomically: built in a temporary file beside `path`, fsynced, then
    renamed over it."""
    model_class = _model_class(model)
    model._check_init()
    meta = {
        "format_version": FORMAT_VERSION,
        "model_class": model_class,
        "dtype": _dtype_name(model._dtype),
        "iteration": int(model.iteration),
        "epoch": int(model.epoch),
        "has_updater": bool(save_updater),
    }
    path = os.fspath(path)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            with zipfile.ZipFile(f, "w", zipfile.ZIP_DEFLATED) as zf:
                zf.writestr(CONFIG_ENTRY, model.conf.to_json())
                zf.writestr(META_ENTRY, json.dumps(meta))
                zf.writestr(PARAMS_ENTRY, _tree_to_npz_bytes(model.params_tree))
                # the bulk is on disk, the central directory is not: a kill
                # here leaves a torn temporary file, never a torn `path`
                faults.fire("checkpoint.write")
                zf.writestr(STATE_ENTRY, _tree_to_npz_bytes(model.state_tree))
                if save_updater:
                    zf.writestr(UPDATER_ENTRY, _tree_to_npz_bytes(model.opt_state))
                if normalizer is not None:
                    zf.writestr(NORMALIZER_ENTRY, serde.to_json(normalizer))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_dir(path)
    finally:
        try:
            os.unlink(tmp)
        except FileNotFoundError:
            pass


def validate_checkpoint(path, deep: bool = False) -> dict:
    """Check the archive's structure and return its metadata. Raises
    CheckpointCorruptError naming what is unreadable; ``deep=True`` also
    checks every member's CRC (reads the whole archive)."""
    try:
        with zipfile.ZipFile(path, "r") as zf:
            names = set(zf.namelist())
            for entry in REQUIRED_ENTRIES:
                if entry not in names:
                    raise CheckpointCorruptError(
                        f"checkpoint {path!r}: missing required entry "
                        f"{entry!r} (truncated or not a model checkpoint)")
            if deep:
                bad = zf.testzip()
                if bad is not None:
                    raise CheckpointCorruptError(
                        f"checkpoint {path!r}: entry {bad!r} fails its CRC "
                        "(truncated or corrupt archive)")
            try:
                meta = json.loads(zf.read(META_ENTRY))
            except (ValueError, *_READ_ERRORS) as e:
                raise CheckpointCorruptError(
                    f"checkpoint {path!r}: entry {META_ENTRY!r} is "
                    f"unreadable ({e})") from e
    except zipfile.BadZipFile as e:
        raise CheckpointCorruptError(
            f"checkpoint {path!r}: not a readable ZIP archive ({e})") from e
    fv = meta.get("format_version")
    if not isinstance(fv, int) or not (1 <= fv <= FORMAT_VERSION):
        raise CheckpointCorruptError(
            f"checkpoint {path!r}: unsupported format_version {fv!r} in "
            f"{META_ENTRY!r} (this build reads versions 1..{FORMAT_VERSION})")
    if meta.get("model_class") not in ("MultiLayerNetwork", "ComputationGraph"):
        raise CheckpointCorruptError(
            f"checkpoint {path!r}: unknown model_class "
            f"{meta.get('model_class')!r} in {META_ENTRY!r}")
    if meta.get("dtype") not in _DTYPES:
        raise CheckpointCorruptError(
            f"checkpoint {path!r}: unknown dtype {meta.get('dtype')!r} in "
            f"{META_ENTRY!r}")
    return meta


def _read_entry(zf: zipfile.ZipFile, path, entry: str) -> bytes:
    try:
        return zf.read(entry)
    except _READ_ERRORS as e:
        raise CheckpointCorruptError(
            f"checkpoint {path!r}: entry {entry!r} is unreadable "
            f"({type(e).__name__}: {e})") from e


def restore_model(path, load_updater: bool = True, device: DeviceLike = None):
    """Rebuild the network a checkpoint holds (the model class sniffed from
    its metadata, as ModelGuesser does) on `device`: CUDA unless the caller
    asks for the CPU. Raises CheckpointCorruptError for an unreadable
    archive and ValueError for arrays that do not fit the configuration."""
    from ..nn.conf.builders import MultiLayerConfiguration
    from ..nn.conf.graph_conf import ComputationGraphConfiguration
    from ..nn.graph.graph import ComputationGraph
    from ..nn.multilayer import MultiLayerNetwork

    dev = resolve_device(device)
    meta = validate_checkpoint(path)
    dtype = _DTYPES[meta["dtype"]]
    with zipfile.ZipFile(path, "r") as zf:
        conf_json = _read_entry(zf, path, CONFIG_ENTRY).decode("utf-8")
        if meta["model_class"] == "MultiLayerNetwork":
            model = MultiLayerNetwork(MultiLayerConfiguration.from_json(conf_json))
        else:
            model = ComputationGraph(
                ComputationGraphConfiguration.from_json(conf_json))
        # each leaf's shape and type from the configuration, on the meta
        # device: nothing is drawn or allocated before the stored leaves
        with torch.device("meta"):
            params = model._draw_params(torch.Generator(), dtype)
            opt = model._opt_init(params)
            state = model._state_init(dtype)
        params, opt, state = _read_trees(zf, path, meta, params, opt, state,
                                         load_updater, dev)
    model._adopt(params, dtype, dev, opt_state=opt, state_tree=state)
    _read_counters(model, meta)
    return model


def _read_trees(zf: zipfile.ZipFile, path, meta: dict, params, opt_state,
                state, load_updater: bool, device: torch.device):
    """(parameters, updater state or None where it is not loaded, layer
    state) from an open checkpoint onto `device`, on the templates'
    structure and types (layer state stays float32 in a bfloat16 network)."""
    params = _npz_bytes_to_tree(_read_entry(zf, path, PARAMS_ENTRY), params,
                                device)
    state = _npz_bytes_to_tree(_read_entry(zf, path, STATE_ENTRY), state, device)
    if load_updater and meta.get("has_updater") and UPDATER_ENTRY in zf.namelist():
        return params, _npz_bytes_to_tree(_read_entry(zf, path, UPDATER_ENTRY),
                                          opt_state, device), state
    return params, None, state


def _read_counters(model, meta: dict) -> None:
    model.iteration = int(meta.get("iteration", 0))
    model.epoch = int(meta.get("epoch", 0))


def load_checkpoint_state(model, path, load_updater: bool = True,
                          device: DeviceLike = None) -> dict:
    """Load a checkpoint's training state into an existing initialized
    model of the same architecture (no rebuild; listeners stay). With
    `device` the model moves there first; by default it stays on its own
    device, which its init put on CUDA unless asked for the CPU. Returns
    the metadata. Raises CheckpointCorruptError / ValueError as
    restore_model does."""
    model._check_init()
    if device is not None:
        dev = resolve_device(device)
        move = lambda tree: param_utils.tree_map(
            lambda t: param_utils.place(t, dev), tree)
        model.params_tree, model.opt_state, model.state_tree = \
            move(model.params_tree), move(model.opt_state), move(model.state_tree)
        if dev != model.device:
            model._dropout_gen = torch.Generator(device=dev).manual_seed(
                model.conf.seed)
        model.device = dev
    meta = validate_checkpoint(path)
    with zipfile.ZipFile(path, "r") as zf:
        params, opt, state = _read_trees(zf, path, meta, model.params_tree,
                                         model.opt_state, model.state_tree,
                                         load_updater, model.device)
    model.params_tree, model.state_tree = params, state
    if opt is not None:
        model.opt_state = opt
    model.rnn_clear_previous_state()   # a carry of the run before the restore
    _read_counters(model, meta)
    return meta


def restore_normalizer(path):
    """The normalizer stored beside the model (a data/normalizers.py class
    by its registered name, the JAX package's names), or None."""
    from ..data import normalizers  # noqa: F401  (registers the classes)
    with zipfile.ZipFile(path, "r") as zf:
        if NORMALIZER_ENTRY not in zf.namelist():
            return None
        return serde.from_json(_read_entry(zf, path, NORMALIZER_ENTRY).decode("utf-8"))


class ModelSerializer:
    """Reference-named facade (util/ModelSerializer.java) over the
    module's functions."""

    writeModel = write_model = staticmethod(save_model)
    restoreModel = staticmethod(restore_model)

    @staticmethod
    def restore_multi_layer_network(path, load_updater: bool = True,
                                    device: DeviceLike = None):
        from ..nn.multilayer import MultiLayerNetwork
        model = restore_model(path, load_updater, device)
        if not isinstance(model, MultiLayerNetwork):
            raise ValueError(f"{path} holds a {type(model).__name__}, not a "
                             "MultiLayerNetwork")
        return model

    @staticmethod
    def restore_computation_graph(path, load_updater: bool = True,
                                  device: DeviceLike = None):
        from ..nn.graph.graph import ComputationGraph
        model = restore_model(path, load_updater, device)
        if not isinstance(model, ComputationGraph):
            raise ValueError(f"{path} holds a {type(model).__name__}, not a "
                             "ComputationGraph")
        return model

    restoreMultiLayerNetwork = restore_multi_layer_network
    restoreComputationGraph = restore_computation_graph
