"""Map checkpointing: save/load the full world map to a single file.

Port of ppg_slam_tpu/worldmap/serialize.py. The reference has no
persistence (SURVEY.md §5); the rebuild adds it: loop-closing tests load a
prebuilt map instead of re-tracking a sequence, and long runs can
checkpoint/resume.

Format: the reference package's magic + version header, then a pickle of
the Map object graph (KeyFrame <-> MapPoint cycles are handled natively).
The BoW vocabulary is NOT stored: the loader reattaches the caller's. The
pickle holds host data only (keyframes keep host descriptors; saving a map
that reaches a tensor raises TypeError), and a torch.device (the device a
keyframe's preintegration runs on) is stored as a placeholder that the
loader replaces with its own `device`, so that a map saved on the card
loads on the CPU.

Loading goes through a restricted unpickler that accepts only classes of
ppg_slam_tpu_torch, numpy's array machinery and plain builtins: a map file
written by the JAX package (the same header, its own classes) is refused
with ValueError, without importing anything of it. Element id counters are
advanced past the stored maxima so post-load element creation never
collides.
"""

from __future__ import annotations

import io
import itertools
import pickle

import torch

MAGIC = b"PPGTPUMAP"
VERSION = 1

_BUILTINS = frozenset({"set", "frozenset", "dict", "list", "tuple", "bytes",
                       "bytearray", "complex", "slice", "range", "object"})
_NUMPY_FUNCTIONS = frozenset({"_reconstruct", "scalar", "_frombuffer"})


def _saved_device():
    """Stands for a torch.device in a map file (replaced on load)."""
    raise pickle.UnpicklingError("a device placeholder outside load_map")


class _HostPickler(pickle.Pickler):
    def reducer_override(self, obj):
        if isinstance(obj, torch.device):
            return _saved_device, ()
        if isinstance(obj, torch.Tensor):
            raise TypeError("a map file holds host data only; the map "
                            f"reaches a {obj.device.type} tensor")
        return NotImplemented


class _MapUnpickler(pickle.Unpickler):
    def __init__(self, f, device):
        super().__init__(f)
        self._device = device
        self._resolved = None

    def _load_device(self):
        from ..device import resolve_device

        if self._resolved is None:
            self._resolved = resolve_device(self._device)
        return self._resolved

    def find_class(self, module, name):
        root = module.split(".")[0]
        if module == __name__ and name == "_saved_device":
            return self._load_device
        if "." not in name:
            if module == "builtins" and name in _BUILTINS:
                return super().find_class(module, name)
            if root in ("numpy", "ppg_slam_tpu_torch"):
                obj = super().find_class(module, name)
                if isinstance(obj, type) or (root == "numpy"
                                             and name in _NUMPY_FUNCTIONS):
                    return obj
        raise pickle.UnpicklingError(
            f"{module}.{name} is not part of a ppg_slam_tpu_torch map")


def save_map(world_map, path: str) -> None:
    """Serialize the map (without the vocabulary) to `path`."""
    vocab = world_map.vocabulary
    world_map.vocabulary = None
    try:
        buf = io.BytesIO()
        _HostPickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(world_map)
    finally:
        world_map.vocabulary = vocab
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(VERSION.to_bytes(2, "little"))
        f.write(buf.getbuffer())


def load_map(path: str, vocabulary=None, rig=None, device=None):
    """Load a map saved by save_map; reattaches `vocabulary` (and optionally
    overrides the stored rig), puts the map's preintegration on `device`
    (CUDA unless the caller names another) and advances the global element
    id counters."""
    from . import elements, frame as frame_mod

    with open(path, "rb") as f:
        magic = f.read(len(MAGIC))
        if magic != MAGIC:
            raise ValueError(f"{path}: not a ppg_slam_tpu map file")
        version = int.from_bytes(f.read(2), "little")
        if version > VERSION:
            raise ValueError(f"{path}: map version {version} > {VERSION}")
        try:
            world_map = _MapUnpickler(f, device).load()
        except (pickle.UnpicklingError, ImportError) as e:
            raise ValueError(f"{path}: not a ppg_slam_tpu_torch map ({e})") \
                from e
        except Exception as e:  # truncated / corrupted payload
            raise ValueError(f"{path}: corrupted map payload ({e})") from e

    world_map.vocabulary = vocabulary
    if rig is not None:
        world_map.rig = rig
    if vocabulary is not None:
        # Re-index place recognition: maps saved from a vocabulary-less run
        # have no BoW vectors, so compute the missing ones from the stored
        # keyframe descriptors and rebuild the inverted file — a loaded map
        # is then immediately relocalizable (System(load_map_path=...)).
        world_map.inverted_file = {}
        for kf in sorted(world_map.keyframes, key=lambda k: k.mnId):
            if not kf.bow_vec:
                desc = kf.descriptors
                if desc is None or not len(desc):
                    continue
                kf.bow_vec, kf.feat_vec = vocabulary.transform(desc)
            for word in kf.bow_vec:
                world_map.inverted_file.setdefault(word, []).append(kf)

    def bump(counter_name, module, ids):
        nxt = (max(ids) + 1) if ids else 0
        current = next(getattr(module, counter_name))
        setattr(module, counter_name,
                itertools.count(max(nxt, current + 1)))

    bump("_kf_ids", frame_mod, [kf.mnId for kf in world_map.keyframes])
    bump("_frame_ids", frame_mod,
         [kf.frame_id for kf in world_map.keyframes
          if getattr(kf, "frame_id", None) is not None])
    bump("_mp_ids", elements, [mp.mnId for mp in world_map.map_points])
    bump("_me_ids", elements, [me.mnId for me in world_map.map_edges])
    bump("_mc_ids", elements, [mc.mnId for mc in world_map.map_colines])
    return world_map
