"""Track file IO in the reference's formats.

tracks.txt: one line per track, semicolon-separated
``count;viewID;localID;globalID;x;y;r;g;b;...`` (reference:
src/matching/matching_io.cpp:16-95). Pairwise export: per view pair a
``{aaa}_{bbb}.txt`` with ``x1 y1 x2 y2`` lines for interop with other SfM
tools (matching_io.cpp:97-141).
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

from orthosfm_torch import kernel_build
from orthosfm_torch.data import tracks as tracks_mod

#: the native reader, a copy of the JAX package's orthosfm_tpu/native/trackio.cpp
SOURCE = kernel_build.CSRC / "trackio.cpp"
_I64P = ctypes.POINTER(ctypes.c_int64)


def save_tracks(tracks: tracks_mod.TrackSet, path: str) -> None:
    feature_lists = tracks_mod.to_feature_lists(tracks)
    with open(path, "w") as f:
        for feats in feature_lists:
            parts = [str(len(feats))]
            for (vid, lid, gid, x, y, r, g, b) in feats:
                parts += [str(vid), str(lid), str(gid),
                          _fmt(x), _fmt(y), str(r), str(g), str(b)]
            f.write(";".join(parts) + "\n")


def _fmt(v: float) -> str:
    # C++ streams print floats with 6 significant digits
    return f"{v:g}"


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The native reader, built at first use; its load returns a handle and
    fill and free return nothing."""
    lib = kernel_build.load(SOURCE, {
        "osfm_tracks_load": [ctypes.c_char_p, _I64P, _I64P],
        "osfm_tracks_fill": [ctypes.c_void_p, _I64P, ctypes.POINTER(ctypes.c_int32),
                             ctypes.POINTER(ctypes.c_int32), _I64P,
                             ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8)],
        "osfm_tracks_free": [ctypes.c_void_p]})
    lib.osfm_tracks_load.restype = ctypes.c_void_p
    lib.osfm_tracks_fill.restype = None
    lib.osfm_tracks_free.restype = None
    return lib


def parse_tracks_file(path: str):
    """Flat arrays of a tracks.txt by the native reader: (counts (T,),
    vid (F,), lid (F,), gid (F,), xy (F, 2), rgb (F, 3)). A file that cannot
    be opened or fails its strict parse raises ValueError."""
    lib = library()
    n_tracks, n_feats = ctypes.c_int64(0), ctypes.c_int64(0)
    handle = lib.osfm_tracks_load(os.fsencode(path), ctypes.byref(n_tracks),
                                  ctypes.byref(n_feats))
    if not handle:
        raise ValueError(f"{path}: not a readable tracks.txt (count;viewID;localID;globalID;"
                         "x;y;r;g;b;... per line)")
    try:
        T, F = n_tracks.value, n_feats.value
        counts = np.empty(T, np.int64)
        vid = np.empty(F, np.int32)
        lid = np.empty(F, np.int32)
        gid = np.empty(F, np.int64)
        xy = np.empty((F, 2), np.float32)
        rgb = np.empty((F, 3), np.uint8)

        def ptr(a, ctype):
            return a.ctypes.data_as(ctypes.POINTER(ctype))

        lib.osfm_tracks_fill(handle, ptr(counts, ctypes.c_int64), ptr(vid, ctypes.c_int32),
                             ptr(lid, ctypes.c_int32), ptr(gid, ctypes.c_int64),
                             ptr(xy, ctypes.c_float), ptr(rgb, ctypes.c_uint8))
        return counts, vid, lid, gid, xy, rgb
    finally:
        lib.osfm_tracks_free(handle)


def load_tracks(path: str, view_ids, capacity: int | None = None,
                device="cuda") -> tracks_mod.TrackSet:
    """The TrackSet of a tracks.txt, on `device` (CUDA unless the caller names
    another; see pipeline.matching.checked_device), parsed by the native
    reader (csrc/trackio.cpp, built at first use). A build or parse failure
    raises."""
    from orthosfm_torch.pipeline.matching import checked_device

    device = checked_device(device)
    return tracks_mod.from_flat_arrays(*parse_tracks_file(path), view_ids, capacity=capacity,
                                       device=device)


def load_tracks_plain(path: str, view_ids, capacity: int | None = None,
                      device="cpu") -> tracks_mod.TrackSet:
    """The native reader's plain version, a Python loop (the JAX package's
    reader when its native library is absent): the tests hold the reader
    against it."""
    track_list = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split(";")
            n = int(parts[0])
            feats = []
            idx = 1
            for _ in range(n):
                vid = int(parts[idx]); lid = int(parts[idx + 1]); gid = int(parts[idx + 2])
                x = float(parts[idx + 3]); y = float(parts[idx + 4])
                r = int(parts[idx + 5]); g = int(parts[idx + 6]); b = int(parts[idx + 7])
                feats.append((vid, lid, gid, x, y, r, g, b))
                idx += 8
            track_list.append(feats)
    return tracks_mod.from_feature_lists(track_list, view_ids, capacity=capacity,
                                        device=device)


def save_pairwise_tracks(tracks: tracks_mod.TrackSet, folder: str) -> None:
    """Per-pair correspondence files (reference: matching_io.cpp:97-141)."""
    obs = tracks.obs.cpu().numpy()
    mask = tracks.obs_mask.cpu().numpy() & tracks.alive.cpu().numpy()[:, None]
    vids = tracks.view_ids.cpu().numpy()
    V = len(vids)
    for i in range(V):
        for j in range(i + 1, V):
            both = mask[:, i] & mask[:, j]
            if not both.any():
                continue
            name = f"{int(vids[i]):03d}_{int(vids[j]):03d}.txt"
            with open(os.path.join(folder, name), "w") as f:
                for t in np.flatnonzero(both):
                    f.write(f"{obs[t, i, 0]:g} {obs[t, i, 1]:g} "
                            f"{obs[t, j, 0]:g} {obs[t, j, 1]:g}\n")
