"""Track utilities (port of orthosfm_tpu/pipeline/track_utils.py; the mask
filtering and color propagation of the image front end are not ported yet)."""

from __future__ import annotations

import numpy as np

from orthosfm_torch.data import tracks as tracks_mod


def print_track_overview(tracks: tracks_mod.TrackSet) -> None:
    """Histogram of track lengths (reference: track.cpp:101-120)."""
    counts = tracks.feature_counts().cpu().numpy()
    counts = counts[tracks.alive.cpu().numpy()]
    total = len(counts)
    print(f"Built {total} tracks:")
    if total:
        for length in range(2, int(counts.max()) + 1):
            n = int(np.sum(counts == length))
            if n:
                print(f"  {n} tracks of length {length}")
