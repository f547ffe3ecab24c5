"""Debug visualization: side-by-side match rendering. Port of
orthosfm_tpu/utils/visualize.py (the same Pillow drawing, so the same PNG
bytes for the same inputs).

Headless analog of the reference's visualizeMatches (src/matching/
matching.cpp:285-323, which opens an OpenCV window): draws the two views next
to each other with lines between matched feature positions and saves a PNG.
"""

from __future__ import annotations

import numpy as np


def _host(x) -> np.ndarray:
    """A numpy view of a host array or a copy of a torch tensor."""
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def save_match_visualization(image1, image2, xy1, xy2, path: str,
                             max_matches: int = 200) -> None:
    """image1/2: (H, W, 3) uint8; xy1/xy2: (M, 2) matched pixel coords
    (numpy arrays or tensors on any device)."""
    from PIL import Image, ImageDraw

    image1, image2, xy1, xy2 = (_host(a) for a in (image1, image2, xy1, xy2))
    h = max(image1.shape[0], image2.shape[0])
    w1 = image1.shape[1]
    canvas = np.zeros((h, w1 + image2.shape[1], 3), np.uint8)
    canvas[: image1.shape[0], :w1] = image1
    canvas[: image2.shape[0], w1:] = image2
    img = Image.fromarray(canvas)
    draw = ImageDraw.Draw(img)
    rng = np.random.default_rng(0)
    m = min(len(xy1), max_matches)
    sel = rng.choice(len(xy1), m, replace=False) if len(xy1) > m else np.arange(m)
    for k in sel:
        x1, y1 = float(xy1[k][0]), float(xy1[k][1])
        x2, y2 = float(xy2[k][0]) + w1, float(xy2[k][1])
        color = tuple(int(c) for c in rng.integers(64, 255, 3))
        draw.line([(x1, y1), (x2, y2)], fill=color, width=1)
        draw.ellipse([x1 - 2, y1 - 2, x1 + 2, y1 + 2], outline=color)
        draw.ellipse([x2 - 2, y2 - 2, x2 + 2, y2 + 2], outline=color)
    img.save(path)
