"""View metadata and image loading.

Replaces the reference's View class + OpenCV image path
(src/data_structures/view.{h,cpp}, src/util/common.cpp:15-38) with PIL-based
host-side loading into NumPy arrays. Images stay on the host; only feature
tensors move to the device.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import numpy as np

IMAGE_EXTENSIONS = (".tiff", ".tif", ".png", ".jpeg", ".jpg")


def images_in_folder(folder: str) -> List[str]:
    """Sorted list of absolute image paths (reference: common.cpp:15-38 —
    boost directory iteration order is fs-dependent; we sort for determinism)."""
    if not os.path.isdir(folder):
        print("Error: The specified image folder does not exist or is invalid.")
        return []
    out = []
    for entry in sorted(os.listdir(folder)):
        p = os.path.join(folder, entry)
        if os.path.isfile(p) and os.path.splitext(entry)[1].lower() in IMAGE_EXTENSIONS:
            out.append(os.path.abspath(p))
    return out


@dataclasses.dataclass
class View:
    """One input image (reference: view.h:21-66)."""

    view_id: int
    image_path: str
    width: int = 0
    height: int = 0
    pixels: Optional[np.ndarray] = None  # (H, W, 3) uint8 RGB
    mask_path: str = ""
    mask: Optional[np.ndarray] = None  # (H, W) uint8

    @property
    def image_name(self) -> str:
        return os.path.basename(self.image_path)

    def find_corresponding_mask(self, mask_folder: str) -> None:
        """Look for ``{name}_mask.png`` or ``{name}.png``
        (reference: view.cpp:84-98)."""
        stem = os.path.splitext(self.image_name)[0]
        for cand in (f"{stem}_mask.png", f"{stem}.png"):
            p = os.path.join(mask_folder, cand)
            if os.path.isfile(p):
                self.mask_path = p
                return

    def load_pixel_data(self, downscale_factor: int = 1) -> None:
        """Load + bilinear-downscale image (and mask) —
        reference: view.cpp:28-50."""
        from PIL import Image

        img = Image.open(self.image_path).convert("RGB")
        if downscale_factor != 1:
            size = (int(img.width / downscale_factor), int(img.height / downscale_factor))
            img = img.resize(size, Image.BILINEAR)
        self.pixels = np.asarray(img, np.uint8)
        self.height, self.width = self.pixels.shape[:2]
        if self.mask_path:
            m = Image.open(self.mask_path).convert("L")
            if m.size != (self.width, self.height):
                m = m.resize((self.width, self.height), Image.BILINEAR)
            self.mask = np.asarray(m, np.uint8)


def load_views(image_folder: str, mask_folder: str = "",
               downscale_factor: int = 1) -> List[View]:
    """Load all images in a folder as views (reference: reconstruct.cpp:36-62)."""
    paths = images_in_folder(image_folder)
    views = [View(i, p) for i, p in enumerate(paths)]
    for v in views:
        if mask_folder:
            v.find_corresponding_mask(mask_folder)
        v.load_pixel_data(downscale_factor)
    return views
