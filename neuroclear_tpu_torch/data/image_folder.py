"""Volume-file discovery, a copy of ``neuroclear_tpu/data/image_folder.py``."""

from __future__ import annotations

import os

IMG_EXTENSIONS = [
    ".jpg", ".JPG", ".jpeg", ".JPEG", ".npy",
    ".png", ".PNG", ".ppm", ".PPM", ".bmp", ".BMP",
    ".tif", ".TIF", ".tiff", ".TIFF",
]


def is_image_file(filename: str) -> bool:
    return any(filename.endswith(ext) for ext in IMG_EXTENSIONS)


def make_dataset(directory: str, max_dataset_size=float("inf")) -> list:
    """The image files under ``directory``, walked in sorted order."""
    if not os.path.isdir(directory):
        raise NotADirectoryError(f"{directory} is not a valid directory")
    images = []
    for root, _, fnames in sorted(os.walk(directory)):
        for fname in sorted(fnames):
            if is_image_file(fname) and not fname.startswith("."):
                images.append(os.path.join(root, fname))
    return images[: min(max_dataset_size, len(images))]
