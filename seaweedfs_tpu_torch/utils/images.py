"""Image resizing + EXIF orientation fix on the volume read path
(reference weed/images/resizing.go + orientation.go, applied in
volume_server_handlers_read.go when width/height/mode query params are
present). Uses PIL; no-ops gracefully if PIL is unavailable.

The port's copy of seaweedfs_tpu/utils/images.py, the same code; it imports
nothing of that package.
"""

from __future__ import annotations

import io
from typing import Optional

try:
    from PIL import Image, ImageOps
    _HAVE_PIL = True
except ImportError:  # pragma: no cover
    _HAVE_PIL = False


def is_image(mime: str, name: str = "") -> bool:
    if mime.startswith("image/"):
        return True
    lower = name.lower()
    return lower.endswith((".jpg", ".jpeg", ".png", ".gif", ".webp"))


def fix_jpg_orientation(data: bytes) -> bytes:
    """Rotate per EXIF orientation tag (reference orientation.go)."""
    if not _HAVE_PIL:
        return data
    try:
        img = Image.open(io.BytesIO(data))
        fixed = ImageOps.exif_transpose(img)
        if fixed is img:
            return data
        out = io.BytesIO()
        fixed.save(out, format=img.format or "JPEG")
        return out.getvalue()
    except Exception:
        return data


def resized(data: bytes, width: Optional[int], height: Optional[int],
            mode: str = "") -> bytes:
    """Resize keeping aspect ratio ('' default), 'fit' letterbox, or
    'fill' center-crop (reference resizing.go Resized)."""
    if not _HAVE_PIL or (not width and not height):
        return data
    try:
        img = Image.open(io.BytesIO(data))
        fmt = img.format or "PNG"
        w, h = img.size
        width = width or w
        height = height or h
        if mode == "fill":
            resized_img = ImageOps.fit(img, (width, height))
        elif mode == "fit":
            img.thumbnail((width, height))
            resized_img = ImageOps.pad(img, (width, height))
        else:
            img.thumbnail((width, height))
            resized_img = img
        out = io.BytesIO()
        resized_img.save(out, format=fmt)
        return out.getvalue()
    except Exception:
        return data
