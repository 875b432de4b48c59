"""Image, mask and edge-map loading for the visualize/masks/edges trees.

The reference loads any format via CImg + libjpeg
(reference source/image/image.cpp:473-830, source/image/photoSetS.cpp:24-73:
try visualize/%08d.{ppm,jpg,png,tiff}, falling back to 4-digit names).
Binary PPM/PGM/PBM (the formats the reference itself writes, and the
synthetic-scene generators here) are read without dependencies; JPEG,
PNG and TIFF need PIL, imported only when such a file is opened.
"""
from __future__ import annotations

import os

import numpy as np

_EXTS = (".ppm", ".jpg", ".jpeg", ".png", ".tiff", ".pgm", ".pbm")


def find_image_path(dirname: str, image_id: int,
                    exts: tuple[str, ...] = _EXTS) -> str | None:
    """Resolve visualize/%08d.* with 4-digit fallback
    (reference photoSetS.cpp:27-72)."""
    for fmt in ("%08d", "%04d"):
        base = os.path.join(dirname, fmt % image_id)
        for ext in exts:
            p = base + ext
            if os.path.exists(p):
                return p
    return None


_PNM_MAGIC = (b"P4", b"P5", b"P6")


def _is_pnm(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(2) in _PNM_MAGIC


def _pnm_header(data: bytes, nfields: int) -> tuple[list[int], int]:
    """Parse `nfields` whitespace-separated header integers after the
    2-byte magic (comments allowed); returns (fields, offset of the
    raster, which starts one whitespace byte after the last field)."""
    fields: list[int] = []
    i = 2
    while len(fields) < nfields:
        while i < len(data) and data[i:i + 1].isspace():
            i += 1
        if data[i:i + 1] == b"#":
            while i < len(data) and data[i:i + 1] != b"\n":
                i += 1
            continue
        j = i
        while j < len(data) and not data[j:j + 1].isspace():
            j += 1
        if j == i:
            raise ValueError("truncated PNM header")
        fields.append(int(data[i:j]))
        i = j
    return fields, i + 1


def read_pnm(path: str) -> np.ndarray:
    """Binary PBM (P4), PGM (P5) or PPM (P6) with 8-bit samples ->
    uint8 [H, W] (P4/P5) or [H, W, 3] (P6). PBM bits follow the format:
    1 = black -> 0, 0 = white -> 255."""
    with open(path, "rb") as f:
        data = f.read()
    magic = data[:2]
    if magic not in _PNM_MAGIC:
        raise ValueError(f"{path}: not a binary PBM/PGM/PPM file")
    if magic == b"P4":
        (w, h), off = _pnm_header(data, 2)
        row = (w + 7) // 8
        bits = np.unpackbits(np.frombuffer(data, np.uint8, row * h, off)
                             .reshape(h, row), axis=1)[:, :w]
        return np.where(bits == 1, 0, 255).astype(np.uint8)
    (w, h, maxval), off = _pnm_header(data, 3)
    if maxval > 255:
        raise ValueError(f"{path}: 16-bit PNM samples are not supported")
    ch = 3 if magic == b"P6" else 1
    arr = np.frombuffer(data, np.uint8, w * h * ch, off)
    arr = arr.reshape((h, w, 3) if ch == 3 else (h, w))
    if maxval != 255:
        arr = (arr.astype(np.uint32) * 255 + maxval // 2) // maxval
    return arr.astype(np.uint8)


def _pil_open(path: str):
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"{path}: reading this format needs the Pillow package; "
            "convert the image to PPM/PGM or install Pillow") from e
    return Image.open(path)


def image_size(path: str) -> tuple[int, int]:
    """(width, height) of an image file, reading only its header."""
    if _is_pnm(path):
        with open(path, "rb") as f:
            head = f.read(1024)
        (w, h), _ = _pnm_header(head, 2)
        return w, h
    with _pil_open(path) as im:
        return im.size


def load_image(path: str) -> np.ndarray:
    """Load an RGB image -> uint8 [H, W, 3]."""
    if _is_pnm(path):
        arr = read_pnm(path)
        return arr if arr.ndim == 3 else np.repeat(arr[:, :, None], 3, 2)
    with _pil_open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


def load_pgm_mask(path: str) -> np.ndarray:
    """Load a mask/edge map -> uint8 [H, W], nonzero = usable
    (reference image.cpp mask semantics: 127 < value => in-mask)."""
    if _is_pnm(path):
        arr = read_pnm(path)
        if arr.ndim == 3:   # ITU-R 601 luma, as PIL's convert("L")
            arr = ((arr[..., 0].astype(np.uint32) * 299
                    + arr[..., 1].astype(np.uint32) * 587
                    + arr[..., 2].astype(np.uint32) * 114 + 500)
                   // 1000).astype(np.uint8)
    else:
        with _pil_open(path) as im:
            arr = np.asarray(im.convert("L"), dtype=np.uint8)
    return (arr > 127).astype(np.uint8)


def save_pgm(path: str, mask: np.ndarray) -> None:
    """Binary P5 PGM writer for masks (nonzero -> 255, so load_pgm_mask's
    127-threshold round-trips; format: reference image.cpp:569-607)."""
    mask = (np.asarray(mask) > 0).astype(np.uint8) * 255
    h, w = mask.shape
    with open(path, "wb") as f:
        f.write(f"P5\n{w} {h}\n255\n".encode())
        f.write(mask.tobytes())


def save_ppm(path: str, image: np.ndarray) -> None:
    """Binary P6 PPM writer (format: reference image.cpp:609-641)."""
    image = np.asarray(image, dtype=np.uint8)
    h, w = image.shape[:2]
    if image.ndim == 2:
        image = np.repeat(image[:, :, None], 3, axis=2)
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(image.tobytes())


def load_ppm(path: str) -> np.ndarray:
    """Binary P6 PPM reader -> uint8 [H, W, 3]."""
    arr = read_pnm(path)
    if arr.ndim != 3:
        raise ValueError("Not a P6 PPM")
    return arr
