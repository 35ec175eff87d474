"""KITTI odometry dataset loading (counterpart of
`slam1_tpu/utils/kitti.py`): calibration, ground-truth poses, image
lists, decoding and canvas padding. Host-side numpy; the caller moves
frames to its device.

Images decode through the first of cv2, PIL, the native decoder
(`utils/native_loader.py`) that is present; a binary P5 PGM is read with
numpy when none is. Each is imported when first needed. All give the
same (H,W) float32 levels over 255. `write_sequence` writes a sequence
in the same layout (8-bit grayscale PNG through the standard library's
zlib, or P5 PGM), for tests and smoke runs that have no KITTI data.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Iterator, Tuple

import numpy as np

from slam1_tpu_torch.ops.camera import StereoCamera


def load_calib(path: str, device=None) -> Tuple[StereoCamera, np.ndarray,
                                                np.ndarray]:
    """Parse KITTI calib.txt -> (StereoCamera on `device`, P_left,
    P_right); `device=None` means the card when there is one."""
    with open(path) as f:
        lines = [l.strip() for l in f if l.strip()]
    mats = {}
    for line in lines:
        if ":" in line:
            name, vals = line.split(":", 1)
        else:
            name, vals = line.split(" ", 1)
        mats[name.strip()] = np.array(vals.split(), np.float64).reshape(3, 4)
    P0 = mats.get("P0", mats.get("P_rect_00"))
    P1 = mats.get("P1", mats.get("P_rect_01"))
    fx, fy = P0[0, 0], P0[1, 1]
    cx, cy = P0[0, 2], P0[1, 2]
    # Right-camera baseline from P1's translation term: tx = -fx * B.
    baseline = -P1[0, 3] / P1[0, 0]
    cam = StereoCamera.create(fx, fy, cx, cy, baseline, device=device)
    return cam, P0.astype(np.float32), P1.astype(np.float32)


def load_poses(path: str) -> np.ndarray:
    """GT poses: rows of 3x4 -> (N,4,4)."""
    data = np.loadtxt(path).reshape(-1, 3, 4)
    n = data.shape[0]
    out = np.tile(np.eye(4, dtype=np.float64), (n, 1, 1))
    out[:, :3, :4] = data
    return out.astype(np.float32)


def list_images(image_dir: str) -> list:
    return sorted(
        os.path.join(image_dir, f) for f in os.listdir(image_dir)
        if f.endswith((".png", ".jpg", ".pgm")))


def _read_pgm(path: str) -> np.ndarray:
    """Binary P5 PGM with maxval 255 -> (H,W) uint8."""
    with open(path, "rb") as f:
        data = f.read()
    tokens, pos = [], 2
    if data[:2] != b"P5":
        raise IOError(f"{path}: not a binary P5 PGM")
    while len(tokens) < 3:
        while data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            pos = data.index(b"\n", pos)
            continue
        end = pos
        while not data[end:end + 1].isspace():
            end += 1
        tokens.append(int(data[pos:end]))
        pos = end
    w, h, maxval = tokens
    if maxval != 255:
        raise IOError(f"{path}: PGM maxval {maxval}, only 255 is read")
    pos += 1                            # the single whitespace byte
    return np.frombuffer(data, np.uint8, h * w, pos).reshape(h, w)


def _decode_cv2(path):
    import cv2
    img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise IOError(path)
    return img.astype(np.float32) / 255.0


def _decode_pil(path):
    from PIL import Image
    return np.asarray(Image.open(path).convert("L")).astype(np.float32) / 255.0


def _decode_native(path):
    from slam1_tpu_torch.utils import native_loader
    return native_loader.decode_gray(path)


def _decode_pgm(path):
    return _read_pgm(path).astype(np.float32) / 255.0


def _native_available() -> bool:
    from slam1_tpu_torch.utils import native_loader
    return native_loader.available()


def _importable(name: str) -> bool:
    import importlib.util
    return importlib.util.find_spec(name) is not None


_DECODERS = {"cv2": (lambda: _importable("cv2"), _decode_cv2),
             "PIL": (lambda: _importable("PIL"), _decode_pil),
             "native": (_native_available, _decode_native)}


def decoder_for(path: str) -> str:
    """The name of the decoder `load_image` uses for `path`: cv2, PIL,
    native, or pgm (numpy, P5 files only). Raises when there is none,
    naming what is missing."""
    for name, (present, _) in _DECODERS.items():
        if present():
            return name
    if path.endswith(".pgm"):
        return "pgm"
    raise RuntimeError(
        f"no image decoder for {path}: cv2 and PIL are not installed and "
        "the native loader did not build (g++ and zlib are needed); "
        "binary P5 .pgm files are read without any of them")


def load_image(path: str) -> np.ndarray:
    """Grayscale float32 [0,1]."""
    name = decoder_for(path)
    if name == "pgm":
        return _decode_pgm(path)
    return _DECODERS[name][1](path)


def pad_to_canvas(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """Zero-pad an image up to the static canvas."""
    h, w = img.shape
    out = np.zeros((height, width), np.float32)
    out[:min(h, height), :min(w, width)] = img[:height, :width]
    return out


class KittiSequence:
    """Iterator over a KITTI odometry sequence directory:
    <root>/image_0/*.png, image_1/*.png, calib.txt[, poses.txt]. The
    camera lands on `device` (None: the card when there is one)."""

    def __init__(self, root: str, canvas_hw: Tuple[int, int],
                 poses_path: str = None, max_frames: int = None,
                 device=None):
        self.root = root
        self.canvas = canvas_hw
        self.cam, self.P0, self.P1 = load_calib(
            os.path.join(root, "calib.txt"), device)
        self.lefts = list_images(os.path.join(root, "image_0"))
        self.rights = list_images(os.path.join(root, "image_1"))
        if max_frames:
            self.lefts = self.lefts[:max_frames]
            self.rights = self.rights[:max_frames]
        self.gt = None
        if poses_path and os.path.exists(poses_path):
            self.gt = load_poses(poses_path)[:len(self.lefts)]

    def __len__(self):
        return len(self.lefts)

    def frames(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        h, w = self.canvas
        for lp, rp in zip(self.lefts, self.rights):
            yield (pad_to_canvas(load_image(lp), h, w),
                   pad_to_canvas(load_image(rp), h, w))


def _to_u8(img) -> np.ndarray:
    return np.clip(np.rint(np.asarray(img, np.float32) * 255.0), 0,
                   255).astype(np.uint8)


def write_png(path: str, img: np.ndarray):
    """An (H,W) uint8 image as an 8-bit grayscale PNG (filter 0 on every
    row), written with zlib and struct only."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    raw = np.concatenate([np.zeros((h, 1), np.uint8), img], axis=1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(chunk(b"IEND", b""))


def write_pgm(path: str, img: np.ndarray):
    """An (H,W) uint8 image as a binary P5 PGM."""
    img = np.ascontiguousarray(img, np.uint8)
    with open(path, "wb") as f:
        f.write(b"P5\n%d %d\n255\n" % (img.shape[1], img.shape[0]))
        f.write(img.tobytes())


def write_sequence(root: str, lefts, rights, cam: StereoCamera,
                   poses=None, fmt: str = "png") -> str:
    """A KITTI odometry directory from (F,H,W) float [0,1] stacks:
    image_0/, image_1/ (8-bit levels, `fmt` "png" or "pgm"), calib.txt
    (P0, P1 of the rectified rig `cam`) and, with `poses` (F,4,4),
    poses.txt. Returns `root`."""
    write = {"png": write_png, "pgm": write_pgm}[fmt]
    for sub, stack in (("image_0", lefts), ("image_1", rights)):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        for i, img in enumerate(stack):
            write(os.path.join(root, sub, f"{i:06d}.{fmt}"), _to_u8(img))
    fx, fy, cx, cy, b = (float(v) for v in cam)
    with open(os.path.join(root, "calib.txt"), "w") as f:
        f.write(f"P0: {fx!r} 0 {cx!r} 0 0 {fy!r} {cy!r} 0 0 0 1 0\n")
        f.write(f"P1: {fx!r} 0 {cx!r} {-fx * b!r} 0 {fy!r} {cy!r} 0 0 0 1 "
                "0\n")
    if poses is not None:
        poses = np.asarray(poses)
        np.savetxt(os.path.join(root, "poses.txt"),
                   poses[:, :3, :].reshape(len(poses), 12), fmt="%.9e")
    return root
