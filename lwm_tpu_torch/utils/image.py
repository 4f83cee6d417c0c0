"""Image and video files for the vision apps.

- `write_png` / `read_png`: 8-bit RGB PNG with the standard library alone
  (zlib, struct, CRC32), since the card's machine has no PIL. The file
  holds exactly the pixels given (every row unfiltered, one IDAT), so
  that a PNG reader (PIL's among them) returns them.
- `write_video`: the JAX app's MP4 writer (`lwm_tpu/apps/
  vision_generation.py:200-218`): imageio, else OpenCV; `check_video_writer`
  raises `ImportError` naming both when neither is installed, for a caller
  to check before it loads any model.
- `center_crop_resize` and `read_video_frames`: the JAX readers
  (`lwm_tpu/apps/vision_chat.py:58-109`), a PIL image resized on its short
  side and center-cropped to [-1, 1] floats, and up to n RGB frames
  sampled evenly from a video file through OpenCV; `read_frames` is the
  vision apps' file path through both (`vision_chat.py:149-158`).

PIL, imageio and cv2 are imported only inside the functions that need them.
"""

from __future__ import annotations

import importlib.util
import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path, pixels):
    """pixels: uint8 [H, W, 3] → an RGB PNG at `path`."""
    pixels = np.ascontiguousarray(pixels)
    if pixels.dtype != np.uint8 or pixels.ndim != 3 or pixels.shape[2] != 3:
        raise ValueError(f"write_png takes uint8 [H, W, 3], got {pixels.dtype} {pixels.shape}")
    h, w, _ = pixels.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), pixels.reshape(h, w * 3)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)   # 8-bit RGB, no interlace
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def read_png(path):
    """The pixels uint8 [H, W, 3] of an 8-bit RGB PNG whose rows are
    unfiltered (as `write_png` writes them); checks every chunk's CRC."""
    data = open(path, "rb").read()
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError(f"{path}: not a PNG")
    pos, idat, header = len(PNG_SIGNATURE), [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad CRC in {kind!r}")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + n
    w, h, depth, color, _, _, interlace = header
    if (depth, color, interlace) != (8, 2, 0):
        raise ValueError(f"{path}: want 8-bit RGB without interlace, got {header}")
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * 3)
    if rows[:, 0].any():
        raise ValueError(f"{path}: filtered rows are not read here")
    return rows[:, 1:].reshape(h, w, 3).copy()


def check_video_writer():
    """Raise ImportError unless imageio or OpenCV can be imported."""
    if importlib.util.find_spec("imageio") is None and importlib.util.find_spec("cv2") is None:
        raise ImportError("writing an MP4 needs imageio (with its ffmpeg plugin) or OpenCV "
                          "(cv2), and neither is installed")


def write_video(path, frames, fps=4):
    """MP4 of uint8 RGB frames [t, H, W, 3]: imageio when it works, else OpenCV."""
    try:
        import imageio

        writer = imageio.get_writer(path, fps=fps)
        for frame in frames:
            writer.append_data(frame)
        writer.close()
    except Exception:
        import cv2

        h, w = frames[0].shape[:2]
        out = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
        for frame in frames:
            out.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
        out.release()


def center_crop_resize(image, size):
    """A PIL image resized on its short side to `size` and center-cropped
    to size x size → float32 [size, size, C] in [-1, 1]."""
    width, height = image.size
    if width < height:
        new_width, new_height = size, int(size * height / width)
    else:
        new_width, new_height = int(size * width / height), size
    image = image.resize((new_width, new_height))
    left = (new_width - size) / 2
    top = (new_height - size) / 2
    image = image.crop((left, top, left + size, top + size))
    return np.array(image, dtype=np.float32) / 127.5 - 1


def read_video_frames(path, max_n_frames):
    """Up to `max_n_frames` RGB frames uint8 [t, H, W, 3] sampled evenly
    from the video at `path` with OpenCV."""
    import cv2

    cap = cv2.VideoCapture(path)
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    if n <= 0:
        frames = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(frame)
        n = len(frames)
        if n == 0:
            raise ValueError(f"no frames decoded from {path}")
        idxs = (list(range(n)) if n <= max_n_frames
                else np.linspace(0, n - 1, max_n_frames, dtype=int).tolist())
        out = [cv2.cvtColor(frames[i], cv2.COLOR_BGR2RGB) for i in idxs]
    else:
        idxs = (list(range(n)) if n <= max_n_frames
                else np.linspace(0, n - 1, max_n_frames, dtype=int).tolist())
        out = []
        for i in idxs:
            cap.set(cv2.CAP_PROP_POS_FRAMES, i)
            ok, frame = cap.read()
            if not ok:
                continue
            out.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    cap.release()
    return np.stack(out)


def read_frames(path, max_n_frames, size=256):
    """An image (.png/.jpg/.jpeg) as one frame, or up to `max_n_frames`
    frames of a video, each center-cropped to size x size: float32 [t,
    size, size, 3] in [-1, 1]. Raises ImportError without PIL."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("reading an image or a video's frames needs PIL (and OpenCV for a "
                          "video)") from e
    if path.endswith((".png", ".jpg", ".jpeg")):
        return center_crop_resize(Image.open(path).convert("RGB"), size)[None]
    video = read_video_frames(path, max_n_frames)
    return np.stack([center_crop_resize(Image.fromarray(f), size) for f in video])
