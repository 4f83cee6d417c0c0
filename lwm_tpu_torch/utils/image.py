"""Image and video files for the vision apps.

- `write_png` / `read_png`: PNG with the standard library and numpy alone
  (zlib, struct, CRC32), since the card's machine has no PIL. `write_png`
  writes 8-bit RGB, exactly the pixels given (every row unfiltered, one
  IDAT), so that a PNG reader (PIL's among them) returns them; `read_png`
  reads any 8-bit PNG that is not interlaced, filtered rows and gray,
  palette and alpha images included, as PIL's decode to RGB gives it.
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


# samples a pixel of each PNG color type: gray, RGB, palette, gray + alpha, RGBA
_PNG_SAMPLES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw, h, stride, bpp, path):
    """The rows [h, stride] uint8 of a PNG's decompressed scanlines, each
    filter (None, Sub, Up, Average, Paeth) undone."""
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = raw[y, 0], raw[y, 1:]
        if kind == 0:
            row = line
        elif kind == 1:   # + the byte a pixel to the left: a running sum a channel
            row = (np.cumsum(line.reshape(-1, bpp), 0, dtype=np.uint64) % 256).astype(
                np.uint8).reshape(-1)
        elif kind == 2:
            row = line + prior
        elif kind in (3, 4):
            row, up = bytearray(line.tobytes()), prior.tolist()
            for i in range(stride):
                left = row[i - bpp] if i >= bpp else 0
                if kind == 3:
                    row[i] = (row[i] + ((left + up[i]) >> 1)) & 255
                else:
                    row[i] = (row[i] + _paeth(left, up[i], up[i - bpp] if i >= bpp else 0)) & 255
            row = np.frombuffer(bytes(row), np.uint8)
        else:
            raise ValueError(f"{path}: row {y} has filter type {kind}")
        out[y] = prior = row
    return out


def read_png(path):
    """The pixels uint8 [H, W, 3] of an 8-bit PNG (gray, RGB, palette, each
    with or without alpha; not interlaced), as PIL's `Image.open(path).
    convert("RGB")` gives them: gray repeated over the three channels, a
    palette index looked up, alpha dropped. Checks every chunk's CRC; any
    other PNG raises, naming the file."""
    data = open(path, "rb").read()
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError(f"{path}: not a PNG")
    pos, idat, header, palette = len(PNG_SIGNATURE), [], None, None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad CRC in {kind!r}")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _PNG_SAMPLES or interlace:
        raise ValueError(f"{path}: a PNG of bit depth {depth}, color type {color}, interlace "
                         f"{interlace} is not read here (8-bit, not interlaced, is)")
    bpp = _PNG_SAMPLES[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * bpp)
    if raw[:, 0].any():
        rows = _unfilter(raw, h, w * bpp, bpp, path)
    else:
        rows = raw[:, 1:]
    px = rows.reshape(h, w, bpp)
    if color == 3:
        if palette is None:
            raise ValueError(f"{path}: a palette image without a PLTE chunk")
        return palette[px[..., 0]]
    if color in (0, 4):
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


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
