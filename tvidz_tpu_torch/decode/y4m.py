"""Pure-Python YUV4MPEG2 (.y4m) reader/writer.

The dependency-free decode path: Y4M is uncompressed planar YUV with a text
header, so it needs no codec. It serves tests and environments without the
native libav extension — the role LocalStack plays for AWS in the reference's
test strategy (SURVEY.md §4). Luma is downscaled to the target resolution
with integer-exact area averaging (matches ops/golden.area_resize for
integer ratios; general case uses the same overlap weights).

A block is decoded at once: its frames are read into one buffer whose first
slot holds the previous block's last frame, the native-resolution mafd of
every pair is an integer sum, and an integer-ratio downscale with windows up
to ``_EXACT_WINDOW`` a side is an integer window sum rounded half to even.
Both give the bytes and floats of the per-frame float computation they
replace (the tests hold them to the reference's decoder). The counters
``decode.area_exact`` and ``decode.area_matrix`` (``utils.timing``) count
the blocks each resize path takes.
"""

from __future__ import annotations

import os
from typing import Iterator, Tuple

import numpy as np

from tvidz_tpu_torch.decode.base import DecodeError, Decoder, FrameBlock, VideoInfo
from tvidz_tpu_torch.ops import golden
from tvidz_tpu_torch.utils.timing import count

_MAGIC = b"YUV4MPEG2"


def _parse_header(line: bytes) -> Tuple[int, int, float, str]:
    if not line.startswith(_MAGIC):
        raise DecodeError("not a YUV4MPEG2 stream")
    width = height = 0
    fps = 25.0
    colorspace = "420"
    for tok in line.decode("ascii", "replace").split()[1:]:
        key, val = tok[0], tok[1:]
        if key == "W":
            width = int(val)
        elif key == "H":
            height = int(val)
        elif key == "F":
            num, den = val.split(":")
            fps = int(num) / int(den)
        elif key == "C":
            colorspace = val
    if width <= 0 or height <= 0:
        raise DecodeError(f"bad y4m geometry W={width} H={height}")
    return width, height, fps, colorspace


def _frame_bytes(width: int, height: int, colorspace: str) -> int:
    y = width * height
    if colorspace.startswith("420"):
        return y + y // 2
    if colorspace.startswith("422"):
        return y * 2
    if colorspace.startswith("444"):
        return y * 3
    if colorspace.startswith("mono"):
        return y
    raise DecodeError(f"unsupported y4m colorspace {colorspace}")


# Bytes the reader buffers: a frame's reads then copy from memory, where each
# read from the file would release the interpreter lock and wait to take it
# back from the service's other threads.
_READ_BUFFER = 1 << 23

# Window sides the integer path takes; the tests cover every window sum of
# every window up to this size. Its sums fit uint16 (255 * 64 < 2**16).
_EXACT_WINDOW = 8


def _window_sums(luma: np.ndarray, fh: int, fw: int) -> np.ndarray:
    """(T, H, W) uint8 -> (T, H // fh, W // fw) uint16 sums of fh x fw
    windows: rows first (contiguous), then columns on the smaller sums."""
    t, h, w = luma.shape
    rows = luma.reshape(t, h // fh, fh, w)
    s = rows[:, :, 0].astype(np.uint16)
    for i in range(1, fh):
        s += rows[:, :, i]
    if fw > 1:
        cols = s.reshape(t, h // fh, w // fw, fw)
        s = cols[..., 0] + cols[..., 1]
        for j in range(2, fw):
            s += cols[..., j]
    return s


def _rint_div(s: np.ndarray, k: int) -> np.ndarray:
    """``np.rint(s / k)`` (half to even) of uint16 window sums, as uint8, in
    integers: floor((s + (k - 1) // 2 + odd(s // k)) / k), the parity term
    only for even k, where exact halves exist. Overwrites ``s``."""
    if k % 2 == 0:
        s += (s // k) & 1
    s += (k - 1) // 2
    s //= k
    return s.astype(np.uint8)


def _downscale_luma(luma: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """(T, H, W) uint8 -> (T, out_h, out_w) uint8 area average."""
    t, h, w = luma.shape
    if (h, w) == (out_h, out_w):
        return luma
    if h % out_h == 0 and w % out_w == 0:
        fh, fw = h // out_h, w // out_w
        if fh <= _EXACT_WINDOW and fw <= _EXACT_WINDOW:
            # Equal to the float32 mean below: its window sum is exact, and
            # its one division by k is correctly rounded with no false halves.
            count("decode.area_exact")
            return _rint_div(_window_sums(luma, fh, fw), fh * fw)
        x = luma.reshape(t, out_h, fh, out_w, fw).astype(np.float32)
        out = x.mean(axis=(2, 4))
    else:
        count("decode.area_matrix")
        ph = golden.area_resize_matrix(h, out_h)
        pw = golden.area_resize_matrix(w, out_w)
        # Two BLAS matmuls; a single 3-operand np.einsum without optimize=True
        # falls back to naive nested loops (~100x slower on 128-frame blocks).
        tmp = luma.astype(np.float32) @ pw.T                 # (T, H, out_w)
        out = np.tensordot(tmp, ph, axes=([1], [1]))         # (T, out_w, out_h)
        out = out.transpose(0, 2, 1)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def _mafd(frames: np.ndarray) -> np.ndarray:
    """(n + 1, H, W) uint8 -> (n,) float64 mean |frames[i + 1] - frames[i]|.

    Each |a - b| is uint8 ``max - min``; a row sums in uint32 (255 * W fits),
    a frame in int64, and the exact sum is divided once, so each value is
    bit-equal to ``np.mean(np.abs(int16 diff))`` (float64, exact partial
    sums, one correctly rounded division)."""
    _, h, w = frames.shape
    a, b = frames[1:], frames[:-1]
    d = np.maximum(a, b)
    d -= np.minimum(a, b)
    rows = np.add.reduce(d, axis=2, dtype=np.uint32)
    return rows.sum(axis=1, dtype=np.int64) / (h * w)


class Y4MDecoder(Decoder):
    def probe(self, path: str) -> VideoInfo:
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            header = f.readline()
            width, height, fps, cs = _parse_header(header)
        fb = _frame_bytes(width, height, cs)
        # Each frame record is b"FRAME...\n" + planes; estimate count from the
        # file size assuming the minimal 6-byte FRAME marker.
        per = fb + 6
        nb = max((size - len(header)) // per, 0)
        return VideoInfo(
            width=width, height=height, fps=fps, nb_frames=int(nb),
            duration=float(nb / fps) if fps else 0.0, codec="rawvideo/y4m",
        )

    def blocks(
        self, path: str, block_frames: int, height: int, width: int
    ) -> Iterator[FrameBlock]:
        with open(path, "rb", buffering=_READ_BUFFER) as f:
            header = f.readline()
            src_w, src_h, fps, cs = _parse_header(header)
            chroma = bytearray(_frame_bytes(src_w, src_h, cs) - src_w * src_h)
            # Slot 0: the previous block's last FULL-RES frame, for the
            # native-resolution mafd across the block edge (unset before the
            # first block, whose first mafd is 0 by convention).
            buf = np.empty((block_frames + 1, src_h, src_w), np.uint8)
            idx = 0
            n = 0
            while True:
                marker = f.readline()
                if marker:
                    if not marker.startswith(b"FRAME"):
                        raise DecodeError(f"bad frame marker at frame {idx}")
                    if (f.readinto(buf[n + 1]) < buf[n + 1].nbytes
                            or f.readinto(chroma) < len(chroma)):
                        raise DecodeError(f"truncated frame {idx}")
                    n += 1
                    idx += 1
                if n and (n == block_frames or not marker):
                    start = idx - n
                    frames = buf[1:n + 1]
                    # Native-resolution mafd (f_select.c semantics): the
                    # scene score is computed at decode resolution like the
                    # reference's full-frame `select` filter, not on the
                    # downscaled block (averaging suppresses high-frequency
                    # diff energy).
                    mafd = _mafd(buf[:n + 1])
                    if start == 0:
                        mafd[0] = 0.0
                    luma = _downscale_luma(frames, height, width)
                    yield FrameBlock(
                        # The buffer is refilled for the next block.
                        luma=luma.copy() if luma is frames else luma,
                        pts=np.asarray([i / fps for i in range(start, idx)]),
                        start_frame=start,
                        mafd=mafd,
                    )
                    buf[0] = buf[n]
                    n = 0
                if not marker:
                    return


def write_y4m(path: str, luma: np.ndarray, fps: float = 25.0) -> None:
    """Write (T, H, W) uint8 luma as C420 y4m (U/V planes neutral 128)."""
    t, h, w = luma.shape
    assert h % 2 == 0 and w % 2 == 0, "y4m 420 needs even dims"
    chroma = np.full((h // 2) * (w // 2), 128, np.uint8).tobytes()
    num, den = (int(fps), 1) if float(fps).is_integer() else (int(round(fps * 1001)), 1001)
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F{num}:{den} Ip A1:1 C420jpeg\n".encode())
        for i in range(t):
            f.write(b"FRAME\n")
            f.write(np.ascontiguousarray(luma[i]).tobytes())
            f.write(chroma)
            f.write(chroma)
