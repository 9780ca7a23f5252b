"""Everything a run feeds the program, made from ``--seed``.

The same seed gives the same data on the same card. Bulk data (the catalog's
fingerprint rows, the uploads' pixels) is drawn on the device with a
``torch.Generator`` in a few large calls; small choices (sizes, orders, cut
positions) come from a numpy ``Generator``. Each use draws from its own
stream, named by a tag, so adding a use never shifts another's numbers.

- ``catalog``: a deployment's stored videos as fingerprint rows. A video is a
  run of shots (lengths drawn from the configuration's range); the frames of
  a shot share a random base hash, each frame with a few bits flipped at
  random, as consecutive frames of one shot hash nearly alike. Its cut
  timestamps are the shot starts at the catalog's frame rate.
- ``synthetic_luma``: the pixels of an upload, the generator of
  ``tvidz_tpu_torch/decode/synthetic.py`` on the device: each shot a coarse
  random 16-pixel grid, every frame with Gaussian noise, hard cuts between.
- ``y4m_bytes``: those pixels as a YUV4MPEG2 C420 file, neutral chroma.
"""

from __future__ import annotations

import hashlib
from typing import List, Sequence, Tuple

import numpy as np
import torch


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed for the stream named by ``tags`` under ``seed``."""
    h = hashlib.sha256(repr((int(seed),) + tuple(tags)).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def np_rng(seed: int, *tags) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, *tags))


def torch_gen(seed: int, device, *tags) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, *tags))
    return g


def random_words(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Uniform 32-bit words as int64 in [0, 2**32)."""
    return torch.randint(0, 1 << 32, shape, generator=gen, device=device,
                         dtype=torch.int64)


def cut_gaps(rng: np.random.Generator, frames: int, gap: Sequence[int],
             used: set) -> List[int]:
    """Shot starts of a ``frames``-frame video with shot lengths drawn from
    ``gap`` = [lo, hi], each start not in ``used`` (redrawn until it is;
    added to it), so no two uploads of a run share a cut."""
    lo, hi = int(gap[0]), int(gap[1])
    cuts, at = [], 0
    while True:
        for _ in range(1000):
            nxt = at + int(rng.integers(lo, hi + 1))
            if nxt not in used:
                break
        else:
            raise RuntimeError("no unused cut position left")
        if nxt >= frames:
            return cuts
        used.add(nxt)
        cuts.append(nxt)
        at = nxt


def catalog(seed: int, device, videos: int, frames: int, words: int,
            shot_frames: Sequence[int], flip_log2: int,
            chunk: int = 512) -> Tuple[np.ndarray, np.ndarray]:
    """((videos, frames, words) uint32 rows, (videos, max_shots) int64 shot
    starts, -1 past each video's last): every shot a random base hash, each
    frame's bits flipped with probability 2**-flip_log2 (an AND of that many
    random words)."""
    lo, hi = int(shot_frames[0]), int(shot_frames[1])
    max_shots = frames // lo + 1
    rows = np.empty((videos, frames, words), np.uint32)
    starts = np.empty((videos, max_shots), np.int64)
    idx = torch.arange(frames, device=device)
    for s in range(0, videos, chunk):
        v = min(chunk, videos - s)
        g = torch_gen(seed, device, "catalog", s)
        gaps = torch.randint(lo, hi + 1, (v, max_shots), generator=g,
                             device=device)
        cuts = gaps.cumsum(1)
        shot = torch.searchsorted(cuts, idx.expand(v, frames).contiguous(),
                                  right=True)
        base = random_words(g, (v, max_shots + 1, words), device)
        fp = base.gather(1, shot[..., None].expand(v, frames, words))
        flips = random_words(g, (v, frames, words), device)
        for _ in range(flip_log2 - 1):
            flips &= random_words(g, (v, frames, words), device)
        fp ^= flips
        rows[s:s + v] = fp.cpu().numpy().astype(np.uint32)
        starts[s:s + v] = torch.where(cuts < frames, cuts, -1).cpu().numpy()
    return rows, starts


def shot_timestamps(starts: np.ndarray, fps_num: int, fps_den: int
                    ) -> List[List[float]]:
    """Each video's cut timestamps (its shot starts after the first), in
    seconds rounded to 6 decimals as the analyzer stores them."""
    return [[round(int(k) * fps_den / fps_num, 6) for k in row if k >= 0]
            for row in starts]


def planted_copies(seed: int, device, rows: np.ndarray, sources: np.ndarray,
                   max_flips: int) -> List[Tuple[int, int]]:
    """Write a copy of each source video into its own catalog video at a
    random offset, every frame with 0..``max_flips`` of its bits flipped (a
    re-encoded copy that stays within the match threshold). Returns each
    source's (catalog video, offset)."""
    n_src, t_src, words = sources.shape
    videos, frames, _ = rows.shape
    rng = np_rng(seed, "copies")
    hosts = rng.choice(videos, size=n_src, replace=False)
    offsets = rng.integers(0, frames - t_src + 1, size=n_src)
    g = torch_gen(seed, device, "copy-flips")
    bits = 32 * words
    k = torch.randint(0, max_flips + 1, (n_src, t_src, 1), generator=g,
                      device=device)
    rank = torch.rand((n_src, t_src, bits), generator=g,
                      device=device).argsort(-1).argsort(-1)
    flip = (rank < k).to(torch.int64).reshape(n_src, t_src, words, 32)
    shifts = 31 - torch.arange(32, device=device)
    mask = (flip << shifts).sum(-1).cpu().numpy().astype(np.uint32)
    out = []
    for i in range(n_src):
        h, o = int(hosts[i]), int(offsets[i])
        rows[h, o:o + t_src] = sources[i] ^ mask[i]
        out.append((h, o))
    return out


def synthetic_luma(seed: int, device, tag, frames: int, height: int,
                   width: int, cuts: Sequence[int], noise: float = 1.0
                   ) -> torch.Tensor:
    """(frames, height, width) uint8 luma on the device: a coarse random
    16-pixel grid a shot, hard cuts at ``cuts``, Gaussian noise a frame."""
    g = torch_gen(seed, device, "luma", tag)
    cell = 16
    gh, gw = -(-height // cell), -(-width // cell)
    grid = torch.randint(0, 256, (len(cuts) + 1, gh, gw), generator=g,
                         device=device).to(torch.float32)
    base = grid.repeat_interleave(cell, 1).repeat_interleave(cell, 2)
    base = base[:, :height, :width]
    shot = torch.bucketize(torch.arange(frames, device=device),
                           torch.tensor(list(cuts), device=device,
                                        dtype=torch.int64), right=True)
    x = base[shot] + noise * torch.randn((frames, height, width), generator=g,
                                         device=device)
    return x.clamp(0, 255).to(torch.uint8)


def y4m_bytes(luma: np.ndarray, fps: int) -> bytes:
    """(T, H, W) uint8 luma as a C420 YUV4MPEG2 file at ``fps`` frames/s."""
    t, h, w = luma.shape
    y, c = h * w, (h // 2) * (w // 2)
    rec = np.empty((t, 6 + y + 2 * c), np.uint8)
    rec[:, :6] = np.frombuffer(b"FRAME\n", np.uint8)
    rec[:, 6:6 + y] = luma.reshape(t, y)
    rec[:, 6 + y:] = 128
    header = f"YUV4MPEG2 W{w} H{h} F{fps}:1 Ip A1:1 C420jpeg\n".encode()
    return header + rec.tobytes()
