"""The analyzer's verdict rule, applied to the reference's own answers.

An upload is read in blocks of ``block`` frames. After each block: if the
block holds a new scene cut, every cut so far is matched against the
catalog's timestamps, and videos sharing ``min_match`` or more are the
verdict; otherwise each of the block's frames credits the video of its
nearest catalog row, if within the threshold, and the first videos whose
credit reaches ``fp_min_match`` are the verdict (credit accumulates over
blocks). The first verdict ends the upload (early exit): its cuts and
frames are those of the blocks read so far.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

from perfbench.reference import search


def replay(cut_frames: Sequence[int], fps: float, frames: int, block: int,
           dist: np.ndarray, row: np.ndarray, row_video: np.ndarray,
           ts_matches: Callable[[List[float]], List[Tuple[int, int]]],
           threshold: int, fp_min_match: int
           ) -> Tuple[List[int], List[float], int]:
    """(verdict video ids, cut timestamps, frames read) of one upload whose
    frames' nearest catalog rows are ``dist``/``row``."""
    cuts: List[float] = []
    credit: Dict[int, int] = {}
    for start in range(0, frames, block):
        end = min(frames, start + block)
        new = [round(f / fps, 6) for f in cut_frames if start <= f < end]
        cuts += new
        if new:
            hits = ts_matches(list(cuts))
            if hits:
                return sorted(v for v, _ in hits), cuts, end
        for v, c in search.evidence(dist[start:end], row[start:end],
                                    row_video, threshold, None).items():
            credit[v] = credit.get(v, 0) + c
        strong = sorted(v for v, c in credit.items() if c >= fp_min_match)
        if strong:
            return strong, cuts, end
    return [], cuts, frames
