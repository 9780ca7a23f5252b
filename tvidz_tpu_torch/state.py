"""Carrying state across from the JAX package.

tvidz has no learned weights: its state is the scene carry of a stream and
the corpus. These build the port's counterparts from the reference's numpy
values, so both packages can compute on identical state (the parity tests
do).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from tvidz_tpu_torch.corpus.device_corpus import DeviceCorpus
from tvidz_tpu_torch.ops.fused import FingerprintCarry
from tvidz_tpu_torch.ops.scene import SceneCarry

# The JAX DeviceCorpus's host mirrors and counters that define its content.
HOST_MIRROR_ARRAYS = ("_ts", "_ts_len", "_ts_vid", "_fp", "_fp_vid")
HOST_MIRROR_COUNTS = ("_ts_count", "_fp_count", "_fp_tombstones")


def fingerprint_carry_from_numpy(prev_frame, prev_mafd, has_prev,
                                 device) -> FingerprintCarry:
    """A port carry from the reference carry's values (numpy or scalars)."""
    return FingerprintCarry(scene=SceneCarry(
        prev_frame=torch.tensor(np.asarray(prev_frame, np.float32),
                                device=device),
        prev_mafd=torch.tensor(float(np.asarray(prev_mafd)),
                               dtype=torch.float32, device=device),
        has_prev=torch.tensor(bool(np.asarray(has_prev)), dtype=torch.bool,
                              device=device),
    ))


def reference_host_mirrors(corpus) -> Dict[str, object]:
    """The HOST_MIRROR_* fields of a reference DeviceCorpus, copied."""
    out: Dict[str, object] = {k: np.array(getattr(corpus, k))
                              for k in HOST_MIRROR_ARRAYS}
    out.update({k: int(getattr(corpus, k)) for k in HOST_MIRROR_COUNTS})
    out["_ts_free"] = list(corpus._ts_free)
    return out


def device_corpus_from_reference(host_mirrors: Dict[str, object],
                                 device=None, **corpus_kwargs) -> DeviceCorpus:
    """A port DeviceCorpus holding the given reference host mirrors
    (``_ts``, ``_ts_len``, ``_ts_vid``, ``_fp``, ``_fp_vid`` and the counts;
    ``_ts_free`` when given, else rebuilt from the tombstoned rows in row
    order). The alignment-bucket mirror is not carried: such a corpus
    locates no fragment until videos are appended to it."""
    ts = np.array(host_mirrors["_ts"], np.float32)
    fp = np.array(host_mirrors["_fp"], np.uint32)
    words = fp.shape[1]
    corpus = DeviceCorpus(max_cuts=ts.shape[1], words=words, device=device,
                          **corpus_kwargs)
    ts_count = int(host_mirrors["_ts_count"])
    corpus._ts = ts
    corpus._ts_len = np.array(host_mirrors["_ts_len"], np.int32)
    corpus._ts_vid = np.array(host_mirrors["_ts_vid"], np.int32)
    corpus._ts_cap = ts.shape[0]
    corpus._ts_count = ts_count
    live = corpus._ts_vid[:ts_count]
    corpus._vid_to_row = {int(v): r for r, v in enumerate(live) if v >= 0}
    corpus._ts_free = list(host_mirrors.get(
        "_ts_free", [r for r, v in enumerate(live) if v < 0]))
    corpus._fp = fp
    corpus._fp_vid = np.array(host_mirrors["_fp_vid"], np.int32)
    corpus._fp_cap = fp.shape[0]
    corpus._fp_count = int(host_mirrors["_fp_count"])
    corpus._fp_tombstones = int(host_mirrors.get("_fp_tombstones", 0))
    corpus._ts_full_resync = corpus._fp_full_resync = True
    return corpus
