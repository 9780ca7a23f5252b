"""A run with the timed path broken underneath comes out as not correct:
once for each fault a cell can have. (Neither cell exchanges anything
between chips: each runs on one.)"""

import numpy as np
import pytest
import torch

from perfbench import core
from perfbench.probes import wrap
from perfbench.tests.tiny import tiny_root
from tvidz_tpu_torch.corpus.device_corpus import DeviceCorpus


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(str(tmp_path_factory.mktemp("tiny")))


def run(root, cell, hooks=()):
    return core.run_cell(cell, 424242, 3, False, device="cpu", root=root,
                         hooks=hooks, say=lambda *a, **k: None)


def corpus_keeps_its_state(monkeypatch):
    """Appending a video's rows leaves the corpus unchanged, for every video
    the analyzer appends (the catalog still loads)."""
    orig = DeviceCorpus.append_fingerprints

    def append(self, video_id, fps):
        if video_id <= 16:                       # the tiny catalog's videos
            return orig(self, video_id, fps)

    monkeypatch.setattr(DeviceCorpus, "append_fingerprints", append)
    return ()


def scan_half_the_queries(monkeypatch):
    """The nearest-row scan answers the first half of its queries and
    repeats those answers for the rest."""
    orig = DeviceCorpus._query_nearest

    def scan(self, q, fp_dev):
        half = max(1, q.shape[0] // 2)
        q_min, q_arg = orig(self, np.ascontiguousarray(q[:half]), fp_dev)
        idx = torch.arange(q.shape[0]) % half
        return q_min[idx], q_arg[idx]

    monkeypatch.setattr(DeviceCorpus, "_query_nearest", scan)
    return ()


def flip_a_hash_bit(monkeypatch):
    """Every hash the fingerprint pass produces has its last bit flipped."""
    def hook(kind):
        def make(orig):
            def f(lumas, carries, valid_ts):
                scores, fps, new = orig(lumas, carries, valid_ts)
                return scores, fps ^ 1, new
            return f
        wrap(kind.dep.app.analyzer._model, "forward_streams", make)
    return (hook,)


def align_half_the_videos(monkeypatch):
    """Each bucket's alignment scan reads only the first half of its
    videos."""
    def hook(kind):
        def make(orig):
            def f(q, q_lens, al_dev, len_dev, thr):
                live = int((len_dev > 0).sum())
                cut = len_dev.clone()
                cut[live // 2:] = 0
                return orig(q, q_lens, al_dev, cut, thr)
            return f
        wrap(kind.dep.app.corpus, "_fragment_query", make)
    return (hook,)


def shift_an_offset(monkeypatch):
    """Every located fragment's offset comes out one frame late."""
    def hook(kind):
        def make(orig):
            def f(*a, **k):
                return [[(v, o + 1, s) for v, o, s in hits] for hits in orig(*a, **k)]
            return f
        wrap(kind.dep.app.corpus, "locate_fragments", make)
    return (hook,)


@pytest.mark.parametrize("cell,fault", [
    ("upload-phash64", corpus_keeps_its_state),
    ("upload-phash64", scan_half_the_queries),
    ("upload-phash64", flip_a_hash_bit),
    ("fragsearch-phash256", align_half_the_videos),
    ("fragsearch-phash256", shift_an_offset),
], ids=lambda x: getattr(x, "__name__", x))
def test_fault_is_not_correct(root, monkeypatch, cell, fault):
    line = run(root, cell, fault(monkeypatch))
    assert line["correct"] is False and line["failed"] == 0
    assert any(c["value"] > c["limit"] for c in line["checks"].values())
