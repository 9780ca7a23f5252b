"""The spans of the hash-family path (``tvidz_tpu_torch/utils/timing.py``):
``fingerprint.family`` around the family pass, with its algorithm, frames
and words, and the row width on ``corpus.k4``; recorded while a
``torch.profiler`` session records, absent from the ring when none does
(the span table still counts them)."""

import time

import numpy as np
import pytest
import torch

from tvidz_tpu_torch.config import Config
from tvidz_tpu_torch.corpus.device_corpus import DeviceCorpus
from tvidz_tpu_torch.models.fingerprint import FingerprintModel
from tvidz_tpu_torch.ops import fused
from tvidz_tpu_torch.utils import timing


def profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU])


def since(t0, name):
    return [r for r in timing.TRACER.finished()
            if r.t0 >= t0 and r.name == name]


def table_count(name):
    return timing.TRACER.summary().get(name, {}).get("count", 0)


def _model(algorithm):
    cfg = Config()
    cfg.hash.algorithm = algorithm
    cfg.pipeline.block_frames = 16
    cfg.pipeline.scene_height, cfg.pipeline.scene_width = 36, 64
    return FingerprintModel(cfg, device="cpu")


def _streams(model, k):
    g = torch.Generator().manual_seed(k)
    lumas = [torch.randint(0, 256, (16, 36, 64), generator=g, dtype=torch.uint8)
             for _ in range(k)]
    return lumas, [model.init_carry() for _ in range(k)]


@pytest.mark.parametrize("algorithm,words", [("phash256", 8), ("ahash", 2),
                                             ("dhash", 2)])
def test_family_pass_span_under_the_profiler(algorithm, words):
    model = _model(algorithm)
    lumas, carries = _streams(model, 3)
    t0 = time.perf_counter()
    with profiler():
        _, fps, _ = model.forward_streams(lumas, carries, [16, 9, 1])
    (rec,) = since(t0, "fingerprint.family")
    assert rec.attrs == {"algorithm": algorithm, "frames": 48, "words": words}
    assert fps.shape[-1] == words and rec.seconds >= 0


def test_lone_family_block_span():
    model = _model("phash256")
    lumas, carries = _streams(model, 1)
    t0 = time.perf_counter()
    with profiler():
        model.forward(lumas[0], carries[0], valid_t=7)
    (rec,) = since(t0, "fingerprint.family")
    assert rec.attrs == {"algorithm": "phash256", "frames": 16, "words": 8}


def test_family_span_off_leaves_no_record():
    model = _model("phash256")
    lumas, carries = _streams(model, 2)
    assert not timing.tracing()
    before = table_count("fingerprint.family")
    t0 = time.perf_counter()
    model.forward_streams(lumas, carries, [16, 16])
    assert since(t0, "fingerprint.family") == []
    assert table_count("fingerprint.family") == before + 1


def test_k1_configuration_has_no_family_span():
    model = _model("phash")
    assert model.k1
    lumas, carries = _streams(model, 2)
    t0 = time.perf_counter()
    with profiler():
        fused.fingerprint_blocks_batched(lumas, carries, [16, 16],
                                         model.left, model.right)
    assert since(t0, "fingerprint.family") == []


@pytest.mark.parametrize("words", [2, 8])
def test_corpus_k4_span_carries_the_row_width(words):
    corpus = DeviceCorpus(words=words, device="cpu", fp_initial_capacity=256)
    rng = np.random.default_rng(words)
    rows = rng.integers(0, 1 << 32, (40, words), dtype=np.uint32)
    corpus.append_fingerprints(7, rows)
    t0 = time.perf_counter()
    assert corpus.nearest_video_counts(rows[:5]) == {7: 5}
    assert since(t0, "corpus.k4") == []
    with profiler():
        assert corpus.nearest_video_counts(rows[5:12]) == {7: 7}
    (rec,) = since(t0, "corpus.k4")
    assert rec.attrs == {"words": words}
