"""Port parity for the slice as a whole: both packages' Analyzers run the
same three synthetic uploads — an original, a renamed copy, a fresh video —
through decode, the fingerprint block, the corpus and the verdicts. Cuts
and verdicts must be identical; stored hashes within 2 bits per frame.
With native-resolution scoring off, the fingerprint block's own scores
decide the cuts."""

import os
import shutil

import numpy as np
import pytest

from tvidz_tpu.config import Config
from tvidz_tpu.corpus.device_corpus import DeviceCorpus as JaxCorpus
from tvidz_tpu.corpus.store import Store
from tvidz_tpu.decode import write_synthetic_y4m
from tvidz_tpu.decode.synthetic import synthetic_video
from tvidz_tpu.models.fingerprint import FingerprintModel as JaxModel
from tvidz_tpu.pipeline.analyzer import Analyzer as JaxAnalyzer
from tvidz_tpu.pipeline.progress import AnalysisRegistry
from tvidz_tpu_torch.corpus.device_corpus import DeviceCorpus
from tvidz_tpu_torch.models.fingerprint import FingerprintModel
from tvidz_tpu_torch.pipeline.analyzer import Analyzer

UPLOADS = ["orig.y4m", "1234567890-orig.y4m", "fresh.y4m"]


def _analyzer(pkg, tmp_path, native):
    cfg = Config()
    cfg.pipeline.block_frames = 16
    cfg.pipeline.scene_height = 36
    cfg.pipeline.scene_width = 64
    cfg.pipeline.tmp_dir = str(tmp_path / f"work_{pkg}")
    cfg.pipeline.download_retry_wait_s = 0.01
    cfg.scene.native_resolution = native
    os.makedirs(cfg.pipeline.tmp_dir)
    bucket = tmp_path / "bucket"

    def fetcher(_bucket, key, local_path):
        shutil.copy(bucket / key, local_path)

    store = Store("sqlite:///:memory:")
    kw = dict(max_cuts=cfg.match.max_cuts, ts_initial_capacity=8,
              fp_initial_capacity=512, fp_block_n=256)
    if pkg == "jax":
        return JaxAnalyzer(store, JaxCorpus(**kw), AnalysisRegistry(),
                           fetcher, cfg), store
    return Analyzer(store, DeviceCorpus(device="cpu", **kw),
                    AnalysisRegistry(), fetcher, cfg), store


@pytest.mark.parametrize("native", [True, False],
                         ids=["native_mafd_cuts", "device_score_cuts"])
def test_both_analyzers_agree(tmp_path, native):
    bucket = tmp_path / "bucket"
    os.makedirs(bucket)
    _, planted = write_synthetic_y4m(str(bucket / "orig.y4m"), num_frames=72,
                                     height=72, width=128, cut_frames=(21, 50),
                                     seed=3)
    shutil.copy(bucket / "orig.y4m", bucket / UPLOADS[1])
    _, planted_fresh = write_synthetic_y4m(
        str(bucket / "fresh.y4m"), num_frames=60, height=72, width=128,
        cut_frames=(13, 37), seed=8)
    runs = {pkg: _analyzer(pkg, tmp_path, native) for pkg in ("jax", "torch")}
    results = {pkg: [a.analyze("videos", key) for key in UPLOADS]
               for pkg, (a, _) in runs.items()}
    for rj, rt in zip(results["jax"], results["torch"]):
        assert rt.status == rj.status == "done"
        assert rt.scene_cuts == rj.scene_cuts
        assert rt.duplicates == rj.duplicates
        fj = runs["jax"][1].get_fingerprints(rj.video_id)
        ft = runs["torch"][1].get_fingerprints(rt.video_id)
        assert ft.shape == fj.shape
        bits = np.unpackbits((ft ^ fj).view(np.uint8), axis=-1).sum(-1)
        assert bits.max() <= 2
    orig, copy, fresh = results["torch"]
    assert orig.scene_cuts == planted and orig.duplicates == []
    assert copy.duplicates == ["orig.y4m"]
    assert fresh.scene_cuts == planted_fresh and fresh.duplicates == []


@pytest.mark.parametrize("surface", ["analyze_array", "analyze_path"])
def test_model_surfaces_agree(tmp_path, surface):
    """FingerprintModel.analyze_array (device scores decide the cuts) and
    analyze_path (native-resolution mafd) match the JAX model."""
    cfg = Config()
    cfg.pipeline.block_frames = 16
    cfg.pipeline.scene_height = 36
    cfg.pipeline.scene_width = 64
    if surface == "analyze_array":
        luma, _ = synthetic_video(70, 36, 64, cut_frames=(9, 40), seed=6)
        args = (luma, np.arange(70) / 25.0)
    else:
        path = str(tmp_path / "clip.y4m")
        write_synthetic_y4m(path, num_frames=70, height=72, width=128,
                            cut_frames=(9, 40), seed=6)
        args = (path,)
    jcuts, jfps = getattr(JaxModel(cfg), surface)(*args)
    tcuts, tfps = getattr(FingerprintModel(cfg, device="cpu"), surface)(*args)
    assert tcuts == jcuts == [0.36, 1.6]
    assert tfps.dtype == np.uint32 and tfps.shape == jfps.shape == (70, 2)
    assert np.unpackbits((tfps ^ jfps).view(np.uint8), axis=-1).sum(-1).max() <= 2
