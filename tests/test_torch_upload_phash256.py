"""The 256-bit deployment's upload path (``TVIDZ_HASH_ALGO=phash256``) on the
CPU, against the benchmark's plain reference (``perfbench/reference``):

- the reference's DCT pHash at (32, 8) is ``video.phash``, bit for bit;
- the dispatcher's family pass over K = 3 streams of uneven ``valid_t``,
  decoded from 180x320 Y4M to 90x160, against the reference's 256-bit hash
  of the same frames, and the reference's TF32 control outside that
  tolerance;
- an upload and its renamed re-upload through the service against a
  2^12-row 8-word corpus: verdicts, cuts, every nearest-row answer (least
  distance, first row), evidence count and timestamp match equal to the
  reference's replay and search.
"""

import json

import numpy as np
import pytest
import torch

from perfbench import data
from perfbench.deploy import Deployment, make_config
from perfbench.reference import dct_hash, replay, search, video
from tvidz_tpu_torch.config import Config
from tvidz_tpu_torch.decode.y4m import Y4MDecoder
from tvidz_tpu_torch.models.fingerprint import FingerprintModel

FPS = 25
# At most 1 bit in 50,000 of the family pass may differ from the reference:
# the program folds its resize and DCT operators from the golden float32
# matrices and the reference from float64 ones, and each sums in its own
# order, so a coefficient within float32 rounding of its block's median can
# land on either side of it (here none does). TF32 moves coefficients by
# ~1e-3 relative: over these 12 seeds' 700,416 bits its hash differs from
# the pass's in 54 (7.7 in 100,000).
BITS_TOLERANCE = 1 / 50_000


def _bits(a: np.ndarray, b: np.ndarray) -> int:
    return int(np.unpackbits(np.bitwise_xor(a, b).view(np.uint8)).sum())


@pytest.mark.parametrize("tf32", [False, True])
@pytest.mark.parametrize("shape", [(90, 160), (72, 96), (33, 47)])
def test_reference_at_32_8_is_video_phash(shape, tf32):
    g = torch.Generator().manual_seed(20 + shape[0])
    luma = torch.randint(0, 256, (24, *shape), generator=g, dtype=torch.uint8)
    luma[12:] = (luma[12:].float() * 0.1 + 100).to(torch.uint8)   # flat frames
    got = dct_hash.phash(luma, 32, 8, tf32=tf32)
    assert got.dtype == np.uint32 and got.shape == (24, 2)
    assert np.array_equal(got, video.phash(luma, tf32=tf32))


def test_reference_keeps_keep_squared_bits():
    luma = torch.randint(0, 256, (5, 90, 160), dtype=torch.uint8)
    words = dct_hash.phash(luma, 64, 16)
    assert words.shape == (5, 8)
    ones = np.unpackbits(words.view(np.uint8), axis=1).sum(1)
    assert (ones <= 128).all()          # strictly above the median
    with pytest.raises(ValueError):
        dct_hash.phash(luma, 8, 16)


def _decoded(tmp_path, seed, k, frames):
    """A 180x320 Y4M stream's first block decoded at 90x160 by the program's
    Y4M decoder; also the reference's own 2x2 downscale of its pixels."""
    full = data.synthetic_luma(seed, "cpu", ("stream", k), frames, 180, 320,
                               [frames // 2])
    path = tmp_path / f"s{seed}_{k}.y4m"
    path.write_bytes(data.y4m_bytes(full.numpy(), FPS))
    block = next(iter(Y4MDecoder().blocks(str(path), 128, 90, 160)))
    return np.asarray(block.luma), video.downscale(full, 90, 160).numpy()


def test_family_pass_in_the_dispatchers_form(tmp_path, monkeypatch):
    monkeypatch.setenv("TVIDZ_HASH_ALGO", "phash256")
    model = FingerprintModel(Config(), device="cpu")
    assert model.words == 8 and not model.k1
    lens = [128, 77, 23]
    diff = control = bits = 0
    for seed in range(12):
        lumas, want, want_tf32 = [], [], []
        for k, n in enumerate(lens):
            luma, ref_small = _decoded(tmp_path, seed, k, n)
            assert np.array_equal(luma, ref_small)
            want.append(dct_hash.phash(torch.from_numpy(luma), 64, 16))
            want_tf32.append(dct_hash.phash(torch.from_numpy(luma), 64, 16,
                                            tf32=True))
            pad = np.concatenate([luma, np.repeat(luma[-1:], 128 - n, 0)])
            lumas.append(torch.from_numpy(pad))
        carries = [model.init_carry() for _ in lens]
        scores, fps, new = model.forward_streams(lumas, carries, lens)
        assert tuple(fps.shape) == (3, 128, 8) and len(new) == 3
        assert fps.dtype == torch.int32 and tuple(scores.shape) == (3, 128)
        for k, n in enumerate(lens):
            got = fps[k, :n].numpy().view(np.uint32)
            diff += _bits(got, want[k])
            control += _bits(got, want_tf32[k])
            bits += 256 * n
    assert diff <= BITS_TOLERANCE * bits, (diff, bits)
    assert control > BITS_TOLERANCE * bits, (control, bits)


# -- the service -----------------------------------------------------------------


class _Recorded:
    """The corpus's nearest-row queries and timestamp matches, as the
    benchmark's seams record them."""

    def __init__(self, corpus):
        self.nearest, self.ts = [], []
        self.corpus = corpus
        query_nearest = corpus._query_nearest
        counts = corpus.nearest_video_counts
        match = corpus.match_timestamps

        def qn(q, fp_dev):
            self.out = query_nearest(q, fp_dev)
            return self.out

        def nvc(query, exclude_video_id=None):
            rows = corpus._fp[:corpus._fp_count].copy()
            vids = corpus._fp_vid[:corpus._fp_count].copy()
            self.out = None
            got = counts(query, exclude_video_id=exclude_video_id)
            if self.out is not None:
                m = query.shape[0]
                self.nearest.append(dict(
                    query=np.array(query, np.uint32), exclude=exclude_video_id,
                    rows=rows, vids=vids, result=dict(got),
                    out=tuple(x[:m].numpy() for x in self.out)))
            return got

        def mt(query_ts, min_match=2, tolerance=0.0, exclude_video_id=None):
            got = match(query_ts, min_match=min_match, tolerance=tolerance,
                        exclude_video_id=exclude_video_id)
            self.ts.append(dict(query=list(query_ts), exclude=exclude_video_id,
                                result=sorted(got)))
            return got

        corpus._query_nearest = qn
        corpus.nearest_video_counts = nvc
        corpus.match_timestamps = mt


def _verdict(dep, key, payload):
    dep.s3.put_object(dep.bucket, key, payload)
    for chunk in dep.client.stream(f"/status/stream/{key}"):
        state = json.loads(chunk.decode()[len("data: "):])
        if state.get("status") in ("done", "error"):
            return state
    raise AssertionError(f"no verdict for {key}")


def test_upload_and_renamed_reupload_through_the_service(tmp_path, monkeypatch):
    monkeypatch.setenv("TVIDZ_HASH_ALGO", "phash256")
    work = tmp_path / "work"
    work.mkdir()
    cfg = make_config({"service": {"sse_poll_s": 0.02,
                                   "sqs_idle_sleep_s": 0.05}}, str(work))
    assert cfg.hash.algorithm == "phash256" and cfg.hash.words == 8
    m, seed = cfg.match, 2 ** 33 + 20
    rows, starts = data.catalog(seed, "cpu", 16, 256, 8, [80, 300], 6)
    cat_ts = data.shot_timestamps(starts, 30000, 1001)
    dep = Deployment(cfg, "cpu", str(work))
    names = [f"catalog-{i:02d}.mp4" for i in range(16)]
    vids = dep.store_videos(names)
    dep.boot()
    dep.load_catalog(vids, rows, cat_ts)
    assert dep.app.corpus.num_fingerprints == 1 << 12
    rec = _Recorded(dep.app.corpus)
    dep.notify_on_put()
    dep.app.start_poller()
    try:
        full = data.synthetic_luma(seed, "cpu", "clip", 300, 180, 320, [90, 200])
        payload = data.y4m_bytes(full.numpy(), FPS)
        first = _verdict(dep, "1700000000000-clip.y4m", payload)
        again = _verdict(dep, "1700000000001-renamed.y4m", payload)
    finally:
        dep.stop()
    assert first["status"] == again["status"] == "done"
    vid1 = dep.store.get_video_by_filename("clip.y4m").id

    # The reference's replay of both verdicts on its own hashes and cuts.
    hashes = dct_hash.phash(video.downscale(full, 90, 160), 64, 16)
    cuts = video.cut_frames(video.mafd(full), cfg.scene.threshold)
    cat_flat, cat_vid = rows.reshape(-1, 8), np.repeat(np.asarray(vids), 256)
    known_ts = list(zip(vids, cat_ts))

    def expect(known_rows, known_vid, exclude):
        d, r = search.nearest(hashes, known_rows, "cpu")
        return replay.replay(
            cuts, FPS, 300, cfg.pipeline.block_frames, d, r, known_vid,
            lambda q: search.timestamp_matches(q, known_ts, m.min_match,
                                               exclude, m.max_cuts),
            m.hamming_threshold, m.fp_min_match)

    dups, want_cuts, read = expect(cat_flat, cat_vid, vid1)
    assert dups == [] and first["duplicates"] == []
    assert [float(x) for x in first["scene_cuts"]] == want_cuts
    assert read == 300
    known_ts.append((vid1, want_cuts))
    dups, want_cuts, read = expect(
        np.concatenate([cat_flat, hashes]),
        np.concatenate([cat_vid, np.full(300, vid1)]), None)
    assert dups == [vid1] and again["duplicates"] == ["clip.y4m"]
    assert [float(x) for x in again["scene_cuts"]] == want_cuts

    # Every nearest-row answer and its evidence, on the program's own
    # queries against the rows present when it ran.
    assert len(rec.nearest) >= 4
    for c in rec.nearest:
        d, r = search.nearest(c["query"], c["rows"], "cpu")
        assert np.array_equal(c["out"][0], d) and np.array_equal(c["out"][1], r)
        assert c["result"] == search.evidence(d, r, c["vids"],
                                              m.hamming_threshold, c["exclude"])
    assert any(c["result"] == {vid1: c["query"].shape[0]} for c in rec.nearest)
    assert rec.ts
    for c in rec.ts:
        assert c["result"] == search.timestamp_matches(
            c["query"], known_ts, m.min_match, c["exclude"], m.max_cuts)
