"""Port parity: DeviceCorpus host mirrors and fingerprint verdicts.

The same inserts, removals (sentinel overwrite) and compaction go through
the JAX DeviceCorpus and the port's; host mirrors, sync accounting and
``nearest_video_counts`` / ``search_fingerprints`` must be equal, and a port
corpus built from the JAX mirrors (state.device_corpus_from_reference)
answers the same.
"""

import numpy as np
import pytest

from tvidz_tpu.corpus.device_corpus import DeviceCorpus as JaxCorpus
from tvidz_tpu_torch import state
from tvidz_tpu_torch.corpus.device_corpus import DeviceCorpus

KW = dict(fp_initial_capacity=512, fp_block_n=256, ts_initial_capacity=8)


def _videos():
    rng = np.random.default_rng(17)
    return {v: rng.integers(0, 2 ** 32, size=(n, 2), dtype=np.uint32)
            for v, n in ((1, 300), (2, 700), (3, 450), (4, 900), (5, 80))}


def _queries(vids):
    rng = np.random.default_rng(4)
    q = [vids[1][10:30], vids[4][:15].copy(), vids[2][100:103],
         rng.integers(0, 2 ** 32, size=(13, 2), dtype=np.uint32)]
    q[1][:, 0] ^= np.uint32(0b1011)                # 3 bits from video 4
    q.append(np.full((5, 2), 0xFFFFFFFF, np.uint32))   # nearest: sentinels
    return q


def _mirrors_equal(tc, jc):
    for k in ("_fp", "_fp_vid", "_ts", "_ts_len", "_ts_vid"):
        np.testing.assert_array_equal(getattr(tc, k), getattr(jc, k), err_msg=k)
    for k in ("_fp_count", "_fp_cap", "_fp_tombstones", "_ts_count"):
        assert getattr(tc, k) == getattr(jc, k), k


def _answers_equal(tc, jc, queries):
    for q in queries:
        for excl in (None, 1, 4):
            assert (tc.nearest_video_counts(q, exclude_video_id=excl)
                    == jc.nearest_video_counts(q, exclude_video_id=excl))
            assert (tc.search_fingerprints(q, min_match=1, exclude_video_id=excl)
                    == jc.search_fingerprints(q, min_match=1,
                                              exclude_video_id=excl))


@pytest.mark.parametrize("removals", [(), (2,), (2, 4, 3)],
                         ids=["inserts", "tombstone", "compaction"])
def test_same_updates_same_state_and_answers(removals):
    vids = _videos()
    jc, tc = JaxCorpus(**KW), DeviceCorpus(device="cpu", **KW)
    queries = _queries(vids)
    for v, fp in vids.items():
        for c in (jc, tc):
            c.append_fingerprints(v, fp)
            c.upsert_timestamps(v, [0.04 * v, 1.0 + v])
    _answers_equal(tc, jc, queries)           # a first sync, then incremental
    for v in removals:
        jc.remove_video(v)
        tc.remove_video(v)
    extra = np.random.default_rng(8).integers(0, 2 ** 32, size=(60, 2),
                                              dtype=np.uint32)
    for c in (jc, tc):
        c.append_fingerprints(6, extra)
    _mirrors_equal(tc, jc)
    _answers_equal(tc, jc, queries)
    assert tc.sync_bytes == jc.sync_bytes
    if len(removals) == 3:
        # Removing 4 pushed the tombstones (1600) past half the rows: the
        # rows of 2 and 4 were compacted away; 3's 450 remain tombstoned.
        assert tc._fp_tombstones == 450 and tc._fp_count == 300 + 450 + 80 + 60
    assert tc.device_footprint == jc.device_footprint
    loaded = state.device_corpus_from_reference(
        state.reference_host_mirrors(jc), device="cpu", fp_block_n=256)
    _answers_equal(loaded, jc, queries)


def test_sentinel_overwrite_keeps_a_live_duplicate_visible():
    """A removed video's frames become sentinels, so a live copy of them
    wins the argmin (the reference's ADVICE r2 fix)."""
    fp = _videos()[1]
    for c in (JaxCorpus(**KW), DeviceCorpus(device="cpu", **KW)):
        c.append_fingerprints(1, fp)
        c.append_fingerprints(2, fp)
        c.remove_video(1)
        assert c.nearest_video_counts(fp[:40]) == {2: 40}


def test_load_from_store_matches(tmp_path):
    from tvidz_tpu.corpus.store import Store

    store = Store(f"sqlite:///{tmp_path / 's.db'}")
    for v, fp in _videos().items():
        vid = store.add_video(f"v{v}.mp4").id
        store.add_fingerprints(vid, fp)
        store.add_timestamps(vid, [0.5 * v, 2.0])
    jc, tc = JaxCorpus(**KW), DeviceCorpus(device="cpu", **KW)
    jc.load(store)
    tc.load(store)
    _mirrors_equal(tc, jc)
    _answers_equal(tc, jc, _queries(_videos()))
    assert tc.match_timestamps([2.0, 1.0]) == jc.match_timestamps([2.0, 1.0])
    frag = _videos()[4][200:240]
    assert tc.locate_fragment(frag) == jc.locate_fragment(frag)
    assert tc.locate_fragment(frag)[0][:2] == (4, 200)
