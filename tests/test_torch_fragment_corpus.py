"""Port parity: DeviceCorpus fragment search (the alignment side).

The same appends, streamed block appends (bucket migration), removals (free
list reuse) and queries go through the JAX DeviceCorpus (its XLA fragment
scan on the CPU) and the port's; ``locate_fragment`` / ``locate_fragments``
answers, the alignment host mirrors, the device footprint and the
``sync_bytes["al"]`` accounting must be equal.
"""

import threading

import numpy as np
import pytest

from tvidz_tpu.corpus.device_corpus import DeviceCorpus as JaxCorpus
from tvidz_tpu_torch.corpus.device_corpus import DeviceCorpus

KW = dict(fp_initial_capacity=512, fp_block_n=256, ts_initial_capacity=8)


def _videos():
    rng = np.random.default_rng(23)
    return {v: rng.integers(0, 2 ** 32, size=(n, 2), dtype=np.uint32)
            for v, n in ((1, 200), (2, 300), (3, 120), (4, 700), (5, 60))}


def _queries(vids):
    rng = np.random.default_rng(5)
    damaged = vids[4][300:380].copy()
    damaged[::3, 0] ^= np.uint32(0b1101)
    return [vids[1][50:90], damaged, vids[2][250:300], vids[5][:60],
            np.concatenate([vids[3][100:120], vids[1][:30]]),
            rng.integers(0, 2 ** 32, size=(33, 2), dtype=np.uint32)]


def _pair():
    return JaxCorpus(**KW), DeviceCorpus(device="cpu", **KW)


def _append_all(cs, vids):
    for v, fp in vids.items():
        for c in cs:
            c.append_fingerprints(v, fp)


def _same_answers(tc, jc, queries, **kw):
    for q in queries:
        for excl in (None, 1, 4):
            want = jc.locate_fragment(q, exclude_video_id=excl, **kw)
            assert tc.locate_fragment(q, exclude_video_id=excl, **kw) == want
    excl = [None, 4, 2, None, 3, 1][:len(queries)]
    want = jc.locate_fragments(queries, exclude_video_ids=excl, **kw)
    assert tc.locate_fragments(queries, exclude_video_ids=excl, **kw) == want


def _same_state(tc, jc):
    assert tc._al_row == jc._al_row
    assert len(tc._al_buckets) == len(jc._al_buckets)
    for tb, jb in zip(tc._al_buckets, jc._al_buckets):
        assert (tb is None) == (jb is None)
        if tb is None:
            continue
        np.testing.assert_array_equal(tb.buf, jb.buf)
        np.testing.assert_array_equal(tb.len, jb.len)
        np.testing.assert_array_equal(tb.vid, jb.vid)
        assert (tb.count, tb.vcap, tb.free) == (jb.count, jb.vcap, jb.free)
    assert tc.device_footprint == jc.device_footprint


@pytest.mark.parametrize("kw", [{}, {"top_k": 2}, {"hamming_threshold": 0},
                                {"hamming_threshold": 14, "top_k": 10}],
                         ids=["default", "top2", "thr0", "thr14"])
def test_locate_fragment_matches_jax(kw):
    vids = _videos()
    jc, tc = _pair()
    _append_all((jc, tc), vids)
    _same_answers(tc, jc, _queries(vids), **kw)
    _same_state(tc, jc)
    hits = tc.locate_fragment(vids[4][300:380])
    assert hits[0] == (4, 300, 80)


def test_streamed_appends_migrate_buckets():
    """A video streamed in 128-frame blocks outgrows bucket 0 (256 frames)
    and bucket 1 (512): each migration tombstones its old row onto the
    bucket's free list, the next video reuses it, and answers stay equal."""
    vids = _videos()
    jc, tc = _pair()
    _append_all((jc, tc), {v: vids[v] for v in (1, 3)})
    stream = np.random.default_rng(9).integers(0, 2 ** 32, size=(640, 2),
                                                dtype=np.uint32)
    for s in range(0, 640, 128):
        for c in (jc, tc):
            c.append_fingerprints(7, stream[s:s + 128])
        _same_answers(tc, jc, [stream[max(0, s - 40):s + 60], vids[1][:70]])
        _same_state(tc, jc)
    assert tc._al_row[7][0] == 2                 # 640 frames: bucket 2
    assert tc._al_buckets[0].free and tc._al_buckets[1].free
    for c in (jc, tc):
        c.append_fingerprints(8, vids[5])        # reuses bucket 0's free row
    _same_state(tc, jc)
    hits = tc.locate_fragment(stream[500:600])
    assert hits == jc.locate_fragment(stream[500:600])
    assert hits[0] == (7, 500, 100)
    assert tc.sync_bytes == jc.sync_bytes


def test_removal_churn_reuses_free_rows():
    vids = _videos()
    jc, tc = _pair()
    _append_all((jc, tc), vids)
    queries = _queries(vids)
    _same_answers(tc, jc, queries)
    for cycle in range(3):
        for c in (jc, tc):
            c.remove_video(2)
            c.remove_video(5)
        _same_answers(tc, jc, queries)
        _same_state(tc, jc)
        for c in (jc, tc):
            c.append_fingerprints(2, vids[2])
            c.append_fingerprints(5, vids[5])
        _same_answers(tc, jc, queries)
        _same_state(tc, jc)
    # Re-uploads reuse the tombstoned rows: no bucket grew.
    assert [bu.count for bu in tc._al_buckets] == [3, 1, 1]
    hits = tc.locate_fragment(vids[2][250:300])
    assert hits == jc.locate_fragment(vids[2][250:300])
    assert hits[0] == (2, 250, 50)
    assert tc.sync_bytes == jc.sync_bytes


def test_sync_bytes_incremental_after_first_query():
    vids = _videos()
    jc, tc = _pair()
    _append_all((jc, tc), vids)
    q = vids[1][50:90]
    tc.locate_fragment(q)
    jc.locate_fragment(q)
    full = tc.sync_bytes["al"]
    assert full == sum(bu.buf.nbytes + bu.len.nbytes
                       for bu in tc._al_buckets if bu is not None)
    tc.locate_fragment(q)                        # nothing dirty: no bytes
    assert tc.sync_bytes["al"] == full
    extra = np.random.default_rng(2).integers(0, 2 ** 32, size=(30, 2),
                                              dtype=np.uint32)
    for c in (jc, tc):
        c.append_fingerprints(3, extra)          # one dirty row of bucket 0
    assert tc.locate_fragment(extra) == jc.locate_fragment(extra)
    assert tc.sync_bytes["al"] == full + 256 * 2 * 4 + 4
    assert tc.sync_bytes == jc.sync_bytes
    for c in (jc, tc):                          # growth: a full resync
        for v in range(10, 75):
            c.append_fingerprints(v, extra[:5])
    assert tc.locate_fragment(extra) == jc.locate_fragment(extra)
    assert tc.sync_bytes == jc.sync_bytes
    assert tc._al_buckets[0].dev.shape == (128, 256, 2)


def test_empty_inputs():
    vids = _videos()
    jc, tc = _pair()
    empty = np.zeros((0, 2), np.uint32)
    assert tc.locate_fragment(vids[1][:10]) == jc.locate_fragment(vids[1][:10]) == []
    _append_all((jc, tc), vids)
    assert tc.locate_fragment(empty) == jc.locate_fragment(empty) == []
    assert (tc.locate_fragments([empty, vids[1][:40]])
            == jc.locate_fragments([empty, vids[1][:40]]))


def test_scan_is_not_raced_by_row_reuse():
    """A writer that removes a video, reuses its row for another and
    queries (syncing the bucket in place) while a scan is in flight waits
    for the scan: the scan's answer names the video it read."""
    vids = _videos()
    tc = DeviceCorpus(device="cpu", **KW)
    _append_all((tc,), vids)
    other = np.random.default_rng(4).integers(0, 2 ** 32, size=vids[2].shape,
                                              dtype=np.uint32)

    def rewrite():
        tc.remove_video(2)
        tc.append_fingerprints(9, other)
        tc.locate_fragment(other[:40])

    writer = threading.Thread(target=rewrite)
    scan = tc._fragment_query

    def racing(*args):
        if writer.ident is None:
            writer.start()
            writer.join(timeout=0.5)
        return scan(*args)

    tc._fragment_query = racing
    hits = tc.locate_fragment(vids[2][250:300])
    writer.join()
    assert hits[0] == (2, 250, 50)
    assert tc._al_row[9] == (1, 0)               # video 2's old row
    assert all(v != 2 for v, _, _ in tc.locate_fragment(vids[2][250:300]))
    assert tc.locate_fragment(other[250:300])[0] == (9, 250, 50)
