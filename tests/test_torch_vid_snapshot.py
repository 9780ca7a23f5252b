"""The nearest-row queries read the rows' video table by reference.

``nearest_video_counts`` and ``search_fingerprints`` take the host table
and its row count under the corpus lock and read their rows' vids after
the lock is released. Here the corpus changes in that gap: the query's
results run the change when they are pulled. Each answer must equal what a
query that copies the table under the lock answers, as the JAX package's
corpus does, driven the same way; the copies that the writers in place
make instead are counted by the span table's ``corpus.vid_cow`` row.
"""

import contextlib
import time

import numpy as np
import pytest
import torch

from tvidz_tpu_torch.corpus.device_corpus import DeviceCorpus
from tvidz_tpu_torch.utils import timing

KW = dict(fp_initial_capacity=512, fp_block_n=256, ts_initial_capacity=8)


class Pulled:
    """A query's result whose first pull (``.cpu()`` on the port's tensors,
    ``np.asarray`` on the reference's arrays) runs ``change`` first."""

    def __init__(self, value, change):
        self.value, self.change = value, change

    def __getitem__(self, key):
        return Pulled(self.value[key], self.change)

    def cpu(self):
        self.change()
        return self.value.cpu()

    def __array__(self, dtype=None, copy=None):
        self.change()
        return np.asarray(self.value, dtype=dtype)


@contextlib.contextmanager
def armed(corpus, change):
    """The corpus's queries within run ``change(corpus)`` once, when the
    first of their results is pulled (after the lock is released)."""
    done = []

    def run():
        if not done:
            done.append(True)
            change(corpus)

    names = ("_query_nearest", "_frame_min")
    before = {n: corpus.__dict__[n] for n in names if n in corpus.__dict__}
    for name in names:
        def hooked(q, fp_dev, orig=getattr(corpus, name)):
            out = orig(q, fp_dev)
            if isinstance(out, tuple):
                return tuple(Pulled(x, run) for x in out)
            return Pulled(out, run)
        setattr(corpus, name, hooked)
    try:
        yield done
    finally:
        for name in names:
            delattr(corpus, name)
        corpus.__dict__.update(before)


def cow_count() -> int:
    return timing.TRACER.summary().get("corpus.vid_cow", {}).get("count", 0)


def _videos():
    rng = np.random.default_rng(17)
    return {v: rng.integers(0, 2 ** 32, size=(n, 2), dtype=np.uint32)
            for v, n in ((1, 300), (2, 700), (3, 450), (4, 900), (5, 80))}


def _queries(vids):
    rng = np.random.default_rng(4)
    near4 = vids[4][:15].copy()
    near4[:, 0] ^= np.uint32(0b1011)               # 3 bits from video 4
    return [np.concatenate([near4, vids[1][10:30], vids[3][200:204]]),
            vids[2][100:103],
            rng.integers(0, 2 ** 32, size=(13, 2), dtype=np.uint32),
            np.full((5, 2), 0xFFFFFFFF, np.uint32)]  # nearest: sentinels


def _fill(c, vids):
    for v, fp in vids.items():
        c.append_fingerprints(v, fp)
        c.upsert_timestamps(v, [0.04 * v, 1.0 + v])


def _grow(c):
    extra = np.random.default_rng(8).integers(0, 2 ** 32, size=(2000, 2),
                                              dtype=np.uint32)
    cap = c._fp_cap
    c.append_fingerprints(6, extra)
    assert c._fp_cap > cap


QUERY = {
    "nearest": lambda c, q, excl: c.nearest_video_counts(
        q, exclude_video_id=excl),
    "search": lambda c, q, excl: c.search_fingerprints(
        q, min_match=1, exclude_video_id=excl),
}

# name: (removals before the query, the change in its gap, copies on write)
CHANGES = {
    "remove_matched": ((), lambda c: c.remove_video(4), 1),
    "remove_compacts": ((2,), lambda c: c.remove_video(4), 1),
    "append_grows": ((), _grow, 0),
    "reset": ((), lambda c: c.reset(), 0),
}


@pytest.mark.parametrize("query", sorted(QUERY))
@pytest.mark.parametrize("case", list(CHANGES))
def test_change_after_the_lock_leaves_the_answer(case, query):
    from tvidz_tpu.corpus.device_corpus import DeviceCorpus as JaxCorpus

    removals, change, copies = CHANGES[case]
    ask = QUERY[query]
    vids = _videos()
    queries = _queries(vids)
    for excl in (None, 1):
        tc, jc = DeviceCorpus(device="cpu", **KW), JaxCorpus(**KW)
        for c in (tc, jc):
            _fill(c, vids)
            for v in removals:
                c.remove_video(v)
        want = ask(tc, queries[0], excl)      # the table as it is scanned
        assert want, "the query must find evidence"
        cows = cow_count()
        for c in (tc, jc):
            with armed(c, change) as fired:
                got = ask(c, queries[0], excl)
            assert fired and got == want, (c, got, want)
        assert cow_count() - cows == copies
        if case == "remove_compacts":
            assert tc._fp_tombstones == 0 and tc._fp_count == 2430 - 1600
        # What came after the change, on both.
        for k in ("_fp", "_fp_vid"):
            np.testing.assert_array_equal(getattr(tc, k), getattr(jc, k))
        for q in queries:
            for e in (None, 1, 4):
                assert ask(tc, q, e) == ask(jc, q, e)


@pytest.mark.parametrize("query_first", [True, False],
                         ids=["query_then_removals", "removals_alone"])
def test_a_removal_copies_the_table_only_after_a_query(query_first):
    vids = _videos()
    queries = _queries(vids)
    c = DeviceCorpus(device="cpu", **KW)
    _fill(c, vids)
    start = cow_count()
    if query_first:
        for q in queries:
            c.nearest_video_counts(q)
            c.search_fingerprints(q, min_match=1)
        assert cow_count() == start            # queries alone copy nothing
    held = c._fp_vid
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        t0 = time.perf_counter()
        c.remove_video(2)
        c.remove_video(4)                      # compacts: no second copy
    assert c._fp_tombstones == 0
    copies = int(query_first)
    assert cow_count() - start == copies
    assert (c._fp_vid is not held) == query_first
    recs = [r for r in timing.TRACER.finished()
            if r.name == "corpus.vid_cow" and r.t0 >= t0]
    assert [r.attrs["bytes"] for r in recs] == [held.nbytes] * copies
