"""Fragment search at W = 2 with tied answers, against the benchmark's plain
reference.

At 64 bits a 2^24-row catalog puts random rows within the threshold of a
query frame, and those rows come in runs (the frames of one shot), so an
answer holds, after the planted copy, low-score videos whose best offset is
the first of many tied ones, and videos of equal score ordered by alignment
bucket and then by arrival. ``tie_catalog`` builds a few thousand rows in
two buckets that hold each of these cases on purpose:

- the query's own source (excluded, or tied with its planted copy when not);
- two videos of different buckets at the same score, the one in the later
  bucket stored first;
- a video whose best score is reached along a run of tied offsets;
- a zero-score video;
- a video with one frame at exactly the threshold (10 bits, counted) beside
  one just past it (11 bits, not counted);
- score-1 videos in both buckets, more than ``top_k`` leaves room for.

``DeviceCorpus.locate_fragments`` on the CPU (``fragment_search_batch_plain``
and ``_rank``) must equal ``perfbench/reference/search.py``'s
``Catalog.align`` entry for entry. ``tests/test_torch_cuda.py`` runs the same
catalog through K3's band form.
"""

import numpy as np
import pytest

from perfbench.reference.search import Catalog
from tvidz_tpu_torch.corpus.device_corpus import DeviceCorpus

WORDS = 2
SOURCE, B2, A3, RUN, ZERO, THR, LATE, EARLY, COPY = range(1, 10)


def flip_bits(row: np.ndarray, k: int, rng) -> np.ndarray:
    """``row`` (W,) uint32 with k distinct bits flipped."""
    out = row.copy()
    for b in rng.choice(32 * WORDS, size=k, replace=False):
        out[b // 32] ^= np.uint32(1 << int(b % 32))
    return out


def tie_catalog(seed: int = 16):
    """([(video, (T, 2) uint32 rows)] in arrival order, the two queries (cut
    from SOURCE), the planted copy's offset for each)."""
    rng = np.random.default_rng(seed)

    def rand(n):
        return rng.integers(0, 2 ** 32, size=(n, WORDS), dtype=np.uint32)

    src = rand(300)
    qa, qb = src[40:160], src[200:260]
    videos = {v: rand(n) for v, n in ((B2, 400), (A3, 200), (RUN, 250),
                                       (ZERO, 180), (THR, 300), (LATE, 300),
                                       (EARLY, 60), (COPY, 512))}
    # Score 2 in bucket 1 (offset 290) and in bucket 0 (offset -20).
    videos[B2][300] = flip_bits(qa[10], 2, rng)
    videos[B2][305] = flip_bits(qa[15], 3, rng)
    videos[A3][50], videos[A3][51] = qa[70], qa[71]
    # One query frame matched by a run of rows: score 1 at offsets 70..109
    # and again at 110..129 (a second run); the first, 70, is the answer.
    for r in range(100, 140):
        videos[RUN][r] = flip_bits(qa[30], r % 4, rng)
    for r in range(200, 220):
        videos[RUN][r] = flip_bits(qa[90], 1, rng)
    # Offset 100: frame 50 at exactly 10 bits, frame 51 at 11.
    videos[THR][150] = flip_bits(qa[50], 10, rng)
    videos[THR][151] = flip_bits(qa[51], 11, rng)
    videos[LATE][10] = flip_bits(qa[100], 5, rng)          # offset -90
    videos[EARLY][5] = qa[0]                               # offset 5
    # The planted copy: the source at row 150, 0-10 bits off a frame.
    for t in range(300):
        videos[COPY][150 + t] = flip_bits(src[t], t % 11, rng)
    order = [(SOURCE, src)] + [(v, videos[v]) for v in
                               (B2, A3, RUN, ZERO, THR, LATE, EARLY, COPY)]
    return order, [qa, qb], [150 + 40, 150 + 200]


def bucket(frames: int) -> int:
    """The alignment bucket of a video: the least b with 256·2^b >= frames."""
    b = 0
    while (256 << b) < frames:
        b += 1
    return b


def reference(videos, device="cpu") -> Catalog:
    """The reference over ``videos`` in the order the service ranks equal
    scores: buckets by length, arrival within each."""
    return Catalog(sorted(videos, key=lambda vf: bucket(len(vf[1]))), device)


def corpus(videos, device="cpu") -> DeviceCorpus:
    c = DeviceCorpus(words=WORDS, hamming_threshold=10, device=device)
    for v, rows in videos:
        c.append_fingerprints(v, rows)
    return c


CASES = [(10, 10, True), (10, 5, True), (10, 10, False), (9, 10, True),
         (11, 10, True), (11, 3, False)]


@pytest.fixture(scope="module")
def ties():
    videos, queries, copy_at = tie_catalog()
    return videos, queries, copy_at, reference(videos), corpus(videos)


@pytest.mark.parametrize("thr,top_k,exclude", CASES,
                         ids=[f"thr{t}-top{k}-{'excl' if e else 'self'}"
                              for t, k, e in CASES])
def test_locate_fragments_equals_the_reference(ties, thr, top_k, exclude):
    _, queries, copy_at, ref, c = ties
    excl = SOURCE if exclude else None
    got = c.locate_fragments(queries, top_k=top_k, hamming_threshold=thr,
                             exclude_video_ids=[excl, excl])
    want = [ref.align(q, thr, top_k, excl) for q in queries]
    assert got == want
    qa = got[0]
    if excl is None:          # the source and its copy tie; the source came first
        assert qa[0] == (SOURCE, 40, 120) and qa[1][:2] == (COPY, copy_at[0])
    else:
        assert qa[0][:2] == (COPY, copy_at[0])
    assert ZERO not in [v for v, _, _ in qa]
    score_of = {v: (o, s) for v, o, s in got[0]}
    if thr == 10 and top_k == 10:
        assert qa[1 if excl else 2:] == [(A3, -20, 2), (B2, 290, 2), (RUN, 70, 1), (EARLY, 5, 1),
                          (THR, 100, 1), (LATE, -90, 1)]
    if top_k == 10:           # the frame at 10 bits counts from 10, at 11 from 11
        assert score_of.get(THR) == {9: None, 10: (100, 1), 11: (100, 2)}[thr]
    assert [v for v, _, _ in got[1]] == ([COPY] if excl else [SOURCE, COPY])
