"""Each traffic kind turns its parameters into the same requests under a
seed, and every seed into the same set of sizes and arrivals."""

import numpy as np
import pytest
import torch

from perfbench import core, data
from perfbench.load import log_uniform_sizes, poisson_arrivals
from perfbench.probes import Recorder
from perfbench.tests.tiny import tiny_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(str(tmp_path_factory.mktemp("tiny")))


def kind(root, cell, seed, tmp, seconds=6):
    c = core.Cell(cell, root)
    return c.kind_class()(c.config, c.traffic, seed, seconds, "cpu",
                          Recorder(False), str(tmp))


def test_sizes_and_arrivals():
    assert log_uniform_sizes(4, 128, 1024) == [166, 279, 470, 790]
    a = poisson_arrivals(0.72, 51, 7)
    assert len(a) == 37 and a == sorted(a) and 0 <= a[0] and a[-1] < 51
    assert a == poisson_arrivals(0.72, 51, 7)


def test_upload_plan(root, tmp_path):
    a, b, c = (kind(root, "upload-phash64", s, tmp_path / str(i))
               for i, s in enumerate((1, 1, 2 ** 40 + 3)))
    for k in (a, b, c):
        k.plan()
    strip = lambda k: [{x: u[x] for x in ("key", "due", "original", "frames", "cuts")}
                       for u in k.uploads]
    assert strip(a) == strip(b)
    assert strip(a) != strip(c)
    assert [u["due"] for u in a.uploads] == [u["due"] for u in c.uploads]
    assert [u["frames"] for u in a.uploads] == [u["frames"] for u in c.uploads]
    assert ([u["original"] is None for u in a.uploads]
            == [u["original"] is None for u in c.uploads])
    dups = [u["original"] for u in a.uploads if u["original"] is not None]
    assert len(dups) == round(0.25 * len(a.uploads)) and len(set(dups)) == len(dups)
    cuts = [f for item in a.originals + [u for u in a.uploads if u["original"] is None]
            for f in item["cuts"]]
    assert len(cuts) == len(set(cuts))
    for item in a.originals + a.uploads:
        gaps = np.diff([0] + item["cuts"])
        assert all(80 <= g <= 300 for g in gaps) and all(f < item["frames"] for f in item["cuts"])


def test_upload_bytes_are_seeded(root, tmp_path):
    k = kind(root, "upload-phash64", 5, tmp_path)
    k.plan()
    u = next(u for u in k.uploads if u["original"] is None)
    one, two = k.bytes_of(u), k.bytes_of(u)
    assert one == two and one.startswith(b"YUV4MPEG2 W320 H180 F25:1")
    assert len(one) == len(one.split(b"\n", 1)[0]) + 1 + u["frames"] * (6 + 86400)


def test_search_plan(root, tmp_path):
    a, b = (kind(root, "fragsearch-phash256", s, tmp_path / str(s)) for s in (3, 4))
    for k in (a, b):
        k.make_data()
        k.plan()
    block = lambda k: sorted(q["num_frames"] for r in k.lists[0][:16] for q in r["queries"])
    assert block(a) == block(b)
    assert a.lists[0] != b.lists[0] and a.lists[0] != a.lists[1]
    for r in a.lists[0]:
        assert len(r["queries"]) == 4 and r["top_k"] == 5
        for q in r["queries"]:
            assert 0 <= q["start_frame"] <= 128 - q["num_frames"]
    again = kind(root, "fragsearch-phash256", 3, tmp_path / "again")
    again.make_data()
    again.plan()
    assert again.lists == a.lists
    assert np.array_equal(again.cat_rows, a.cat_rows)


def test_planted_copies_stay_within_threshold():
    rows, _ = data.catalog(9, "cpu", 4, 512, 8, (80, 300), 6)
    src = np.random.default_rng(0).integers(0, 2 ** 32, (2, 128, 8), dtype=np.uint64).astype(np.uint32)
    where = data.planted_copies(9, "cpu", rows, src, 10)
    for i, (h, o) in enumerate(where):
        flips = np.unpackbits((rows[h, o:o + 128] ^ src[i]).view(np.uint8), axis=1).sum(1)
        assert flips.max() <= 10 and flips.min() >= 0


def test_catalog_shots():
    rows, starts = data.catalog(3, "cpu", 3, 1024, 2, (80, 300), 6)
    again, _ = data.catalog(3, "cpu", 3, 1024, 2, (80, 300), 6)
    assert np.array_equal(rows, again)
    cuts = [k for k in starts[0] if k >= 0]
    bits = np.unpackbits(np.bitwise_xor(rows[0, 1:], rows[0, :-1]).view(np.uint8), axis=1).sum(1)
    inside = [bits[t - 1] for t in range(1, 1024) if t not in cuts]
    assert np.mean(inside) < 6 and min(bits[k - 1] for k in cuts) > 10
    ts = data.shot_timestamps(starts, 30000, 1001)[0]
    assert ts == [round(k * 1001 / 30000, 6) for k in cuts]


def test_synthetic_luma_cuts():
    luma = data.synthetic_luma(1, "cpu", "x", 40, 36, 64, [10, 30])
    assert luma.shape == (40, 36, 64) and luma.dtype == torch.uint8
    d = (luma[1:].float() - luma[:-1].float()).abs().mean((1, 2))
    assert set(torch.nonzero(d > 20).flatten().tolist()) == {9, 29}
