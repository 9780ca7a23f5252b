"""The port's own host modules against the JAX package's, which they copy:
configuration field by field under the same environment, the NumPy golden
models output by output, Y4M and native decode of one synthetic file, and
one sqlite store written by either package and read back equal by the
other (a fleet may run both against one store)."""

import dataclasses
import os
import shutil
import subprocess

import numpy as np
import pytest

import tvidz_tpu.config as jax_config
from tvidz_tpu.corpus.store import Store as JaxStore
from tvidz_tpu.decode.base import DecodeError as JaxDecodeError
from tvidz_tpu.decode import y4m as jax_y4m
from tvidz_tpu.decode.y4m import Y4MDecoder as JaxY4M
from tvidz_tpu.ops import golden as jax_golden
from tvidz_tpu.ops.hashes import HASH_REGISTRY
from tvidz_tpu_torch import config
from tvidz_tpu_torch.corpus.store import Store
from tvidz_tpu_torch.decode import write_synthetic_y4m, y4m
from tvidz_tpu_torch.decode.base import DecodeError
from tvidz_tpu_torch.decode.y4m import Y4MDecoder
from tvidz_tpu_torch.ops import golden
from tvidz_tpu_torch.utils import timing

ENV = {
    "TVIDZ_SCENE_THRESHOLD": "0.25", "TVIDZ_DCT_SIZE": "16",
    "TVIDZ_HASH_SIZE": "8", "TVIDZ_HASH_ALGO": "dhash",
    "TVIDZ_MIN_MATCH": "3", "TVIDZ_HAMMING_THRESHOLD": "7",
    "TVIDZ_BLOCK_FRAMES": "64", "TVIDZ_SCENE_HEIGHT": "72",
    "TVIDZ_SHARED_DISPATCHER": "0", "TVIDZ_EARLY_EXIT": "false",
    "TVIDZ_S3_BUCKET": "other-bucket", "TVIDZ_PORT": "5077",
    "TVIDZ_SSE_POLL_S": "0.5", "TVIDZ_DB_URL": "sqlite:///elsewhere.db",
}
SUB_CONFIGS = ["SceneConfig", "HashConfig", "MatchConfig", "PipelineConfig",
               "ServiceConfig"]


@pytest.fixture(params=[False, True], ids=["defaults", "env"])
def env(request, monkeypatch):
    for k in list(os.environ):
        if k.startswith("TVIDZ_") or k == "POSTGRES_URL":
            monkeypatch.delenv(k)
    if request.param:
        for k, v in ENV.items():
            monkeypatch.setenv(k, v)


@pytest.mark.parametrize("name", SUB_CONFIGS)
def test_sub_config_from_env_matches(env, name):
    ours = getattr(config, name).from_env()
    theirs = getattr(jax_config, name).from_env()
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


def test_config_matches(env):
    ours, theirs = config.Config(), jax_config.Config()
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert [f.name for f in dataclasses.fields(ours)] == [
        f.name for f in dataclasses.fields(theirs)]


@pytest.mark.parametrize("algorithm", sorted(HASH_REGISTRY))
def test_hash_words_match_the_registry(algorithm):
    ours = config.HashConfig(algorithm=algorithm)
    theirs = jax_config.HashConfig(algorithm=algorithm)
    assert config.HASH_WORDS[algorithm] == HASH_REGISTRY[algorithm][1]
    assert (ours.bits, ours.words) == (theirs.bits, theirs.words)


def _frames(seed=4, t=12, h=48, w=64):
    return np.random.default_rng(seed).integers(0, 256, (t, h, w), np.uint8)


GOLDEN_CASES = {
    "area_resize": lambda g, f: g.area_resize(f[0].astype(np.float32), 32, 32),
    "dct2": lambda g, f: g.dct2(f[0, :32, :32].astype(np.float64)),
    "phash_bits": lambda g, f: g.phash_bits(f[0]),
    "phash": lambda g, f: np.stack([g.phash(x) for x in f]),
    "scene_scores": lambda g, f: g.scene_scores(f),
    "scene_mafd": lambda g, f: g.scene_mafd(f),
    "scene_cuts": lambda g, f: np.asarray(
        g.scene_cuts(np.concatenate([f[:6], 255 - f[6:]]), np.arange(12) / 25)),
    "hamming_matrix": lambda g, f: g.hamming_matrix(
        f[:4, 0, :8].view(np.uint32), f[4:, 0, :8].view(np.uint32)),
    "best_alignment": lambda g, f: np.asarray(g.best_alignment(
        f[:3, 0, :8].view(np.uint32), f[:, 0, :8].view(np.uint32))),
}


@pytest.mark.parametrize("case", sorted(GOLDEN_CASES))
def test_golden_matches(case):
    f = _frames()
    np.testing.assert_array_equal(GOLDEN_CASES[case](golden, f),
                                  GOLDEN_CASES[case](jax_golden, f))


def _decode(decoder, path, h, w, block_frames=16):
    blocks = list(decoder.blocks(path, block_frames, h, w))
    mafd = [b.mafd for b in blocks]
    return (np.concatenate([b.luma for b in blocks]),
            np.concatenate([b.pts for b in blocks]),
            None if any(m is None for m in mafd) else np.concatenate(mafd),
            [b.start_frame for b in blocks])


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("clip") / "clip.y4m")
    write_synthetic_y4m(path, num_frames=40, height=72, width=96,
                        cut_frames=(13, 29), seed=5)
    return path


# The upload cell's geometry: 180x320 sources, cuts, 128-frame blocks.
CLIP_180_FRAMES = 300
FRAME_RECORD = len(b"FRAME\n") + 180 * 320 * 3 // 2


@pytest.fixture(scope="module")
def clip180(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("clip180") / "clip.y4m")
    write_synthetic_y4m(path, num_frames=CLIP_180_FRAMES, height=180, width=320,
                        cut_frames=(61, 128, 203), seed=7)
    return path


def _y4m_variant(src, dst, frames=CLIP_180_FRAMES, marker=b"FRAME\n",
                 cut_at=None):
    """A copy of ``src`` holding its first ``frames`` frames, each marker
    replaced by ``marker``, the body cut to ``cut_at`` bytes if given."""
    with open(src, "rb") as f:
        header = f.readline()
        body = f.read()
    records = [marker + body[i + 6:i + FRAME_RECORD]
               for i in range(0, frames * FRAME_RECORD, FRAME_RECORD)]
    with open(dst, "wb") as f:
        f.write(header + b"".join(records)[:cut_at])
    return str(dst)


Y4M_CASES = {
    # (clip: None = the 72x96 clip, else (frames, marker)), (h, w), block
    "native": (None, (72, 96), 16),
    "half": (None, (36, 48), 16),
    **{f"180x320-{n}f": ((n, b"FRAME\n"), (90, 160), 128)
       for n in (1, 127, 128, 129, CLIP_180_FRAMES)},
    "180x320-quarter": ((CLIP_180_FRAMES, b"FRAME\n"), (45, 80), 128),
    "180x320-3x4": ((CLIP_180_FRAMES, b"FRAME\n"), (60, 80), 128),
    "180x320-5x5": ((CLIP_180_FRAMES, b"FRAME\n"), (36, 64), 128),
    "180x320-non-integer": ((CLIP_180_FRAMES, b"FRAME\n"), (72, 96), 128),
    "180x320-identity": ((CLIP_180_FRAMES, b"FRAME\n"), (180, 320), 128),
    "180x320-marker-params": ((129, b"FRAME Ip XYSCSS=420JPEG\n"), (90, 160), 128),
}


@pytest.mark.parametrize("case", list(Y4M_CASES))
def test_y4m_decode_matches(clip, clip180, tmp_path, case):
    variant, size, block_frames = Y4M_CASES[case]
    path = clip if variant is None else _y4m_variant(
        clip180, tmp_path / "v.y4m", *variant)
    ours = _decode(Y4MDecoder(), path, *size, block_frames)
    theirs = _decode(JaxY4M(), path, *size, block_frames)
    for a, b in zip(ours, theirs):
        if a is None or b is None:
            assert a is None and b is None
        else:
            np.testing.assert_array_equal(a, b)


Y4M_FAULTS = {
    # (frames kept, marker, bytes the body is cut to): the fault sits in the
    # second block, after one whole block was yielded.
    "truncated-luma": (201, b"FRAME\n", 200 * FRAME_RECORD + 6 + 1000),
    "truncated-chroma": (201, b"FRAME\n", 201 * FRAME_RECORD - 10),
    "truncated-marker": (201, b"FRAME\n", 200 * FRAME_RECORD + 3),
}


def _decode_until(decoder, path, error):
    got = []
    with pytest.raises(error) as e:
        for b in decoder.blocks(path, 128, 90, 160):
            got.append(b)
    return got, str(e.value)


@pytest.mark.parametrize("case", [*Y4M_FAULTS, "bad-marker"])
def test_y4m_decode_faults_match(clip180, tmp_path, case):
    if case == "bad-marker":
        good = _y4m_variant(clip180, tmp_path / "good.y4m", 200)
        with open(good, "ab") as f:
            f.write(b"FRAMX\n" + bytes(FRAME_RECORD - 6))
        path = good
    else:
        path = _y4m_variant(clip180, tmp_path / "v.y4m", *Y4M_FAULTS[case])
    ours, msg = _decode_until(Y4MDecoder(), path, DecodeError)
    theirs, want = _decode_until(JaxY4M(), path, JaxDecodeError)
    assert msg == want
    assert [b.start_frame for b in ours] == [b.start_frame for b in theirs] == [0]
    for a, b in zip(ours, theirs):
        for key in ("luma", "pts", "mafd"):
            np.testing.assert_array_equal(getattr(a, key), getattr(b, key))


def _float_area(luma, out_h, out_w):
    """The area average as it was computed in float32: window mean, rint."""
    t, h, w = luma.shape
    x = luma.reshape(t, out_h, h // out_h, out_w, w // out_w).astype(np.float32)
    return np.clip(np.rint(x.mean(axis=(2, 4))), 0, 255).astype(np.uint8)


def _area_counts():
    summary = timing.TRACER.summary()
    return {name: summary.get(name, {}).get("count", 0)
            for name in ("decode.area_exact", "decode.area_matrix")}


@pytest.mark.parametrize(
    "fh, fw", [(fh, fw) for fh in range(1, y4m._EXACT_WINDOW + 1)
               for fw in range(1, y4m._EXACT_WINDOW + 1)],
    ids=str)
def test_y4m_area_exact_every_window_sum(fh, fw):
    """Every window sum s in [0, 255 k] of an fh x fw window, the halves
    included, resized by the integer path, against the float32 mean and the
    reference's decoder."""
    k = fh * fw
    sums = np.arange(255 * k + 1)
    q, r = np.divmod(sums, k)
    windows = (q[:, None] + (np.arange(k) < r[:, None])).astype(np.uint8)
    n = len(sums)
    luma = windows.reshape(1, n, fh, fw).transpose(0, 2, 1, 3).reshape(1, fh, n * fw)
    before = _area_counts()["decode.area_exact"]
    got = y4m._downscale_luma(luma, 1, n)
    assert _area_counts()["decode.area_exact"] - before == (k > 1)
    np.testing.assert_array_equal(got, _float_area(luma, 1, n))
    np.testing.assert_array_equal(got, jax_y4m._downscale_luma(luma, 1, n))
    if k % 2 == 0:                           # exact halves go to the even side
        halves = np.arange(k // 2, 255 * k, k)
        np.testing.assert_array_equal(got[0, 0, halves],
                                      (halves // k + (halves // k) % 2).astype(np.uint8))


def test_y4m_area_exact_random_block():
    luma = np.random.default_rng(11).integers(0, 256, (128, 180, 320), np.uint8)
    got = y4m._downscale_luma(luma, 90, 160)
    np.testing.assert_array_equal(got, _float_area(luma, 90, 160))
    np.testing.assert_array_equal(got, jax_y4m._downscale_luma(luma, 90, 160))


@pytest.mark.parametrize("h, w", [(180, 320), (91, 163), (1, 1), (720, 1280)])
def test_y4m_mafd_matches_float_mean(h, w):
    """The block's integer mafd against each pair's float64 mean of |int16
    diff|, bit for bit: random frames, equal frames, 0 against 255, and
    frames one grey level apart."""
    rng = np.random.default_rng(h * w)
    frames = np.concatenate([
        rng.integers(0, 256, (5, h, w), np.uint8),
        np.zeros((1, h, w), np.uint8), np.full((2, h, w), 255, np.uint8),
        np.full((1, h, w), 254, np.uint8),
        rng.integers(0, 256, (1, h, w), np.uint8)])
    want = [float(np.mean(np.abs(frames[i + 1].astype(np.int16)
                                 - frames[i].astype(np.int16))))
            for i in range(len(frames) - 1)]
    np.testing.assert_array_equal(y4m._mafd(frames), np.asarray(want))


@pytest.mark.parametrize("size, counted", [
    ((90, 160), "decode.area_exact"), ((72, 96), "decode.area_matrix")],
    ids=["exact", "matrix"])
def test_y4m_resize_counters(clip180, size, counted):
    """Under a profiler session, each block resized counts its path once."""
    from torch.profiler import ProfilerActivity, profile

    before = _area_counts()
    with profile(activities=[ProfilerActivity.CPU]):
        blocks = list(Y4MDecoder().blocks(clip180, 128, *size))
    after = _area_counts()
    assert len(blocks) == 3
    assert {n: after[n] - before[n] for n in after} == {
        n: len(blocks) if n == counted else 0 for n in after}


def _toolchain_missing():
    """Why no native decoder can be built here (no make, compiler or libav
    development files), or None."""
    for tool in ("make", os.environ.get("CXX", "g++"), "pkg-config"):
        if shutil.which(tool) is None:
            return f"{tool} not found"
    libs = ["libavformat", "libavcodec", "libavutil", "libswscale"]
    if subprocess.run(["pkg-config", "--exists", *libs]).returncode != 0:
        return "libav development files not found"
    return None


@pytest.fixture(scope="module")
def port_native():
    """The port's native decoder, built from its own sources into build/. A
    build failure with the toolchain present fails the test."""
    missing = _toolchain_missing()
    if missing:
        pytest.skip(f"native decoder not buildable here: {missing}")
    from tvidz_tpu_torch.decode import native

    native.build()
    assert native.available()
    assert os.path.dirname(native.library_path()).endswith(
        os.path.join("build", "tvidz_tpu_torch"))
    return native


@pytest.fixture(scope="module")
def natives(port_native):
    """Both packages' native decoders. The reference's library is built by
    its own step (``make -C tvidz_tpu/decode/_native``), never here."""
    from tvidz_tpu.decode import native as jax_native

    if not jax_native.available():
        pytest.skip("the reference's native decoder is not built "
                    "(make -C tvidz_tpu/decode/_native)")
    return port_native, jax_native


def test_port_native_decode_matches_y4m(port_native, clip):
    """The port's own build decodes the clip to the Y4M decoder's frames."""
    luma, pts, mafd, _ = _decode(port_native.NativeDecoder(), clip, 72, 96)
    want = _decode(Y4MDecoder(), clip, 72, 96)
    np.testing.assert_array_equal(luma, want[0])
    np.testing.assert_allclose(pts, want[1])
    assert mafd is not None and mafd.shape[0] == luma.shape[0]


@pytest.mark.parametrize("size", [(72, 96), (36, 48)], ids=["native", "half"])
def test_native_decode_matches(natives, clip, size):
    ours, theirs = natives
    a = _decode(ours.NativeDecoder(), clip, *size)
    b = _decode(theirs.NativeDecoder(), clip, *size)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert a[2] is not None                  # native-resolution mafd
    info_a, info_b = (d.NativeDecoder().probe(clip) for d in natives)
    assert dataclasses.asdict(info_a) == dataclasses.asdict(info_b)


def _write(store):
    rng = np.random.default_rng(9)
    ids = []
    for i in range(3):
        v = store.add_video(f"clip{i}.mp4")
        ids.append(v.id)
        store.add_timestamps(v.id, [0.5 * i, 1.25, 3.0 + i])
        store.add_fingerprints(v.id, rng.integers(0, 2 ** 32, (20 + i, 2),
                                                  dtype=np.uint32))
    store.update_duplicates(ids[2], [ids[0]])
    store.save_checkpoint("k", b"blob")
    store.delete_video(ids[1])


def _read(store):
    videos = [(v.id, v.filename, v.duplicates) for v in store.all_videos()]
    fps = [(v, f.tolist()) for v, f in store.all_fingerprints()]
    return (videos, store.all_timestamps(), fps, store.load_checkpoint("k"),
            store.find_duplicates([1.25, 4.0], 2))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_store_written_by_one_reads_back_in_the_other(tmp_path, writer):
    url = f"sqlite:///{tmp_path / 'shared.db'}"
    stores = {"jax": JaxStore, "torch": Store}
    w = stores[writer](url)
    _write(w)
    want = _read(w)
    w.close()
    for cls in stores.values():
        s = cls(url)
        assert _read(s) == want
        s.close()
