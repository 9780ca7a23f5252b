"""Open-loop uploads to verdict (traffic kind ``upload_open_loop``).

Uploads are put into S3 on a schedule every seed shares, drawn from the
traffic's ``arrivals_seed``: Poisson arrivals at ``rate_per_s``, which of
them are re-uploads of the planted originals, and each fresh upload's length
(a fixed set of log-uniform quantiles); each verdict is read over SSE. The
seed draws every upload's pixels and cuts and the original each re-upload
copies. Sample ``verdict``: the time from an upload's due time to its first
SSE event that carries the verdict.

Seams: the poller's dispatch (``start_analysis_thread``), each analysis, the
fingerprint pass (K1) and the nearest-row scan (K4) with the shapes of their
calls, the evidence and timestamp matches the corpus answered, and the
analyzer's stages. Control: the reference's pHash with TF32 on, in place of
the hashes the fingerprint pass returns.
"""

from __future__ import annotations

import json
import math
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from perfbench import data, peaks
from perfbench.load import Kind, log_uniform_sizes, poisson_arrivals
from perfbench.probes import wrap
from perfbench.reference import replay, search, video


class _stacked:
    """Two context managers entered as one."""

    def __init__(self, a, b):
        self.a, self.b = a, b

    def __enter__(self):
        self.a.__enter__()
        self.b.__enter__()

    def __exit__(self, *exc):
        self.b.__exit__(*exc)
        return self.a.__exit__(*exc)


class UploadOpenLoop(Kind):
    """Open-loop uploads to verdict (module note)."""

    def setup(self) -> None:
        with self.phase("catalog"):
            self.make_catalog()
        with self.phase("boot"):
            vids = self.dep.store_videos(self.cat_names)
            self.dep.boot()
        with self.phase("load_catalog"):
            self.dep.load_catalog(vids, self.cat_rows, self.cat_ts)
        self.cat_vids = vids
        self.plan()
        self.install()
        with self.phase("originals"):
            self.ingest_originals()
        with self.phase("payloads"):
            self.payloads = [self.bytes_of(u) for u in self.uploads]
        # From here on a put notifies the queue, as the platform's bucket
        # does; the window opens a fixed time after the poller starts, so
        # every run meets the same arrivals at the same phase of its cadence.
        self.dep.notify_on_put()
        self.dep.app.start_poller()
        self.poller_started = time.perf_counter()

    def instrument(self) -> None:
        app, rec = self.dep.app, self.rec
        corpus, analyzer = app.corpus, app.analyzer
        model = analyzer._model
        h, w = self.cfg.pipeline.scene_height, self.cfg.pipeline.scene_width
        words = self.words
        self.nearest_calls: List[dict] = []
        self.ts_calls: List[dict] = []

        def start_thread(orig):
            def f(bucket, key, decode_key=True):
                rec.mark("dispatch", app._decode_event_key(key)
                         if decode_key else key)
                return orig(bucket, key, decode_key=decode_key)
            return f

        def analyze(orig):
            def f(bucket, key, retry_ctx=None):
                with rec.span("analyze", key=key):
                    return orig(bucket, key, retry_ctx=retry_ctx)
            return f

        def process_block(orig):
            def f(block, carry, scorer, last_cut=None):
                out = orig(block, carry, scorer, last_cut=last_cut)
                rec.add("frames", out[3])
                return out
            return f

        def forward_streams(orig):
            def f(lumas, carries, valid_ts):
                with rec.span("k1", bound_s=peaks.k1_bound_s(valid_ts, h, w)):
                    return orig(lumas, carries, valid_ts)
            return f

        def query_nearest(orig):
            def f(q, fp_dev):
                rec.local.count_n = corpus._fp_count
                with rec.span("k4", bound_s=peaks.scan_bound_s(
                        q.shape[0], fp_dev.shape[0], words)):
                    out = orig(q, fp_dev)
                rec.local.nearest_out = out
                return out
            return f

        def nearest_counts(orig):
            def f(query, exclude_video_id=None):
                rec.local.nearest_out = None
                out = orig(query, exclude_video_id=exclude_video_id)
                if rec.local.nearest_out is not None:
                    with rec._lock:
                        self.nearest_calls.append(dict(
                            query=np.array(query, np.uint32),
                            exclude=exclude_video_id,
                            count_n=rec.local.count_n,
                            out=rec.local.nearest_out, result=dict(out)))
                return out
            return f

        def match_ts(orig):
            def f(query_ts, min_match=2, tolerance=0.0, exclude_video_id=None):
                out = orig(query_ts, min_match=min_match, tolerance=tolerance,
                           exclude_video_id=exclude_video_id)
                with rec._lock:
                    self.ts_calls.append(dict(query=list(query_ts),
                                              exclude=exclude_video_id,
                                              result=sorted(out)))
                return out
            return f

        def stage(orig):
            def f(name):
                if not rec.traced:
                    return orig(name)
                return _stacked(orig(name), rec.span(f"stage.{name}"))
            return f

        wrap(app, "start_analysis_thread", start_thread)
        wrap(analyzer, "analyze", analyze)
        wrap(model, "process_block", process_block)
        wrap(model, "forward_streams", forward_streams)
        wrap(corpus, "_query_nearest", query_nearest)
        wrap(corpus, "nearest_video_counts", nearest_counts)
        wrap(corpus, "match_timestamps", match_ts)
        wrap(analyzer.timer, "stage", stage)

    def begin_window(self) -> None:
        super().begin_window()
        self.nearest_calls.clear()
        self.ts_calls.clear()

    def control_hooks(self) -> list:
        """The reference's pHash of each block, computed with TF32 on (one
        step below the float32 the configuration states), returned in place
        of the hashes the fingerprint pass made; scores and carries are the
        program's."""
        def hook(kind):
            def make(orig):
                def f(lumas, carries, valid_ts):
                    scores, fps, new = orig(lumas, carries, valid_ts)
                    ref = np.stack([video.phash(x, tf32=True) for x in lumas])
                    ref = torch.from_numpy(ref.view(np.int32)).to(fps.device)
                    return scores, ref.reshape(fps.shape).to(fps.dtype), new
                return f
            wrap(kind.dep.app.analyzer._model, "forward_streams", make)
        return [hook]

    def window_start(self) -> float:
        return self.poller_started + self.traffic["poller_lead_s"]

    def host_state(self, t: float) -> Optional[str]:
        """What the host was waiting on at ``t`` when no span was open."""
        marks = self.rec.marks
        for k, put in marks.get("put", {}).items():
            if put <= t < marks.get("dispatch", {}).get(k, math.inf):
                return "poller queue (upload put, not yet dispatched)"
        return None

    def plan(self) -> None:
        t, rng = self.traffic, data.np_rng(self.seed, "uploads")
        self.fps = int(t["fps"])
        self.arrivals = poisson_arrivals(t["rate_per_s"], self.seconds,
                                         t["arrivals_seed"])
        n = len(self.arrivals)
        orig = t["originals"]
        n_dup = int(round(t["duplicate_share"] * n))
        if n_dup > orig["count"]:
            raise ValueError(f"{n_dup} re-uploads in the window but only "
                             f"{orig['count']} originals: each is re-uploaded "
                             "at most once a run")
        used: set = set()
        self.originals = [dict(key=f"orig{j:02d}.y4m", name=f"orig{j:02d}.y4m",
                               frames=orig["frames"],
                               cuts=data.cut_gaps(rng, orig["frames"],
                                                  t["shot_frames"], used))
                          for j in range(orig["count"])]
        # The schedule is the same for every seed: which slots are
        # re-uploads and each fresh upload's length come from the traffic's
        # own seed, so every run offers the same work at the same times.
        sched = np.random.default_rng(t["arrivals_seed"])
        dup_slots = set(sched.permutation(n)[:n_dup].tolist())
        sizes = log_uniform_sizes(n - n_dup, *t["frames"])
        sizes = [sizes[i] for i in sched.permutation(len(sizes))]
        of = rng.permutation(orig["count"])[:n_dup].tolist()
        self.uploads = []
        for i, due in enumerate(self.arrivals):
            if i in dup_slots:
                j = of.pop()
                o = self.originals[j]
                self.uploads.append(dict(
                    key=f"{1700000000000 + i}-reupload{i:03d}.y4m", due=due,
                    original=j, frames=o["frames"], cuts=o["cuts"]))
            else:
                frames = sizes.pop()
                self.uploads.append(dict(
                    key=f"{1700000000000 + i}-upload{i:03d}.y4m", due=due,
                    original=None, frames=frames,
                    cuts=data.cut_gaps(rng, frames, t["shot_frames"], used)))

    def luma(self, item: dict, tag) -> torch.Tensor:
        t = self.traffic
        return data.synthetic_luma(self.seed, self.device, tag, item["frames"],
                                   t["height"], t["width"], item["cuts"])

    def bytes_of(self, u: dict) -> bytes:
        if u["original"] is not None:
            return self.original_bytes[u["original"]]
        luma = self.luma(u, ("upload", u["key"])).cpu().numpy()
        return data.y4m_bytes(luma, self.fps)

    def ingest_originals(self) -> None:
        """The planted originals through the analyzer (warming every stage
        of the window's path), before puts notify the queue and before the
        poller runs."""
        app = self.dep.app
        self.original_bytes = []
        threads = []
        for j, o in enumerate(self.originals):
            b = data.y4m_bytes(self.luma(o, ("original", j)).cpu().numpy(),
                               self.fps)
            self.original_bytes.append(b)
            self.dep.s3.put_object(self.dep.bucket, o["key"], b)
            threads.append(app.start_analysis_thread(self.dep.bucket, o["key"]))
        for th in threads:
            th.join()

    # -- window -------------------------------------------------------------

    def run_window(self, t0: float) -> None:
        client = self.dep.client
        self.results: List[dict] = [dict(done=None, state=None)
                                    for _ in self.uploads]
        self.readers = []
        late = []

        def read(i: int, name: str) -> None:
            for chunk in client.stream(f"/status/stream/{name}"):
                state = json.loads(chunk.decode()[len("data: "):])
                if state.get("status") in ("done", "error"):
                    self.results[i] = dict(done=time.perf_counter(), state=state)
                    return

        for i, u in enumerate(self.uploads):
            due = t0 + u["due"]
            while (d := due - time.perf_counter()) > 0:
                time.sleep(d)
            self.rec.mark("put", u["key"])
            self.dep.s3.put_object(self.dep.bucket, u["key"],
                                   self.payloads[i])
            late.append(time.perf_counter() - due)
            th = threading.Thread(target=read, args=(i, u["key"]), daemon=True)
            th.start()
            self.readers.append(th)
        while (d := t0 + self.seconds - time.perf_counter()) > 0:
            time.sleep(d)
        self.notes["generator_late_max_ms"] = 1e3 * max(late, default=0.0)
        marks = self.rec.marks
        self.notes["backlog_at_close"] = sum(
            1 for k in marks.get("put", {}) if k not in marks.get("dispatch", {}))
        self.notes["verdicts_in_window"] = sum(
            1 for r in self.results if r["done"] is not None)
        self.t0 = t0

    def drain(self, limit_s: float) -> None:
        end = time.perf_counter() + limit_s
        for th in self.readers:
            th.join(timeout=max(0.0, end - time.perf_counter()))
        stop = time.perf_counter()
        self.notes["drain_s"] = stop - (self.t0 + self.seconds)
        self.attempted = len(self.uploads)
        lat = []
        for u, r in zip(self.uploads, self.results):
            ok = r["state"] is not None and r["state"].get("status") == "done"
            if not ok:
                self.failed += 1
                lat.append(math.inf)
            else:
                lat.append(1e3 * (r["done"] - (self.t0 + u["due"])))
        self.samples["verdict"] = lat
        self.notes["samples"] = len(lat)
        self.drain_end = stop
        # What the comparison needs of the program's state, taken before
        # it is freed: each upload's stored fingerprints, and the corpus's
        # host rows and their videos.
        store, corpus = self.dep.store, self.dep.app.corpus
        for item in self.originals + self.uploads:
            v = store.get_video_by_filename(
                item["name"] if "name" in item else item["key"].split("-", 1)[1])
            item["vid"] = v.id if v else None
            item["stored"] = store.get_fingerprints(v.id) if v else None
        self.mirror = (corpus._fp[:corpus._fp_count].copy(),
                       corpus._fp_vid[:corpus._fp_count].copy())
        for c in self.nearest_calls:
            c["out"] = tuple(x[:c["query"].shape[0]].cpu().numpy()
                             for x in c["out"])

    # -- correctness ----------------------------------------------------------

    def reference_frames(self, item: dict, tag) -> Tuple[np.ndarray, List[int]]:
        """(T, 2) reference hashes and cut frames of an upload's pixels."""
        s = self.cfg.pipeline
        full = self.luma(item, tag)
        hashes = video.phash(video.downscale(full, s.scene_height, s.scene_width))
        cuts = video.cut_frames(video.mafd(full), self.cfg.scene.threshold)
        return hashes, cuts

    def verify(self, limits: dict) -> Dict[str, Tuple[float, float]]:
        m, s = self.cfg.match, self.cfg.pipeline
        thr, block = m.hamming_threshold, s.block_frames
        rows, row_vid = self.mirror
        n_cat = self.cat_rows.shape[0] * self.cat_rows.shape[1]
        cat_flat = self.cat_rows.reshape(n_cat, -1)
        cat_vid = np.repeat(np.asarray(self.cat_vids), self.cat_rows.shape[1])
        k = min(n_cat, rows.shape[0])
        catalog_wrong = int(n_cat - k
                            + np.count_nonzero(np.any(rows[:k] != cat_flat[:k], 1))
                            + np.count_nonzero(row_vid[:k] != cat_vid[:k]))
        # The originals (set-up) against the catalog alone, then the window's
        # uploads against the catalog and the originals' rows.
        ref = {}
        for j, o in enumerate(self.originals):
            ref[("o", j)] = self.reference_frames(o, ("original", j))
        cat_ts = list(zip(self.cat_vids, self.cat_ts))

        def ts_fn(catalog, exclude=None):
            return lambda cuts: search.timestamp_matches(
                cuts, catalog, m.min_match, exclude, m.max_cuts)

        q = np.concatenate([ref[("o", j)][0] for j in range(len(self.originals))])
        d, r = search.nearest(q, cat_flat, self.device)
        orig_rows, orig_vid, orig_ts, at = [], [], [], 0
        for j, o in enumerate(self.originals):
            n = o["frames"]
            dups, cuts, read = replay.replay(
                ref[("o", j)][1], self.fps, n, block, d[at:at + n], r[at:at + n],
                cat_vid, ts_fn(cat_ts), thr, m.fp_min_match)
            at += n
            o["expect"] = (dups, cuts, read)
            orig_rows.append(ref[("o", j)][0][:read])
            orig_vid += [o["vid"]] * read
            orig_ts.append((o["vid"], cuts))
        known_rows = np.concatenate([cat_flat] + orig_rows)
        known_vid = np.concatenate([cat_vid, np.asarray(orig_vid, np.int64)])
        known_ts = cat_ts + orig_ts
        names = dict(zip(self.cat_vids, self.cat_names))
        names.update({o["vid"]: o["name"] for o in self.originals})

        for i, u in enumerate(self.uploads):
            tag = (("original", u["original"]) if u["original"] is not None
                   else ("upload", u["key"]))
            ref[("u", i)] = self.reference_frames(u, tag)
        q = np.concatenate([ref[("u", i)][0] for i in range(len(self.uploads))]
                           or [np.zeros((0, self.words), np.uint32)])
        d, r = (search.nearest(q, known_rows, self.device) if len(q)
                else (np.zeros(0, np.int64), np.zeros(0, np.int64)))
        verdicts_wrong = cuts_wrong = 0
        bits = diff = 0
        at = 0
        for i, u in enumerate(self.uploads):
            n = u["frames"]
            dups, cuts, read = replay.replay(
                ref[("u", i)][1], self.fps, n, block, d[at:at + n], r[at:at + n],
                known_vid, ts_fn(known_ts, u.get("vid")), thr, m.fp_min_match)
            at += n
            state = self.results[i]["state"]
            if state is None or state.get("status") != "done":
                continue
            stored = u["stored"]
            if (sorted(state.get("duplicates", [])) != sorted(names[v] for v in dups)
                    or stored is None or stored.shape[0] != read):
                verdicts_wrong += 1
            if [float(x) for x in state.get("scene_cuts", [])] != cuts:
                cuts_wrong += 1
        for item, key in ([(o, ("o", j)) for j, o in enumerate(self.originals)]
                          + [(u, ("u", i)) for i, u in enumerate(self.uploads)]):
            stored = item["stored"]
            if stored is None:
                continue
            k = min(len(stored), len(ref[key][0]))
            x = np.bitwise_xor(stored[:k], ref[key][0][:k])
            diff += int(np.unpackbits(x.view(np.uint8)).sum())
            bits += 32 * self.words * k
        # K4 and the evidence on the program's own inputs: every recorded
        # query against the corpus rows present when it ran.
        k4_wrong = evidence_wrong = 0
        calls = self.nearest_calls
        if calls:
            base = min(c["count_n"] for c in calls)
            allq = np.concatenate([c["query"] for c in calls])
            bd, br = search.nearest(allq, rows[:base], self.device)
            at = 0
            for c in calls:
                n = c["query"].shape[0]
                dd, rr = bd[at:at + n].copy(), br[at:at + n].copy()
                at += n
                if c["count_n"] > base:
                    ed, er = search.nearest(c["query"], rows[base:c["count_n"]],
                                            self.device)
                    better = ed < dd
                    dd = np.where(better, ed, dd)
                    rr = np.where(better, er + base, rr)
                pm, pa = c["out"]
                if pm.shape != dd.shape or pa.shape != rr.shape:
                    k4_wrong += n
                else:
                    k4_wrong += int(np.count_nonzero((pm != dd) | (pa != rr)))
                want = search.evidence(dd, rr, row_vid[:c["count_n"]], thr,
                                       c["exclude"])
                evidence_wrong += int(want != c["result"])
        ts_wrong = sum(int(c["result"] != search.timestamp_matches(
            c["query"], known_ts, m.min_match, c["exclude"], m.max_cuts))
            for c in self.ts_calls)
        values = {
            "verdicts_wrong": verdicts_wrong,
            "cuts_wrong": cuts_wrong,
            "hash_bits_pct": 100.0 * diff / max(bits, 1),
            "k4_rows_wrong": k4_wrong,
            "evidence_wrong": evidence_wrong,
            "timestamp_matches_wrong": ts_wrong,
            "catalog_rows_wrong": catalog_wrong,
        }
        return {k: (v, limits[k]) for k, v in values.items()}



KIND = UploadOpenLoop
