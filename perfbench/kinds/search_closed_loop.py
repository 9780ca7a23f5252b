"""Closed-loop fragment search (traffic kind ``search_closed_loop``).

``clients`` threads, each sending its next ``/search/fragments`` request when
the last returns; the span lengths of each block of 16 requests are a fixed
set of log-uniform quantiles in an order the seed draws. Sample ``search``:
each request's wall time from when it was sent.

Seams: ``DeviceCorpus.locate_fragments`` (a span a request) and each
bucket's alignment scan (K3) with the real query and video lengths of its
call. Control: the program's own threshold argument one below the
configuration's, so that frames at a distance of exactly the threshold stop
counting as matches (the guarantee the configuration states).
"""

from __future__ import annotations

import math
import threading
import time
from typing import Dict, List, Tuple

import numpy as np

from perfbench import data, peaks
from perfbench.load import Kind, log_uniform_sizes
from perfbench.probes import wrap
from perfbench.reference import search


def _bucket(frames: int) -> int:
    """The alignment bucket of a video of ``frames`` frames: the least b
    with 256·2^b >= frames."""
    b = 0
    while (256 << b) < frames:
        b += 1
    return b


class SearchClosedLoop(Kind):
    """Closed-loop fragment search (module note)."""

    def setup(self) -> None:
        with self.phase("catalog"):
            self.make_data()
        with self.phase("boot"):
            self.src_vids = self.dep.store_videos(self.src_names,
                                                  list(self.sources))
            self.cat_vids = self.dep.store_videos(self.cat_names)
            self.dep.boot()
        with self.phase("load_catalog"):
            self.dep.load_catalog(self.cat_vids, self.cat_rows, self.cat_ts)
        self.plan()
        self.install()
        with self.phase("warm"):
            for body in self.warm:
                self.post(body)

    def instrument(self) -> None:
        rec, corpus, words = self.rec, self.dep.app.corpus, self.words

        def locate(orig):
            def f(query_fps_list, top_k=5, hamming_threshold=None,
                  exclude_video_ids=None):
                rec.local.query_lens = [int(q.shape[0]) for q in query_fps_list]
                with rec.span("locate") as sp:
                    out = orig(query_fps_list, top_k=top_k,
                               hamming_threshold=hamming_threshold,
                               exclude_video_ids=exclude_video_ids)
                rec.local.locate_s = getattr(rec.local, "locate_s", 0.0) + sp.seconds
                return out
            return f

        def fragment_query(orig):
            def f(q, q_lens, al_dev, len_dev, thr):
                bu = next(b for b in corpus._al_buckets
                          if b is not None and b.dev is al_dev)
                lens = bu.len[bu.len > 0].tolist()
                with rec.span("k3", bound_s=peaks.align_bound_s(
                        rec.local.query_lens, lens, words),
                        ops=peaks.align_ops(rec.local.query_lens, lens, words)):
                    return orig(q, q_lens, al_dev, len_dev, thr)
            return f

        wrap(corpus, "locate_fragments", locate)
        wrap(corpus, "_fragment_query", fragment_query)

    def control_hooks(self) -> list:
        """The program's own threshold argument one below the
        configuration's: a frame at a distance of exactly the threshold,
        which the configuration counts as a match, no longer counts."""
        thr = self.cfg.match.hamming_threshold

        def hook(kind):
            def make(orig):
                def f(query_fps_list, top_k=5, hamming_threshold=None,
                      exclude_video_ids=None):
                    return orig(query_fps_list, top_k=top_k,
                                hamming_threshold=thr - 1,
                                exclude_video_ids=exclude_video_ids)
                return f
            wrap(kind.dep.app.corpus, "locate_fragments", make)
        return [hook]

    def make_data(self) -> None:
        """The catalog, the sources, and each source's planted copy."""
        t = self.traffic
        self.make_catalog()
        src = t["sources"]
        g = data.torch_gen(self.seed, self.device, "sources")
        self.sources = data.random_words(
            g, (src["count"], src["frames"], self.words), self.device
        ).cpu().numpy().astype(np.uint32)
        self.copies = data.planted_copies(self.seed, self.device, self.cat_rows,
                                          self.sources, t["copy_max_flips"])
        self.src_names = [f"source-{i:02d}.mp4" for i in range(src["count"])]

    def plan(self) -> None:
        t = self.traffic
        rng = data.np_rng(self.seed, "requests")
        n_src, t_src = self.sources.shape[:2]
        per_block, spans = 16, t["spans_per_request"]
        sizes = log_uniform_sizes(per_block * spans, *t["span_frames"])

        def requests(count: int) -> List[dict]:
            out = []
            for b in range(0, count, per_block):
                order = rng.permutation(len(sizes))
                for k in range(per_block):
                    qs = []
                    for s in range(spans):
                        n = sizes[order[k * spans + s]]
                        j = int(rng.integers(n_src))
                        qs.append({"filename": self.src_names[j],
                                   "start_frame": int(rng.integers(0, t_src - n + 1)),
                                   "num_frames": n, "exclude_self": True})
                    out.append({"queries": qs, "top_k": t["top_k"]})
            return out[:count]

        self.ran_out = False
        self.warm = requests(t["warm_requests"])
        self.lists = [requests(t["requests_per_client"])
                      for _ in range(t["clients"])]

    def post(self, body: dict):
        r = self.dep.client.post("/search/fragments", json_body=body)
        return r.status_code, r.get_json()

    def run_window(self, t0: float) -> None:
        end = t0 + self.seconds
        self.done: List[dict] = []
        lock = threading.Lock()
        rec = self.rec

        def client(reqs: List[dict]) -> None:
            for body in reqs:
                if time.perf_counter() >= end:
                    return
                rec.local.locate_s = 0.0
                with rec.span("request") as sp:
                    code, out = self.post(body)
                sp.info["locate_s"] = rec.local.locate_s
                with lock:
                    self.done.append(dict(body=body, code=code, out=out,
                                          ms=1e3 * sp.seconds))
            self.ran_out = True

        self.clients = [threading.Thread(target=client, args=(reqs,), daemon=True)
                        for reqs in self.lists]
        for th in self.clients:
            th.start()
        while (d := end - time.perf_counter()) > 0:
            time.sleep(d)
        self.t0 = t0

    def drain(self, limit_s: float) -> None:
        stop_by = time.perf_counter() + limit_s
        for th in self.clients:
            th.join(timeout=max(0.0, stop_by - time.perf_counter()))
        self.drain_end = time.perf_counter()
        self.notes["drain_s"] = self.drain_end - (self.t0 + self.seconds)
        self.attempted = len(self.done)
        self.failed = sum(1 for d in self.done
                          if d["code"] != 200 or "results" not in d["out"])
        if self.ran_out:
            raise RuntimeError("a client ran out of requests inside the window: "
                               "raise requests_per_client")
        self.samples["search"] = [d["ms"] if d["code"] == 200 else math.inf
                                  for d in self.done]
        self.notes["samples"] = len(self.done)
        ms = sorted(d["ms"] for d in self.done)
        loc = sorted(1e3 * sp.seconds for sp in self.rec.spans.get("locate", ()))
        for q in (50, 95, 99):
            self.notes[f"request_p{q}_ms"] = ms[int(q / 100 * (len(ms) - 1))] if ms else None
            self.notes[f"locate_p{q}_ms"] = loc[int(q / 100 * (len(loc) - 1))] if loc else None

    def reference_catalog(self) -> search.Catalog:
        """Every stored video in the order the service ranks equal scores
        (alignment buckets by length, rows in order of arrival)."""
        videos = ([(v, self.sources[i]) for i, v in enumerate(self.src_vids)]
                  + [(v, self.cat_rows[i]) for i, v in enumerate(self.cat_vids)])
        videos.sort(key=lambda vf: _bucket(len(vf[1])))
        return search.Catalog(videos, self.device)

    def expected(self, catalog: search.Catalog, q: dict, threshold: int
                 ) -> List[Tuple[int, int, int]]:
        j = self.src_names.index(q["filename"])
        s, n = q["start_frame"], q["num_frames"]
        return catalog.align(self.sources[j, s:s + n], threshold,
                             self.traffic["top_k"], self.src_vids[j])

    def checked_requests(self) -> List[dict]:
        """The requests the comparison reads: ``check_requests`` drawn from
        the seed among those completed, and the one with the longest span."""
        rng = data.np_rng(self.seed, "check")
        ok = [d for d in self.done if d["code"] == 200]
        if not ok:
            return []
        pick = set(rng.choice(len(ok), size=min(len(ok), self.traffic["check_requests"]),
                              replace=False).tolist())
        pick.add(max(range(len(ok)), key=lambda i: max(
            q["num_frames"] for q in ok[i]["body"]["queries"])))
        return [ok[i] for i in sorted(pick)]

    def verify(self, limits: dict) -> Dict[str, Tuple[float, float]]:
        thr = self.cfg.match.hamming_threshold
        names = dict(zip(self.src_vids, self.src_names))
        names.update(zip(self.cat_vids, self.cat_names))
        spans_wrong = names_wrong = 0
        catalog = self.reference_catalog()
        for d in self.checked_requests():
            for q, res in zip(d["body"]["queries"], d["out"]["results"]):
                want = self.expected(catalog, q, thr)
                got = [(x["video_id"], x["offset_frames"], x["match_count"])
                       for x in res["matches"]]
                spans_wrong += int(got != want)
                names_wrong += int([x["filename"] for x in res["matches"]]
                                   != [names.get(v) for v, _, _ in got])
        values = {"spans_wrong": spans_wrong, "names_wrong": names_wrong}
        return {k: (v, limits[k]) for k, v in values.items()}



KIND = SearchClosedLoop
