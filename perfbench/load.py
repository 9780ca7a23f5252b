"""The general load generator: what every traffic kind shares.

A traffic file (``perfbench/traffic/<traffic>.json``) names its ``kind``;
the kind is the module ``perfbench/kinds/<kind>.py``, found by that name
(``load_kind``), whose ``KIND`` class turns the file's parameters into
requests, offers them, installs the seams its spans need, and holds the
answers against the plain reference. A new kind is a new module there.

A kind's class derives from ``Kind`` below and gives:

- ``setup()``: the deployment, its catalog and the warm-up of the cell's
  own shapes, calling ``install()`` once the service is booted;
  ``instrument()``: its seams into the program (``probes.wrap``);
- ``window_start()``, ``run_window(t0)``, ``drain(limit_s)``: the window,
  filling ``samples`` (``{name: [ms]}``, a failed request ``inf``),
  ``attempted``, ``failed``, ``t0`` and ``drain_end``;
- ``verify(limits)``: each number compared, beside its limit;
- ``control_hooks()``: the run hooks that put the cell's control in the
  program's place (``perfbench/control.py``).
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench import data
from perfbench.deploy import Deployment, make_config
from perfbench.probes import Recorder


def log_uniform_sizes(n: int, lo: int, hi: int) -> List[int]:
    """The n quantiles (i + 1/2) / n of a log-uniform law on [lo, hi]."""
    return [int(round(lo * (hi / lo) ** ((i + 0.5) / n))) for i in range(n)]


def poisson_arrivals(rate: float, seconds: float, seed: int) -> List[float]:
    """A Poisson process on [0, seconds) given its count: round(rate ·
    seconds) arrival times, uniform and sorted, so the window offers
    exactly its rate."""
    rng = np.random.default_rng(seed)
    return sorted(rng.uniform(0.0, seconds, int(round(rate * seconds))).tolist())


def load_kind(root: str, name: str) -> type:
    """The ``KIND`` class of ``perfbench/kinds/<name>.py``."""
    path = os.path.join(root, "perfbench", "kinds", f"{name}.py")
    if not os.path.isfile(path):
        raise KeyError(f"no traffic kind {name!r} (looked for {path})")
    spec = importlib.util.spec_from_file_location(f"perfbench_kind_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.KIND


class Kind:
    """The deployment, its catalog, and the counters read around the
    window."""

    def __init__(self, config: dict, traffic: dict, seed: int, seconds: int,
                 device: str, recorder: Recorder, work_dir: str):
        self.config, self.traffic = config, traffic
        self.seed, self.seconds, self.device = seed, seconds, device
        self.rec = recorder
        self.cfg = make_config(config["settings"], work_dir)
        self.dep = Deployment(self.cfg, device, work_dir)
        self.words = self.cfg.hash.words
        self.samples: Dict[str, List[float]] = {}
        self.attempted = self.failed = 0
        self.notes: Dict[str, float] = {}
        self.hooks: list = []

    @contextlib.contextmanager
    def phase(self, name: str):
        """Time one step of set-up into the notes line."""
        t = time.perf_counter()
        yield
        self.notes[f"setup_{name}_s"] = time.perf_counter() - t

    def window_start(self) -> float:
        return time.perf_counter()

    def host_state(self, t: float) -> Optional[str]:
        return None

    def make_catalog(self) -> None:
        c = self.config["catalog"]
        self.cat_rows, starts = data.catalog(
            self.seed, self.device, c["videos"], c["frames_per_video"],
            self.words, c["shot_frames"], c["flip_log2"])
        self.cat_ts = data.shot_timestamps(starts, c["fps_num"], c["fps_den"])
        self.cat_names = [f"catalog-{i:05d}.mp4" for i in range(c["videos"])]

    def instrument(self) -> None:
        """Install the kind's seams; a kind that needs none has none."""

    def install(self) -> None:
        """The kind's seams, then the run's hooks (a control or a planted
        fault in the program's place), once the service is booted and
        before it serves anything."""
        self.instrument()
        for hook in self.hooks:
            hook(self)

    def begin_window(self) -> None:
        """Forget what set-up recorded."""
        self.rec.clear()

    def counters(self) -> dict:
        app = self.dep.app
        d = app.block_dispatcher
        return {"stages": app.analyzer.timer.summary(),
                "passes": d.passes if d else 0, "blocks": d.blocks if d else 0}

    def control_hooks(self) -> list:
        raise NotImplementedError(f"{type(self).__name__} states no control")

    def free_program(self) -> None:
        """Stop the service and let its device memory go."""
        self.dep.stop()
        self.dep.app = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
