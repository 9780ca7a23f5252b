"""The in-process state plane, on the port's filename rules.

``tvidz_tpu/pipeline/progress.py``'s ``AnalysisRegistry`` is reused as it
is, except ``lookup``: the reference's imports ``tvidz_tpu.pipeline.analyzer``
(``progress.py:93``), which imports jax. This one resolves the clean name
with the port's ``extract_filenames`` and keeps the reference's three-pass
resolution order.
"""

from __future__ import annotations

from typing import Optional

from tvidz_tpu_torch._reference import AnalysisRegistry as _ReferenceRegistry
from tvidz_tpu_torch.pipeline.analyzer import extract_filenames


class AnalysisRegistry(_ReferenceRegistry):
    """Thread-safe registry of per-analysis state dicts (the reference's)."""

    def lookup(self, filename: str) -> Optional[dict]:
        """Exact key, then a live entry's original_filename, then a restored
        (post-restart) entry's clean name — live entries before restored
        ones, as in the reference (``progress.py:79-109``)."""
        _, clean = extract_filenames(filename)
        with self._lock:
            if filename in self._results:
                return dict(self._results[filename])
            for key, data in self._results.items():
                if (not str(key).startswith("restored_")
                        and isinstance(data, dict)
                        and data.get("original_filename") == filename):
                    return dict(data)
            for key, data in self._results.items():
                if (str(key).startswith("restored_")
                        and isinstance(data, dict)
                        and data.get("clean_filename") == clean):
                    return dict(data)
        return None
