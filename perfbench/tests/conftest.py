"""Tiny catalog sizes for configurations added after ``tiny.TINY_CATALOG``
was written, so that ``tiny_root`` can cut every configuration the
benchmark lists."""

from perfbench.tests import tiny

tiny.TINY_CATALOG.setdefault("phash64-16m-search",
                             tiny.TINY_CATALOG["phash64-16m"])
