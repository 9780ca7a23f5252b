"""Tiny sizes for the upload cell under the 256-bit hash, so that
``perfbench/tests/tiny.py``'s ``tiny_root`` cuts its configuration and
writes its traffic as it does the first upload cell's."""

from perfbench.tests import tiny

tiny.TINY_CATALOG.setdefault("phash256-16m-upload",
                             tiny.TINY_CATALOG["phash64-16m"])
tiny.TINY_TRAFFIC.setdefault("uploads-poisson-phash256",
                             tiny.TINY_TRAFFIC["uploads-poisson"])
