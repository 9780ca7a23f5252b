"""The corpus sharded over a device mesh, and across processes (port of
``tvidz_tpu/parallel``)."""

from tvidz_tpu_torch.parallel.collective import (
    CollectiveRunner,
    MultiHostCorpusClient,
)
from tvidz_tpu_torch.parallel.distributed import (
    MultiHostShardedCorpus,
    init_distributed,
    make_multihost_mesh,
)
from tvidz_tpu_torch.parallel.mesh import make_mesh, mesh_shape_for
from tvidz_tpu_torch.parallel.mesh_corpus import MeshCorpus
from tvidz_tpu_torch.parallel.sharded_search import (
    ShardedCorpus,
    sharded_frame_min,
    sharded_hamming_topk,
    sharded_nearest,
    sharded_timestamp_match,
)
from tvidz_tpu_torch.parallel.step import multichip_analysis_step

__all__ = [
    "make_mesh",
    "mesh_shape_for",
    "MeshCorpus",
    "ShardedCorpus",
    "sharded_frame_min",
    "sharded_hamming_topk",
    "sharded_nearest",
    "sharded_timestamp_match",
    "multichip_analysis_step",
    "init_distributed",
    "make_multihost_mesh",
    "MultiHostShardedCorpus",
    "CollectiveRunner",
    "MultiHostCorpusClient",
]
