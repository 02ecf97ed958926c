"""Multi-rank parallelism on ``torch.distributed``: sequence-parallel
LiteAttention (KV split), ring and Ulysses attention, tensor-parallel
layers and the GPipe pipeline.

Counterpart of ``liteattention_tpu/parallel``. Where JAX names a mesh
axis the port takes a ``DeviceMesh`` and a dim name; where JAX names an
axis inside ``shard_map``, a ``ProcessGroup``.
"""

from liteattention_torch.parallel.pipeline import pipeline_apply, pipeline_apply_local
from liteattention_torch.parallel.ring_attention import (
    ring_attention_local,
    ring_self_attention,
    ulysses_attention_local,
    ulysses_self_attention,
)
from liteattention_torch.parallel.seq_parallel import (
    make_seq_parallel_attention,
    seq_parallel_attention_step,
    seq_parallel_spec,
)

__all__ = [
    "make_seq_parallel_attention",
    "pipeline_apply",
    "pipeline_apply_local",
    "seq_parallel_attention_step",
    "seq_parallel_spec",
    "ring_attention_local",
    "ring_self_attention",
    "ulysses_attention_local",
    "ulysses_self_attention",
]
