"""Host-streamed chunk sources and their loader, the sharded batch loader,
synthetic datasets and the LM token stream."""
from .pipeline import ShardedLoader
from .streaming import (
    ArrayChunkSource,
    ChunkSource,
    ShardedChunkSource,
    ShuffledChunkSource,
    StreamingLoader,
    default_prefetch,
    shard_chunk_sources,
    streaming_apply,
    streaming_sweep,
    streaming_uniform_centers,
)
from .synthetic import (PAPER_TASKS, KernelTask, TokenStreamConfig, make_kernel_dataset,
                        token_stream)

__all__ = [
    "ArrayChunkSource", "ChunkSource", "KernelTask", "PAPER_TASKS", "ShardedChunkSource",
    "ShardedLoader", "ShuffledChunkSource", "StreamingLoader", "TokenStreamConfig",
    "default_prefetch", "make_kernel_dataset", "shard_chunk_sources", "streaming_apply",
    "streaming_sweep", "streaming_uniform_centers", "token_stream",
]
