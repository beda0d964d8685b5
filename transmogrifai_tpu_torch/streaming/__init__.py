"""Out-of-core streaming training (counterpart of
``transmogrifai_tpu.streaming``).

Datasets larger than the card's (and the host's) memory train as chunked
monoid folds: a :class:`ChunkSource` yields fixed-row-budget host chunks,
the :class:`DeviceFeed` prepares them behind the consumer (a
``TG_STREAM_WORKERS`` pool reads, one ordered committer uploads each chunk
from pinned memory on a CUDA stream of its own and runs the fitted
upstream transforms on the card), a bounded :class:`ChunkCache` (host LRU
and a sha256-verified disk tier) replays transformed chunks on repeat
passes, the estimators fit as accumulate / merge / finalize folds in
float64 on the host (:mod:`.folds`), and per-chunk checkpoints through the
manifest make a kill at any ``stream.*`` site resume bit-exactly. Entry
point: ``OpWorkflow.train(stream=source)``.
"""
from .cache import (  # noqa: F401
    ChunkCache, PackedChunk, chunk_cache_key, pack_table,
    transform_identity,
)
from .checkpoint import StreamCheckpoint  # noqa: F401
from .feed import (  # noqa: F401
    DeviceFeed, FeedStats, device_bytes, env_workers, live_feeds,
)
from .folds import (  # noqa: F401
    ArraySumFold, ColStatsFold, CompositeFold, ContingencyFold,
    CorrelationFold, HistogramFold, MonoidFold,
)
from .model import StreamingGBT, StreamingGBTModel  # noqa: F401
from .source import (  # noqa: F401
    AvroChunkSource, Chunk, ChunkSource, SyntheticChunkSource,
    TableChunkSource, env_chunk_rows,
)
from .trainer import (  # noqa: F401
    StreamingNotSupportedError, StreamRun, fit_dag_streaming,
)
