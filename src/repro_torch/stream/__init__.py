"""Streaming DSLSH: online ingestion, delta-segment indices, compaction,
and the live ICU monitor (DESIGN.md §9); the port's counterpart
of ``repro.stream``."""
from repro_torch.stream.delta import DeltaIndex, as_view, make_delta  # noqa: F401
from repro_torch.stream.index import (  # noqa: F401
    StreamIndex,
    compact,
    evict_before,
    from_base,
    insert_batch,
    query_batch,
    stream_init,
)
from repro_torch.stream.monitor import (  # noqa: F401
    CellState,
    NodeState,
    StreamEvent,
    StreamingMonitor,
    node_init,
)
from repro_torch.stream.shard import IngestReport, ShardedStream  # noqa: F401
