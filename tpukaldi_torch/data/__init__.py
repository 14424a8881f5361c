from .chunk_loader import (  # noqa: F401
    ChunkData,
    load_chunk,
    load_chunk_stream,
    load_dataset_stream,
)
from .batching import (  # noqa: F401
    FrameBatch,
    SeqBatch,
    bucket_for,
    iter_forward_batches,
    iter_forward_utterances,
    iter_frame_batches,
    iter_seq_batches,
    n_frame_batches,
    n_seq_batches,
)
from .labels import dump_label_stream, read_label_stream  # noqa: F401
from .prefetch import ChunkPrefetcher  # noqa: F401
