"""Data pipelines of the port (numpy only, as the reference's)."""
from .tokens import SyntheticTokenStream, HostShardedStream
from .stream import VideoChunkStream
