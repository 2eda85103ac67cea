"""Streaming ingest — port of ``h2o_tpu/stream`` (its ``ingest.py``):
:class:`ChunkReader` reads a file, URI, binary stream or iterator of
blocks in bounded chunks of complete CSV records, and
``frame_from_chunk`` + ``Frame.append_rows`` grow a frame from them.
(The reference's model refresh, ``stream/refresh.py``, is not ported.)
"""

from h2o_tpu_torch.stream.ingest import (ChunkReader, frame_from_chunk,
                                         last_record_end)

__all__ = ["ChunkReader", "frame_from_chunk", "last_record_end"]
