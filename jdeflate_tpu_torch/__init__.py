"""jdeflate-tpu-torch: the DEFLATE (RFC 1951/1950/1952) codec of
jdeflate_tpu ported to PyTorch, with hand-written CUDA kernels for Hopper.

Encode path: RawDeflater encodes batches of fixed-size blocks on the GPU
(hash-sorted match finding, the sequential parse as the match-walk kernel
csrc/lz77walk.cu, Huffman trees, bit packing) and returns the stream with
its parallel-decode index; the same bytes and index as the JAX package.

Decode path: an index of block offsets and 32-bit window anchors (from the
encoder, from a FEXTRA header, or from RawInflater.build_index) lets every
batch of Huffman blocks decode on the GPU in two kernels, the window walk
(csrc/walk.cu) and the token expansion (csrc/expand.cu, or with
JDT_EXPAND=5 the v5 engine's csrc/expand5seed.cu and csrc/expand5resolve.cu).
An index with symbol anchors decodes by exact anchored walks and the v1
match expansion (csrc/expand1.cu); one with block offsets only, by a
speculative decode at every bit position. ZStream streams either way
(segments through RawDeflater; blocks through the native partial inflator
on the host), with its checksums on the device; parallel.shard's
ShardedDeflater encodes shards on a mesh of devices, as gzip members or one
stream, and decompress_members decodes members on the windowed path. Entry
points take ``device`` (default "cuda"); ``device="cpu"`` runs the plain
PyTorch versions. The package imports neither jax nor jdeflate_tpu.

Quick API:
    import jdeflate_tpu_torch as jdt
    blob, idx, hl = jdt.compress_with_index(data, format="gzip")
    data = jdt.decompress(blob, index=idx, header_len=hl)
"""
from .codec.deflate import RawDeflater
from .codec.inflate import RawInflater
from .ops.checksum import adler32, adler32_combine, crc32, crc32_combine
from .stream.zstrm import ZStream, compress, compress_with_index, decompress
from .utils import errors

__version__ = "0.1.0"

__all__ = [
    "ZStream", "compress", "compress_with_index", "decompress",
    "RawDeflater", "RawInflater",
    "adler32", "adler32_combine", "crc32", "crc32_combine",
    "errors", "__version__", "get_version",
]


def get_version() -> str:
    """Version string (the reference's jdeflate_getversion)."""
    return __version__
