"""jdeflate-tpu-torch: the DEFLATE (RFC 1951/1950/1952) decoder of
jdeflate_tpu ported to PyTorch, with hand-written CUDA kernels for Hopper.

Decode path: an index of block offsets and 32-bit window anchors (from the
encoder, from a FEXTRA header, or from RawInflater.build_index) lets every
batch of Huffman blocks decode on the GPU in two kernels, the window walk
(csrc/walk.cu) and the token expansion (csrc/expand.cu). Entry points take
``device`` (default "cuda"); ``device="cpu"`` runs the plain PyTorch
versions. The package imports neither jax nor jdeflate_tpu.

Quick API:
    import jdeflate_tpu_torch as jdt
    data = jdt.decompress(blob, index=idx)
"""
from .codec.inflate import RawInflater
from .ops.checksum import adler32, adler32_combine, crc32, crc32_combine
from .stream.zstrm import decompress
from .utils import errors

__version__ = "0.1.0"

__all__ = [
    "decompress", "RawInflater",
    "adler32", "adler32_combine", "crc32", "crc32_combine",
    "errors", "__version__",
]
