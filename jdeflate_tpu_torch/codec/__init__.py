from .deflate import RawDeflater
from .inflate import RawInflater

__all__ = ["RawDeflater", "RawInflater"]
