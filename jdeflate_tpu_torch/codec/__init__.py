from .inflate import RawInflater

__all__ = ["RawInflater"]
