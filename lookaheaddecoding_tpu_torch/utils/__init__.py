from .logging import DecodeLog

__all__ = ["DecodeLog"]
