from .init import glorot, zeros_init

__all__ = ["glorot", "zeros_init"]
