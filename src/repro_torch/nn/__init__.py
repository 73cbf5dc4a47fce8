from .init import glorot, he, normal_init, zeros_init
from .layers import dense, layer_norm, rms_norm, dropout

__all__ = ["glorot", "he", "normal_init", "zeros_init", "dense",
           "layer_norm", "rms_norm", "dropout"]
