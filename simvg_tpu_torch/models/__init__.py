from .builder import build_model, init_random_weights
from .model import SimVGConfig, SimVGModel, decode_predictions

__all__ = ["SimVGConfig", "SimVGModel", "build_model", "decode_predictions",
           "init_random_weights"]
