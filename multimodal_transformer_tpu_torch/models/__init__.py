from .config import (FAMILIES, MFT_EMBED_DIM, ModelConfig, default_config,
                     modalities_from_comb)
from .families import MFT, build_model

__all__ = ["FAMILIES", "MFT", "MFT_EMBED_DIM", "ModelConfig", "build_model",
           "default_config", "modalities_from_comb"]
