from transfusion_torch.config.loader import Config, load_config
from transfusion_torch.config.derive import (
    LANG_MODEL_FEATURE_SIZES,
    LM_TO_TEXT_POOLING,
    derive_config,
)

__all__ = [
    "Config",
    "load_config",
    "derive_config",
    "LANG_MODEL_FEATURE_SIZES",
    "LM_TO_TEXT_POOLING",
]
