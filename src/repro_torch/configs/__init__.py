"""Architecture configs of the LM serving path: the counterpart of
``repro/configs``, for the architectures the port runs so far."""
from repro_torch.configs.base import (ModelConfig, get_config, list_archs,
                                      ARCH_REGISTRY)
