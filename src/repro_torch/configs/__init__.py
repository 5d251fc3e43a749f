"""Architecture configs of the LM serving and training paths: the
counterpart of ``repro/configs``, for the architectures the port runs so
far."""
from repro_torch.configs.base import (ModelConfig, SHAPES, ShapeSpec,  # noqa
                                      get_config, list_archs, ARCH_REGISTRY)
