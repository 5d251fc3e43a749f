from repro_torch.optim.adamw import (adamw, AdamWState,  # noqa: F401
                                     clip_by_global_norm, cosine_schedule)
from repro_torch.optim.compression import (compress_int8,  # noqa: F401
                                           decompress_int8, int8_roundtrip,
                                           topk_error_feedback)
