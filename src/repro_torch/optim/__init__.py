from repro_torch.optim.adamw import (adamw, AdamWState,  # noqa: F401
                                     clip_by_global_norm, cosine_schedule)
