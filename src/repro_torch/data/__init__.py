from repro_torch.data.pipeline import (SyntheticTokens,  # noqa: F401
                                       make_batch_iterator)
