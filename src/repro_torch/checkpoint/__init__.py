from repro_torch.checkpoint.store import (latest_step,  # noqa: F401
                                          restore_checkpoint,
                                          save_checkpoint)
