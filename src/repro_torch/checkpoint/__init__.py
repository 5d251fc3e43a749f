from repro_torch.checkpoint.store import (AsyncCheckpointer,  # noqa: F401
                                          checkpoint_bytes, latest_step,
                                          restore_checkpoint,
                                          save_checkpoint)
