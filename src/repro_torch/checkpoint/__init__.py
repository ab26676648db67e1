from repro_torch.checkpoint.sharded import (CheckpointManager,  # noqa: F401
                                            load_checkpoint, save_checkpoint)
