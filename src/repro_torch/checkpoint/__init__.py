from .ckpt import (CheckpointManager, latest_step, load_checkpoint, restore,
                   save_checkpoint)
