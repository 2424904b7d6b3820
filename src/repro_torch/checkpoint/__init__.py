from .ckpt import (CheckpointManager, latest_step, load_checkpoint, restore,
                   restore_sharded, save_checkpoint)
