from .optimizers import (Adafactor, AdamW, clip_by_global_norm, get_optimizer,
                         global_norm, warmup_cosine)
