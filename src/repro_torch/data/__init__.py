from .pipeline import (SyntheticLMData, TokenFileData, make_global_batch,
                       to_device)
