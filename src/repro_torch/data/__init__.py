from .pipeline import SyntheticLMData, TokenFileData, to_device
