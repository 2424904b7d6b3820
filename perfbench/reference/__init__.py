"""Plain float32 PyTorch references, one file per model family. They
import nothing of the program (``repro_torch``) and nothing of JAX."""
