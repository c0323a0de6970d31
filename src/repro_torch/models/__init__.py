"""Models of the port: the denoisers, the language models and their shared
layers."""
from repro_torch.models.api import build_model  # noqa: F401
