from repro_torch.models.model import Model, build, resolve_device
from repro_torch.models.transformer import Runtime

__all__ = ["Model", "Runtime", "build", "resolve_device"]
