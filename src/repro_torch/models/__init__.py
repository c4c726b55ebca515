"""Dense decoder model: blocks, attention, FFN, linears and the facade."""
from repro_torch.models.model import Model, init_params  # noqa: F401
