"""Synthetic prompt data (numpy)."""
from repro_torch.data.synthetic import task_prompts  # noqa: F401
