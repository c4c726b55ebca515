"""Synthetic prompt and training data (numpy)."""
from repro_torch.data.synthetic import (  # noqa: F401
    ambiguous_prompts,
    lm_batches,
    synthetic_corpus,
    task_prompts,
)
