"""Configs, drafting, verification and the speculative decode step."""
