"""Traffic mixes (``<mix>.json``) and the generators their ``kind`` names."""
