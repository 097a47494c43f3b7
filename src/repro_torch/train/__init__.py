"""Training: the causal-LM loss and train step, AdamW, checkpoints."""
