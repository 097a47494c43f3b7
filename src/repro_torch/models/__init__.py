"""Model configs, layers, the paged KV cache, GQA attention and the dense
decoder (counterpart of ``src/repro/models/``)."""
