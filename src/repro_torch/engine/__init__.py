"""Serving engine: block pool, prefix index, request state, sampling and
the paged continuous-batching :class:`~repro_torch.engine.engine.Engine`."""
