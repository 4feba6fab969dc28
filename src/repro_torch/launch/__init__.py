"""Serving entry point (``python -m repro_torch.launch.serve``), the page
allocator, the prefix index and the request lifecycle."""
