"""Serving entry point (``python -m repro_torch.launch.serve``), the page
allocator and the request lifecycle."""
