"""Host runtime of the port (counterpart of ``hetpu/runtime``)."""
