"""End-to-end encrypted models (counterpart of ``hetpu/models``)."""
