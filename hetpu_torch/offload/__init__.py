"""Encrypted-compute offload.  Counterpart of ``hetpu/offload``; only the
inference layer of :mod:`.pipeline` is ported so far (no transport)."""
