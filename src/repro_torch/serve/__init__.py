"""Serving of the port: the slot-batched CapsuleNet engine (``capsule``)
and the slot-batched LM engine (``engine``)."""
