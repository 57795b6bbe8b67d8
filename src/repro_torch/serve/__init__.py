"""Serving of the port: the slot-batched CapsuleNet engine."""
