"""Model configurations of the port (the CapsuleNet ones ported so far)."""
