"""Training through the port: data, AdamW, checkpoints, the fault-tolerant
loop and the CapsuleNet trainer (``capsnet_loop``)."""
