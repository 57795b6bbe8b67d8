"""Training through the port: data, AdamW, checkpoints, the fault-tolerant
loop, the LM trainer (``loop``) and the CapsuleNet trainer
(``capsnet_loop``)."""
