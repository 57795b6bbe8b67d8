"""Model configurations of the port: the CapsuleNet archs and the dense
LM archs ported so far (``registry``)."""
