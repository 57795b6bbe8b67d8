"""Model configurations of the port: the CapsuleNet archs and the LM
archs ported so far (``registry``)."""
