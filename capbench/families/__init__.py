"""Families of configurations: what sets a cell of one kind of model up
before its traffic driver is made.

A configuration file names its family (``"family"``; ``capsnet`` where
it names none), and ``spec.family`` imports ``families/<family>.py``,
which gives:

- ``LIBRARIES``: the program's CUDA libraries that the family's path
  loads, built on the card before anything else;
- ``weights(cfg, seed, device)``: the weights, drawn on the device from
  the seed;
- ``pool(cfg, params, seed, device)``: what the traffic draws from, a
  dict of tensors (``params``: the cell's parameters);
- ``program_config(cfg)``: the configuration in the program's own type.

The CPU tests' sizes are the file's own ``"smoke"`` keys
(``inputs.smoke``), whatever the family.
"""
