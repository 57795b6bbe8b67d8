"""Step functions of the LM (``steps``), the production meshes
(``mesh``) and the cells' shapes on the meta device (``shapes``): the
counterparts of ``repro/launch/``.  The reference's roofline, HLO
analysis and dry run wait for ROADMAP queue 1, item 11g."""
