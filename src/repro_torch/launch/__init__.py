"""Step functions of the LM (``steps``), the production meshes
(``mesh``), the cells' shapes on the meta device (``shapes``), the H100
roofline (``roofline``), the op counters (``hlo_analysis``) and the
production dry run (``dryrun``): the counterparts of
``repro/launch/``."""
