"""Step functions of the LM (``steps``): the counterpart of
``repro/launch/steps.py``.  The rest of the reference's ``launch/``
(mesh, shapes, roofline, dry run) waits for ROADMAP queue 1, item 11g."""
