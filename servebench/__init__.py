"""The benchmark of the port's paged serving engine (``repro_torch``).

``run.py`` runs one cell once; ``BENCHMARK.json`` at the repository's
root names the cells.  A configuration is ``configs/<name>.json``, a
traffic mix ``traffic/<name>.json`` (read by the one generator,
``traffic.py``), a cell's comparison limits ``checks/<cell>.json`` and a
metric ``metrics/<name>.py``; the harness finds each by its name.  The
yardstick lives here too: the window's arithmetic (``window.py``), the
peaks and the operation and byte counts (``roofline.py``,
``kernel_share.py``), the plain reference (``reference.py``) and the
comparison that decides ``correct`` (``judge.py``).  Only
``program.py`` imports the program.
"""
