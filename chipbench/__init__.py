"""The serving benchmark of ``repro_torch`` on one H100.

A cell of ``BENCHMARK.json`` is one model configuration (``configs/``)
under one traffic mix (``traffic/``), with its output limits in
``cells/``; a configuration's model kind (its weights, plain reference and
FLOP counts) is one file in ``kinds/``; a per-layer metric is one reader
in ``metrics/``.  The harness finds each by the name the manifest or the
configuration gives it, so a new cell, mix, kind or metric is new files
and new manifest entries.  ``run.py`` runs one cell once.
"""
