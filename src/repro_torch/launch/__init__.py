"""Entry points: ``serve`` (continuous-batching engine), ``serve_cluster``
(the autoscaled cluster demo), ``calibrate`` (kernel calibration), and the
placement-only ``quickstart`` and ``compaction_demo``."""
