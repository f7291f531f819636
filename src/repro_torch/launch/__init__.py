"""Entry points: ``serve`` (continuous-batching engine), ``serve_cluster``
(the autoscaled cluster demo), ``calibrate`` (kernel calibration), ``train``
and its small twin ``train_small`` (training with checkpoint/restart), and
the placement-only ``quickstart`` and ``compaction_demo``."""
