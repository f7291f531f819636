"""Entry points: ``serve`` (continuous-batching engine), ``serve_cluster``
(the autoscaled cluster demo) and ``calibrate`` (kernel calibration)."""
