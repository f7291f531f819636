"""Distribution layer: sharding rules over a ``DeviceMesh``, expert-parallel
MoE, GPipe and the analytic collective model.  Counterpart of
``repro/distribution`` (less ``hlo_analysis``, which reads XLA HLO)."""
