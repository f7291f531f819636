"""Distribution layer: sharding rules over a ``DeviceMesh``, expert-parallel
MoE, GPipe, the analytic collective model and the static cost analysis.
Counterpart of ``repro/distribution``; ``cost_analysis`` is the counterpart
of ``hlo_analysis`` (which reads XLA HLO: the port counts aten ops on
``meta`` tensors instead), and ``_shardmap`` has none (a JAX-version shim:
the port's per-rank regions are ``local_map``)."""
