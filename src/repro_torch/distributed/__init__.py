"""The reference's ``distributed`` package, in the port: the logical-axis
sharding rules and placements (``sharding``), the collectives of serving
and data-parallel training, the compressed gradient mean among them
(``collectives``), and the fault-tolerance runtime (``fault_tolerance``:
heartbeats, stragglers, preemption)."""
