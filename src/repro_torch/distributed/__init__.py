"""The reference's ``distributed`` package, in the port: the serving
mesh's sharding rules (``sharding``) and collectives (``collectives``),
and the fault-tolerance runtime of the trainer and the serve engine
(``fault_tolerance``).  Training's sharding and compressed gradient sums
are ROADMAP Queue 1 item 11b; the heartbeat monitor, the straggler
detector and the in-graph controller are item 11d."""
