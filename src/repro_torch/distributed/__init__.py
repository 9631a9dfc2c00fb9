"""Fault-tolerance runtime of the trainer and the serve engine (the rest
of the reference's ``distributed`` package is ROADMAP Queue 1 item 11)."""
