"""Fault-tolerance runtime of the trainer (the rest of the reference's
``distributed`` package is ROADMAP Queue 1 item 11)."""
