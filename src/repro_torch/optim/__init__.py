"""Optimizer and gradient accumulation for the trainer."""
