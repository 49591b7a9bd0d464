"""Logging, timers, profiler traces and checkpoints."""
