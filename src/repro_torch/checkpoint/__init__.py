"""Checkpointing of the port (the counterpart of ``repro.checkpoint``)."""
