"""Core SLSH algorithms of the port: hashing, tables, merge, top-k, pipeline."""
